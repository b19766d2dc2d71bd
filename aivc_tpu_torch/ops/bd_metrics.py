"""Bjontegaard-delta metrics: average RD-curve differences.

The reference's RD claims ("on par with HM", reference: README.md:26,
doc/rd_performance/) are curve comparisons; BD-rate / BD-PSNR are the
standard scalars for them (Bjontegaard, VCEG-M33): fit each curve with a
cubic polynomial of quality over log-rate (and vice versa), integrate
both over the overlapping interval, and report the average gap.

  bd_rate(ref, test) < 0  ->  test needs fewer bits at equal quality.
  bd_psnr(ref, test) > 0  ->  test has higher quality at equal rate.

Pure numpy, no plotting: the port's copy of aivc_tpu/ops/bd_metrics.py,
the same arithmetic line for line.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _prep(points: Sequence[Tuple[float, float]]):
    """(rate, quality) points -> (log_rate, quality), sorted by rate."""
    pts = sorted((float(r), float(q)) for r, q in points)
    rates = np.asarray([p[0] for p in pts], np.float64)
    quals = np.asarray([p[1] for p in pts], np.float64)
    if len(pts) < 4:
        raise ValueError("BD metrics need >= 4 RD points per curve")
    if rates.min() <= 0:
        raise ValueError("rates must be positive")
    return np.log10(rates), quals


def _poly_avg(x: np.ndarray, y: np.ndarray, lo: float, hi: float) -> float:
    """Average of the cubic fit y(x) over [lo, hi]."""
    coeffs = np.polyfit(x, y, 3)
    integ = np.polyint(coeffs)
    return float((np.polyval(integ, hi) - np.polyval(integ, lo)) / (hi - lo))


def bd_psnr(ref: Sequence[Tuple[float, float]],
            test: Sequence[Tuple[float, float]]) -> float:
    """Average quality delta (test - ref) over the shared rate interval.

    Points are (rate, quality); rate in any consistent unit (bpp, kbps),
    quality in dB (PSNR or MS-SSIM-dB).
    """
    xr, yr = _prep(ref)
    xt, yt = _prep(test)
    lo = max(xr.min(), xt.min())
    hi = min(xr.max(), xt.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in rate")
    return _poly_avg(xt, yt, lo, hi) - _poly_avg(xr, yr, lo, hi)


def bd_rate(ref: Sequence[Tuple[float, float]],
            test: Sequence[Tuple[float, float]]) -> float:
    """Average rate delta in PERCENT (test vs ref) at equal quality.

    Negative means the test codec spends fewer bits for the same quality.
    """
    xr, yr = _prep(ref)
    xt, yt = _prep(test)
    lo = max(yr.min(), yt.min())
    hi = min(yr.max(), yt.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in quality")
    # Fit log-rate as a function of quality.
    avg_ref = _poly_avg(yr, xr, lo, hi)
    avg_test = _poly_avg(yt, xt, lo, hi)
    return float((10.0 ** (avg_test - avg_ref) - 1.0) * 100.0)
