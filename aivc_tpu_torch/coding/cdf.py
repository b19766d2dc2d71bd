"""Deterministic integer CDF tables (counterpart of aivc_tpu/coding/cdf.py).

* z (hyper-latent): one row per channel from the learned factorized prior,
  evaluated once per model load at the symbol edges (``build_z_table``).
* y (main latent): NBINS log-spaced Laplace scale bins
  (``build_laplace_table``), or for ELIC's Gaussian the same bins
  (``build_gaussian_table``), addressed per element by ``sigma_to_bin``.

The quantization is plain integer numpy, a copy of the JAX package's, so
the integer rows match it byte for byte given the same float edge CDFs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from aivc_tpu_torch.config import AC_MAX_VAL

PROB_SCALE = 1 << 16
NBINS = 64
SIGMA_MIN = 0.05
SIGMA_MAX = 160.0
_LOG_SMIN = float(np.log(SIGMA_MIN))
_LOG_SMAX = float(np.log(SIGMA_MAX))


def symbol_edges(ac_max: int = AC_MAX_VAL) -> np.ndarray:
    """Half-integer bin edges [-ac_max-0.5, ..., ac_max-0.5]."""
    return np.arange(2 * ac_max + 1, dtype=np.float64) - ac_max - 0.5


def quantize_pmf(pmf: np.ndarray, scale: int = PROB_SCALE) -> np.ndarray:
    """pmf rows [n_rows, n_sym] -> integer CDFs [n_rows, n_sym + 1] summing
    exactly to ``scale``, every frequency >= 1, the remainder on each row's
    most probable symbol (lowest index on ties)."""
    pmf = np.asarray(pmf, dtype=np.float64)
    if pmf.ndim != 2:
        raise ValueError("pmf must be [n_rows, n_symbols]")
    n_sym = pmf.shape[1]
    pmf = np.maximum(pmf, 0.0)
    total = pmf.sum(axis=1, keepdims=True)
    total[total == 0] = 1.0
    pmf = pmf / total
    budget = scale - n_sym
    if budget <= 0:
        raise ValueError(f"scale {scale} too small for {n_sym} symbols")
    freq = np.floor(pmf * budget).astype(np.int64) + 1
    short = scale - freq.sum(axis=1)
    rows = np.arange(pmf.shape[0])
    freq[rows, pmf.argmax(axis=1)] += short
    cdf = np.zeros((pmf.shape[0], n_sym + 1), dtype=np.uint32)
    cdf[:, 1:] = np.cumsum(freq, axis=1).astype(np.uint32)
    return cdf


def cdf_rows_from_edge_values(edge_cdf: np.ndarray,
                              scale: int = PROB_SCALE) -> np.ndarray:
    """Integer CDF rows from float CDF values at the symbol edges; tail
    mass folds into the edge symbols."""
    edge_cdf = np.asarray(edge_cdf, dtype=np.float64)
    if edge_cdf.ndim != 2 or edge_cdf.shape[1] % 2 != 1:
        raise ValueError("edge_cdf must be [n_rows, n_symbols + 1]")
    edge_cdf = edge_cdf.copy()
    edge_cdf[:, 0] = 0.0
    edge_cdf[:, -1] = 1.0
    return quantize_pmf(np.diff(edge_cdf, axis=1), scale)


def sigma_bin_centers() -> np.ndarray:
    return np.exp(np.linspace(_LOG_SMIN, _LOG_SMAX, NBINS))


def build_laplace_table(scale: int = PROB_SCALE,
                        ac_max: int = AC_MAX_VAL) -> np.ndarray:
    """[NBINS, 2*ac_max + 1] integer CDF rows of the zero-mean Laplace of
    each scale bin (b = sigma / sqrt(2))."""
    sigmas = sigma_bin_centers()
    edges = symbol_edges(ac_max)[None, :]
    b = (sigmas / np.sqrt(2.0))[:, None]
    half_tail = 0.5 * np.exp(-np.abs(edges) / b)
    cdf = np.where(edges < 0, half_tail, 1.0 - half_tail)
    return cdf_rows_from_edge_values(cdf, scale)


def build_gaussian_table(scale: int = PROB_SCALE,
                         ac_max: int = AC_MAX_VAL) -> np.ndarray:
    """[NBINS, 2*ac_max + 1] integer CDF rows of the zero-mean Gaussian of
    each scale bin (std sigma), tail mass folded into the edge symbols."""
    sigmas = sigma_bin_centers()[:, None]
    edges = symbol_edges(ac_max)[None, :]
    cdf = 0.5 * np.vectorize(math.erfc)(-edges / (sigmas * math.sqrt(2.0)))
    return cdf_rows_from_edge_values(cdf, scale)


@functools.lru_cache(maxsize=None)
def _bin_constants(device: torch.device):
    """sigma_to_bin's two float32 constants on ``device``, made once: a
    tensor made from a host value on the card waits for the card's queue
    to drain."""
    return (torch.tensor(np.float32(_LOG_SMIN), device=device),
            torch.tensor(np.float32((NBINS - 1) / (_LOG_SMAX - _LOG_SMIN)),
                         device=device))


def sigma_to_bin(sigma: torch.Tensor) -> torch.Tensor:
    """sigma -> scale-bin index (int32), float32 arithmetic as
    aivc_tpu/coding/cdf.py:sigma_to_bin_np (cdf.py:123-133)."""
    s = torch.clamp_min(sigma.float(), 1e-9)
    lo, sc = _bin_constants(sigma.device)
    t = (torch.log(s) - lo) * sc
    return torch.clamp(torch.round(t), 0, NBINS - 1).to(torch.int32)


def expected_bits(symbols: np.ndarray, row_idx: np.ndarray,
                  cdf_rows: np.ndarray) -> float:
    """Exact expected codelength of symbols under the quantized coded
    distribution — the analytic side of the estimated-vs-real rate
    cross-check (reference: src/real_life/bitstream.py:307-329)."""
    freq = np.diff(cdf_rows.astype(np.int64), axis=1)
    f = freq[row_idx.reshape(-1), symbols.reshape(-1).astype(np.int64)]
    return float(np.sum(-np.log2(f / float(PROB_SCALE))))


@torch.no_grad()
def build_z_table(prior, scale: int = PROB_SCALE,
                  ac_max: int = AC_MAX_VAL) -> np.ndarray:
    """[C, 2*ac_max + 1] integer CDF rows of a FactorizedPrior, evaluated
    in float32 at the symbol edges and quantized on the host."""
    C = prior.nb_channel
    dev = next(prior.parameters()).device
    edges = torch.tensor(np.tile(symbol_edges(ac_max)[None, :], (C, 1)),
                         dtype=torch.float32, device=dev)
    vals = prior.cdf(edges).cpu().numpy().astype(np.float64)
    return cdf_rows_from_edge_values(vals, scale)
