"""Multi-rate gain vectors with geometric interpolation, and the
low-rate gain surgery of the rate ladder (counterpart of
aivc_tpu/ops/gain.py)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def interpolate_gain(gains: torch.Tensor, idx_rate: float) -> torch.Tensor:
    """[N, C] gain matrix, idx_rate in [0, N-1] -> [C] gain vector
    g = |m_r|^l * |m_t|^(1-l), computed in float32 like the JAX op."""
    n = gains.shape[0]
    gains = torch.abs(gains)
    idx = min(max(float(idx_rate), 0.0), float(n - 1))
    prev_i = int(math.floor(idx))
    next_i = min(prev_i + 1, n - 1)
    f32 = torch.float32
    idx_t = torch.tensor(idx, dtype=f32, device=gains.device)
    l = 1.0 - (idx_t - torch.tensor(float(prev_i), dtype=f32,
                                    device=gains.device))
    return gains[prev_i] ** l * gains[next_i] ** (1.0 - l)


class GainMatrix(nn.Module):
    """N encoder + N decoder gain vectors of nb_ft channels."""

    def __init__(self, n_rates: int, nb_ft: int):
        super().__init__()
        self.enc_gain = nn.Parameter(torch.ones(n_rates, nb_ft))
        self.dec_gain = nn.Parameter(torch.ones(n_rates, nb_ft))

    def forward(self, x: torch.Tensor, idx_rate: float,
                mode: str) -> torch.Tensor:
        """Scale NCHW x by the interpolated gain vector of ``mode``."""
        gains = self.enc_gain if mode == "enc" else self.dec_gain
        g = interpolate_gain(gains, idx_rate).to(x.dtype)
        return x * g.view(1, -1, 1, 1)


def shift_gain_rows(mat, shift: int, ratio_cap: float = 4.0,
                    tail_boost: float = 1.0) -> np.ndarray:
    """[N, C] gain matrix -> down-rate-shifted ladder (low-rate surgery).

    Rows shift by ``shift`` so each surviving row keeps the weights
    trained for its lambda; the tail extrapolates geometrically in log
    space, with the per-step ratio raised to ``tail_boost`` and clamped
    to [1/ratio_cap, ratio_cap].  Pure numpy in float64, float32 out, as
    aivc_tpu/ops/gain.py:shift_gain_rows (host-side checkpoint surgery).
    """
    mat = np.abs(np.asarray(mat, np.float64)) + 1e-12
    n = mat.shape[0]
    out = np.empty_like(mat)
    out[: n - shift] = mat[shift:]
    step = np.clip((mat[-1] / mat[-2]) ** tail_boost,
                   1.0 / ratio_cap, ratio_cap)
    for k in range(n - shift, n):
        out[k] = out[k - 1] * step
    return out.astype(np.float32)


def shift_gain_tree(params, shift: int, ratio_cap: float = 4.0,
                    tail_boost: float = 1.0):
    """Apply shift_gain_rows to every enc_gain / dec_gain leaf of a nested
    dict of arrays (the checkpoint's tree, before ``params_from_jax``),
    in a copied tree; returns (new_params, n_shifted)."""
    n_gain = 0

    def walk(d):
        nonlocal n_gain
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("enc_gain", "dec_gain"):
                out[k] = shift_gain_rows(v, shift, ratio_cap, tail_boost)
                n_gain += 1
            else:
                out[k] = v
        return out

    return walk(params), n_gain
