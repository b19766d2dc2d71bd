"""Multi-rate gain vectors with geometric interpolation
(counterpart of aivc_tpu/ops/gain.py)."""

from __future__ import annotations

import math

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
