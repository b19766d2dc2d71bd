"""Generalized Divisive Normalization, eval path (NCHW).

y[i] = x[i] / sqrt(beta[i] + sum_j gamma[i, j] * x[j]^2)   (inverse: multiply)

The counterpart of aivc_tpu/ops/gdn.py:gdn_apply (gdn.py:57-97), with its
``clamp`` and its low-precision rule.  The channel mixing is a 1x1
convolution (cuDNN), accumulated in float32 whatever the activation type.
The JAX package's fused Pallas GDN (gdn.py:gdn_pallas) is not called by
its models and has no counterpart here yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6


def gdn_apply(x: torch.Tensor, beta_r: torch.Tensor, gamma_r: torch.Tensor,
              inverse: bool, clamp: float = 0.0,
              lowp: bool = False) -> torch.Tensor:
    """(I)GDN of NCHW ``x`` given reparameterised beta [C] / gamma [C, C].

    Type rules follow the JAX function: the parameters stay float32
    unless ``lowp`` and ``x`` is not float32, in which case they are cast
    to ``x``'s type; the normaliser is accumulated in float32, cast to
    ``x``'s type, and the sum with beta promotes as JAX does."""
    beta_bound = (BETA_MIN + PEDESTAL) ** 0.5
    beta = torch.clamp_min(beta_r, beta_bound) ** 2 - PEDESTAL
    gamma = torch.clamp_min(gamma_r, REPARAM_OFFSET) ** 2 - PEDESTAL
    x2 = torch.square(x)
    if lowp and x.dtype != torch.float32:
        gamma = gamma.to(x.dtype)
        beta = beta.to(x.dtype)
        # bf16 x bf16 products are exact in f32; the conv accumulates in
        # f32 and rounds once to x's type.
        norm = F.conv2d(x2, gamma[:, :, None, None])
    else:
        norm = F.conv2d(x2.float(), gamma.float()[:, :, None, None])
        norm = norm.to(x.dtype)
    norm = torch.sqrt(norm + beta.view(1, -1, 1, 1))
    if clamp > 0.0:
        norm = torch.clamp(norm, 1.0 / clamp, clamp)
    return x * norm if inverse else x / norm


class GDN(nn.Module):
    """Holds the reparameterised beta/gamma (checkpoint names kept)."""

    def __init__(self, ch: int, inverse: bool = False, clamp: float = 0.0,
                 lowp: bool = False):
        super().__init__()
        self.beta = nn.Parameter(torch.ones(ch))
        self.gamma = nn.Parameter(torch.eye(ch))
        self.inverse, self.clamp, self.lowp = inverse, clamp, lowp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gdn_apply(x, self.beta, self.gamma, self.inverse, self.clamp,
                         self.lowp)
