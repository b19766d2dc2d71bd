"""Latent quantization, eval path (counterpart of
aivc_tpu/ops/quantizer.py:15-38): hard round to nearest, ties to even as
``jnp.round``, with a straight-through gradient; the training noise
waits for the training slice."""

from __future__ import annotations

import torch

from aivc_tpu_torch.config import AC_MAX_VAL


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) whose gradient is the identity (quantizer.py:ste_round)."""
    return _SteRound.apply(x)


def quantize(x: torch.Tensor, ac_max: int = AC_MAX_VAL) -> torch.Tensor:
    """round(x) clipped to the alphabet [-ac_max, ac_max - 1]: the eval
    branch of ConditionalNet.encode_latents and analyze
    (conditional.py:231,239)."""
    return torch.clamp(torch.round(x), -ac_max, ac_max - 1)
