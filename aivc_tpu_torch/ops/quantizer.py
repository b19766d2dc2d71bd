"""Latent quantization, eval path (counterpart of
aivc_tpu/ops/quantizer.py): hard round to nearest, ties to even as
``jnp.round``; training noise and the straight-through gradient wait for
the training slice."""

from __future__ import annotations

import torch

from aivc_tpu_torch.config import AC_MAX_VAL


def quantize(x: torch.Tensor, ac_max: int = AC_MAX_VAL) -> torch.Tensor:
    """round(x) clipped to the alphabet [-ac_max, ac_max - 1]."""
    return torch.clamp(torch.round(x), -ac_max, ac_max - 1)
