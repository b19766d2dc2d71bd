"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device.  With no card and
    no explicit request this raises instead of silently running on the
    host: every measurement and the kernels need the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)
