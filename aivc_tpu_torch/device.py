"""Device selection for the port's entry points, and the settling of the
host's vector math library, and the precision rule of float32 models."""

from __future__ import annotations

import contextlib

import torch

# Elementwise functions that PyTorch's CPU kernels hand to MKL's vector
# math library (VML).  In a fresh process, where two OpenMP threads make
# the first call of one of them at once, one thread can get a coarse
# approximation instead: the first torch.sqrt of 122,880 float32 values
# on 2 threads, under load, came back up to 3.2e-4 relative off on one
# thread's half, in about 1 fresh process in 100; every later call was
# right (``python -m aivc_tpu_torch.check_host_math``).  In a --cpu run
# that would make an encoder's reconstruction differ from its decoder's.
VML_FUNCTIONS = (torch.sqrt, torch.exp, torch.log, torch.log2, torch.log10,
                 torch.sin, torch.cos, torch.tan, torch.tanh, torch.erf,
                 torch.erfc, torch.erfinv, torch.acos, torch.asin,
                 torch.atan, torch.trunc)


def settle_host_math() -> None:
    """Make the first call of each of VML_FUNCTIONS, in float32 and
    float64, on one thread (a tensor far below PyTorch's parallel grain),
    so that no later call on several threads is a first call.  Runs
    once, when the package is imported."""
    for dtype in (torch.float32, torch.float64):
        x = torch.full((16,), 0.5, dtype=dtype)
        for fn in VML_FUNCTIONS:
            fn(x)


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


@contextlib.contextmanager
def float32_precision(cfg):
    """TF32 off for cuDNN and matmuls while the block runs where
    ``cfg.full_float32``, and the previous settings back afterwards."""
    if not cfg.full_float32:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
