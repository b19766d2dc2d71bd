"""Build and bind the port's CUDA kernels (csrc/kernels.cu).

The source has a plain C interface and includes no PyTorch header, so one
``nvcc`` call builds it into a shared library in seconds; ``ctypes`` loads
it.  The library is built at first use into ``aivc_tpu_torch/_build/``,
keyed by a hash of the source and the flags, so a fresh checkout builds it
itself.  Nothing here runs at import time.

Each wrapper of a kernel (coding/vrans.py, ops/warp.py, ops/gdn.py,
ops/layers.py, ops/conv1x1.py) adds one to its entry of ``LAUNCHES``
where it launches the kernel, and nowhere else.  The rANS wrappers also add the dependent steps each launch walks
(n_pad / K) to ``STEPS``, on the host, with no synchronisation.  The GDN
layers' kernel (ops/gdn.py:gdn_layer_cuda, K4 at gdn_apply's rounding
points) counts in ``LAUNCHES["gdn_layer"]``, apart from the exported
``gdn_fused``; a GDN layer whose input lies on the card but does not take
it (ops/gdn.py:GDN) adds one to ``FALLBACKS["gdn_layer"]``, so that the
layers' hit share is LAUNCHES / (LAUNCHES + FALLBACKS) of "gdn_layer".
The conv stage K6 (ops/layers.py:pad_stage_cuda) counts the same way:
``LAUNCHES["conv_stage"]``, and a ConvBlock or UpBlock call on the card
that pads its input the other way, ``FALLBACKS["conv_stage"]``.  So does
K7 (ops/conv1x1.py:conv1x1_cuda): ``LAUNCHES["conv1x1"]``, and in
``FALLBACKS["conv1x1"]`` each 1x1 conv of an ELIC Bottleneck or Attention
call on the card that took the unfused route (two a Bottleneck, the gate
of an Attention), so that the share is one of 1x1 convs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

SRC = Path(__file__).resolve().parent / "csrc" / "kernels.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 600
# Shared memory one block may use on the H100 (227 KB).  K1 fits a table
# of up to MAX_SMEM - 4096 = 228,352 B beside the ring of its smallest block
# (csrc/kernels.cu:aivc_rans_encode_smem_bytes).
MAX_SMEM = 232448

LAUNCHES = {"rans_encode": 0, "rans_decode": 0, "warp_packed": 0,
            "gdn_fused": 0, "warp_vclamped": 0, "gdn_layer": 0,
            "conv_stage": 0, "conv1x1": 0}
STEPS = {"rans_encode": 0, "rans_decode": 0}
FALLBACKS = {"gdn_layer": 0, "conv_stage": 0, "conv1x1": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in STEPS:
        STEPS[k] = 0
    for k in FALLBACKS:
        FALLBACKS[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/kernels.cu (if this source/flags pair is not built
    yet) and return the library path.  Fills BUILD_INFO with the nvcc
    seconds and its ptxas report."""
    src = SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libaivc_kernels_{key[:16]}.so"
    if so.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("ptxas", "")
        BUILD_INFO["cached"] = True
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    t0 = time.time()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO.update(seconds=time.time() - t0, cached=False,
                      ptxas=proc.stderr + proc.stdout)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        handle.aivc_rans_encode_smem_bytes.argtypes = [_I, _I]
        handle.aivc_rans_encode_smem_bytes.restype = ctypes.c_size_t
        handle.aivc_rans_encode_scratch_bytes.argtypes = [_I, _I]
        handle.aivc_rans_encode_scratch_bytes.restype = ctypes.c_size_t
        handle.aivc_rans_decode_smem_bytes.argtypes = [_I] * 6
        handle.aivc_rans_decode_smem_bytes.restype = ctypes.c_size_t
        handle.aivc_rans_encode.argtypes = (
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P])
        handle.aivc_rans_encode.restype = _I
        handle.aivc_rans_decode.argtypes = (
            [_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _P])
        handle.aivc_rans_decode.restype = _I
        handle.aivc_warp_packed.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                             _P, _P]
        handle.aivc_warp_packed.restype = _I
        handle.aivc_gdn_fused.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P,
                                          _P]
        handle.aivc_gdn_fused.restype = _I
        handle.aivc_gdn_fused_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                               _I, _P, _P]
        handle.aivc_gdn_fused_bf16.restype = _I
        handle.aivc_gdn_layer_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                               _I, _I, _I, _P, _P]
        handle.aivc_gdn_layer_bf16.restype = _I
        handle.aivc_pad_stage.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _I,
                                          _P, _P]
        handle.aivc_pad_stage.restype = _I
        handle.aivc_conv1x1.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _P, _P]
        handle.aivc_conv1x1.restype = _I
        handle.aivc_warp_vclamped.argtypes = [_P, _P, _I, _I, _I, _I, _I,
                                              _P, _P]
        handle.aivc_warp_vclamped.restype = _I
        _lib = handle
    return _lib


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def layout(t: torch.Tensor) -> torch.memory_format:
    """channels_last where a 4-D ``t`` is laid out so and is not
    NCHW-contiguous (where it is both, as with one channel or one pixel,
    the two layouts are the same bytes), else contiguous_format."""
    if not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple,
            memory_format: torch.memory_format = torch.contiguous_format
            ) -> None:
    """Raise unless ``t`` is a CUDA tensor of dtype/shape, contiguous in
    ``memory_format``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on the card, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=memory_format):
        raise ValueError(f"{name} must be contiguous ({memory_format})")
