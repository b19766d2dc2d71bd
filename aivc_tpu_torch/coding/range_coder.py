"""ctypes binding to the host rANS range coder (the port's copy of
aivc_tpu/coding/range_coder.py).

The host entropy backend codes each latent chunk on the host with this
coder (``pipeline/codec.py``, ``entropy_backend="host"``).  The shared
library is built at first use by one ``g++ -O3 -shared -fPIC -std=c++17``
of ``native/range_coder.cpp`` into ``aivc_tpu_torch/_build/``, keyed by a
hash of the source and the flags.  Unlike the JAX package, a failed build
raises: there is no quiet fallback to the Python coder, which stays only
as the oracle the tests hold the library against (``_py_encode``,
``_py_decode``; bit-identical).

All CDFs are integer-quantized uint32 rows (``coding/cdf.py``); elements
address rows through an int32 index array.  ctypes releases the GIL
during a call, so a wave's chunks code in parallel threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS
_RANS_L = 1 << 23

SRC = Path(__file__).resolve().parent.parent / "native" / "range_coder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
CXX_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile native/range_coder.cpp (if this source and these flags are
    not built yet) and return the library path; raises if g++ fails."""
    src = SRC.read_bytes()
    key = hashlib.sha256(src + " ".join([CXX] + CXX_FLAGS).encode())
    so = BUILD_DIR / f"librange_coder_{key.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SRC)],
                                  capture_output=True, text=True,
                                  timeout=CXX_TIMEOUT_S)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX} to build the range "
                               f"coder: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed to build the range coder "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        # Concurrent processes each write their own file; the rename is
        # atomic, so no process loads a half-written library.
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def lib() -> ctypes.CDLL:
    """The loaded coder library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        handle.rans_encode.restype = ctypes.c_long
        handle.rans_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ]
        handle.rans_decode.restype = ctypes.c_long
        handle.rans_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
        ]
        _lib = handle
    return _lib


def _check_inputs(symbols, cdf, row_idx):
    symbols = np.ascontiguousarray(symbols, dtype=np.uint16)
    cdf = np.ascontiguousarray(cdf, dtype=np.uint32)
    row_idx = np.ascontiguousarray(row_idx, dtype=np.int32)
    if cdf.ndim != 2:
        raise ValueError("cdf must be [n_rows, Lp]")
    if symbols.shape != row_idx.shape or symbols.ndim != 1:
        raise ValueError("symbols and row_idx must be 1-D and equal length")
    if row_idx.size and (row_idx.min() < 0 or row_idx.max() >= cdf.shape[0]):
        raise ValueError("row_idx out of range")
    return symbols, cdf, row_idx


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def encode(symbols: np.ndarray, cdf: np.ndarray, row_idx: np.ndarray) -> bytes:
    """rANS-encode symbols (uint16, each in [0, Lp-2]) against CDF rows."""
    symbols, cdf, row_idx = _check_inputs(symbols, cdf, row_idx)
    n = symbols.size
    if n == 0:
        return b""
    handle = lib()
    capacity = 4 * n + 64  # worst case ~16 bits/symbol + flush slack
    while True:
        out = np.empty(capacity, dtype=np.uint8)
        nbytes = handle.rans_encode(
            _ptr(symbols, ctypes.c_uint16), n, _ptr(cdf, ctypes.c_uint32),
            cdf.shape[1], _ptr(row_idx, ctypes.c_int32),
            _ptr(out, ctypes.c_uint8), capacity)
        if nbytes == -1:
            capacity *= 2
            continue
        if nbytes < 0:
            raise ValueError(f"rans_encode failed with code {nbytes}")
        return out[:nbytes].tobytes()


def decode(data: bytes, n: int, cdf: np.ndarray, row_idx: np.ndarray) -> np.ndarray:
    """Decode n symbols from a byte string against CDF rows."""
    if n == 0:
        return np.empty(0, dtype=np.uint16)
    dummy = np.zeros(n, dtype=np.uint16)
    _, cdf, row_idx = _check_inputs(dummy, cdf, row_idx)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint16)
    rc = lib().rans_decode(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(cdf, ctypes.c_uint32),
        cdf.shape[1], _ptr(row_idx, ctypes.c_int32), n,
        _ptr(out, ctypes.c_uint16))
    if rc != 0:
        raise ValueError(f"rans_decode failed with code {rc}")
    return out


# ---------------------------------------------------------------------------
# Pure-Python mirror (bit-identical): the oracle of the tests
# ---------------------------------------------------------------------------

def _py_encode(symbols: np.ndarray, cdf: np.ndarray, row_idx: np.ndarray) -> bytes:
    out = bytearray()
    x = _RANS_L
    for i in range(symbols.size - 1, -1, -1):
        row = cdf[row_idx[i]]
        s = int(symbols[i])
        start = int(row[s])
        freq = int(row[s + 1]) - start
        if freq == 0:
            raise ValueError("zero-frequency symbol")
        x_max = ((_RANS_L >> PROB_BITS) << 8) * freq
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // freq) << PROB_BITS) + (x % freq) + start
    for _ in range(4):
        out.append(x & 0xFF)
        x >>= 8
    return bytes(reversed(out))


def _py_decode(data: bytes, n: int, cdf: np.ndarray, row_idx: np.ndarray) -> np.ndarray:
    x = int.from_bytes(data[0:4], "big")
    pos = 4
    out = np.empty(n, dtype=np.uint16)
    for i in range(n):
        row = cdf[row_idx[i]]
        dv = x & (PROB_SCALE - 1)
        s = int(np.searchsorted(row, dv, side="right")) - 1
        start = int(row[s])
        freq = int(row[s + 1]) - start
        out[i] = s
        x = freq * (x >> PROB_BITS) + dv - start
        while x < _RANS_L:
            if pos < len(data):
                x = (x << 8) | data[pos]
                pos += 1
            else:
                x <<= 8
    return out
