"""Checkpoint loading without flax or msgpack.

A checkpoint is a directory with ``config.json`` (ModelConfig) and
``params.msgpack``: a flax-serialized parameter tree, i.e. msgpack maps of
strings whose leaves are msgpack ext type 1 carrying the packed triple
(shape, dtype name, raw bytes).  ``read_msgpack`` decodes that subset in
pure Python, ``params_from_jax`` turns the nested numpy tree into a torch
``state_dict`` for ``models.fullnet.FullNet``:

* conv kernels HWIO -> OIHW;
* the 4*C-channel conv of every shuffle ``UpBlock`` is permuted from the
  (i, j, c) channel order of the JAX ``depth_to_space2``
  (aivc_tpu/ops/layers.py:134-140) to the (c, i, j) order that
  ``torch.nn.functional.pixel_shuffle`` reads;
* flax ``kernel`` leaves become ``weight``.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from aivc_tpu_torch.config import ModelConfig

_EXT_NDARRAY = 1


class _Reader:
    """Minimal msgpack decoder: nil, bool, ints, floats, str, bin, array,
    map and ext (ext 1 = numpy array, as flax writes it)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _ext(self, code: int, n: int):
        payload = bytes(self._take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).read()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self._take(b & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):            # bin 8/16/32
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xC7, 0xC8, 0xC9):            # ext 8/16/32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if 0xD4 <= b <= 0xD8:                  # fixext 1/2/4/8/16
            return self._ext(self._unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):            # str 8/16/32
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return bytes(self._take(n)).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack byte {b:#04x}")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def read_msgpack(data: bytes):
    """Decode one msgpack object (the flax subset); trailing bytes raise."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"trailing bytes after msgpack object "
                         f"({len(r.data) - r.pos})")
    return obj


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def shuffle_perm(c: int) -> np.ndarray:
    """Output-channel permutation taking a depth_to_space2 conv (channel
    k = i*2C + j*C + c) to pixel_shuffle order (channel c*4 + i*2 + j):
    new[c*4 + i*2 + j] = old[i*2C + j*C + c]."""
    ci, ii, jj = np.meshgrid(np.arange(c), np.arange(2), np.arange(2),
                             indexing="ij")
    return (ii * 2 * c + jj * c + ci).reshape(-1)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Nested numpy parameter tree (as the JAX package holds it, with or
    without the top-level ``params`` key) -> FullNet ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for key, arr in _flatten(tree).items():
        parts = key.split(".")
        is_up_conv = (len(parts) >= 3 and parts[-2] == "Conv_0"
                      and parts[-3].startswith("UpBlock_"))
        if parts[-1] == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"unexpected kernel rank at {key}")
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            if is_up_conv:
                arr = arr[shuffle_perm(arr.shape[0] // 4)]
            parts[-1] = "weight"
        elif parts[-1] == "bias" and is_up_conv:
            arr = arr[shuffle_perm(arr.shape[0] // 4)]
        sd[".".join(parts)] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))
    return sd


def read_params(ckpt_dir: str | Path):
    """params.msgpack -> nested dict of numpy arrays (the JAX tree)."""
    return read_msgpack((Path(ckpt_dir) / "params.msgpack").read_bytes())


def model_from_params(cfg: ModelConfig, tree, device=None
                      ) -> "torch.nn.Module":
    """A FullNet of ``cfg`` holding the parameter tree ``tree`` (the JAX
    package's nested arrays), on ``device`` in eval mode."""
    from aivc_tpu_torch.device import resolve_device
    from aivc_tpu_torch.models.fullnet import FullNet

    dev = resolve_device(device)
    model = FullNet(cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.to(dev).eval()


def load_checkpoint(ckpt_dir: str | Path, device=None
                    ) -> Tuple[ModelConfig, "torch.nn.Module"]:
    """-> (cfg, FullNet on ``device`` in eval mode).  ``device`` defaults
    to the card; pass ``"cpu"`` explicitly to run on the host."""
    from aivc_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    cfg = ModelConfig.from_json((ckpt_dir / "config.json").read_text())
    return cfg, model_from_params(cfg, read_params(ckpt_dir), dev)
