"""A checkpoint's ``params.msgpack`` read without the program: the flax
subset of msgpack (maps, strings, numbers and ext type 1, the packed
triple (shape, dtype name, raw bytes) of a numpy array).  The program
reads the same raw file with its own reader."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).read()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode("utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(
                {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return bytes(self.take(n)).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            n = self.unpack(">H" if b == 0xDE else ">I")
            return {self.read(): self.read() for _ in range(n)}
        raise ValueError(f"unsupported msgpack byte {b:#04x}")


def read_params(ckpt_dir) -> dict:
    """The parameter tree of a checkpoint directory, nested dicts of
    float32 numpy arrays in the JAX layout (conv kernels HWIO)."""
    r = _Reader((Path(ckpt_dir) / "params.msgpack").read_bytes())
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree["params"] if set(tree) == {"params"} else tree
