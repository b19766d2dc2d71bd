"""A checkpoint's ``params.msgpack`` read and written without the
program: the flax subset of msgpack (maps, strings, numbers and ext type
1, the packed triple (shape, dtype name, raw bytes) of a numpy array).
The program reads the same raw file with its own reader."""

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


def _pack_len(out: bytearray, n: int, fix, codes) -> None:
    """A length header: the fix form where there is one and n fits, else
    the smallest of ``codes`` ((code, struct format, largest n), ...)."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, top in codes:
        if n <= top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


_U8, _U16, _U32 = (">B", 0xFF), (">H", 0xFFFF), (">I", 0xFFFFFFFF)


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 15), ((0xDE, *_U16), (0xDF, *_U32)))
        for k in sorted(obj):
            _pack(out, k)
            _pack(out, obj[k])
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 15), ((0xDC, *_U16), (0xDD, *_U32)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 31),
                  ((0xD9, *_U8), (0xDA, *_U16), (0xDB, *_U32)))
        out += b
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None,
                  ((0xC4, *_U8), (0xC5, *_U16), (0xC6, *_U32)))
        out += obj
    elif isinstance(obj, int) and 0 <= obj <= 0xFFFFFFFF:
        _pack_len(out, obj, (0x00, 0x7F),
                  ((0xCC, *_U8), (0xCD, *_U16), (0xCE, *_U32)))
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack(payload, [[int(d) for d in obj.shape], obj.dtype.name,
                        np.ascontiguousarray(obj).tobytes()])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _pack_len(out, len(payload), None,
                      ((0xC7, *_U8), (0xC8, *_U16), (0xC9, *_U32)))
        out += struct.pack(">b", _EXT_NDARRAY) + payload
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def write_params(ckpt_dir, tree: dict) -> None:
    """``params.msgpack`` of a parameter tree (nested dicts of numpy
    arrays in the JAX layout) under ``params``, keys sorted at every level
    as flax writes them."""
    out = bytearray()
    _pack(out, {"params": tree})
    (Path(ckpt_dir) / "params.msgpack").write_bytes(bytes(out))
