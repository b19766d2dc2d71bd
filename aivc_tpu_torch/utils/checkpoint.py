"""Checkpoints without flax or msgpack: read and write.

A checkpoint is a directory with ``config.json`` (ModelConfig, or
ElicConfig where its ``arch`` is "elic") and
``params.msgpack``: a flax-serialized parameter tree, i.e. msgpack maps of
strings, keys sorted as flax writes them, whose leaves are msgpack ext
type 1 carrying the packed triple (shape, dtype name, raw bytes).
``read_msgpack`` and ``write_msgpack`` code that subset in pure Python,
byte for byte as flax does.  ``params_from_jax`` turns the nested numpy
tree into a torch ``state_dict`` for ``models.fullnet.FullNet``, and
``params_to_jax`` is its exact inverse:

* conv kernels HWIO -> OIHW;
* the 4*C-channel conv of every shuffle ``UpBlock`` is permuted from the
  (i, j, c) channel order of the JAX ``depth_to_space2``
  (aivc_tpu/ops/layers.py:134-140) to the (c, i, j) order that
  ``torch.nn.functional.pixel_shuffle`` reads;
* flax ``kernel`` leaves become ``weight``.

A training run also keeps ``opt_state.msgpack``: the state of optax's
``chain(clip_by_global_norm, adam(schedule))`` as flax serializes it,
``{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {"count"} or {}}}``
with mu and nu trees of the parameters' shape.  ``write_opt_state`` and
``read_opt_state`` map it to and from ``train.trainer.Optimizer``, so
either package resumes the other's leg with Adam's memory.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from aivc_tpu_torch.config import (
    ElicConfig,
    ModelConfig,
    model_config_from_json,
)

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


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 2 ** 64 - 1)):
            if n <= top:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} too large for msgpack")
    else:
        for code, fmt, bot in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if n >= bot:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} too small for msgpack")


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form up to fix_max, then the 8- (where
    the type has one), 16- and 32-bit forms."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n <= top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                          (0xDA, ">H", 0xFFFF),
                                          (0xDB, ">I", 0xFFFFFFFF)))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(out, len(b), None, 0, ((0xC4, ">B", 0xFF),
                                         (0xC5, ">H", 0xFFFF),
                                         (0xC6, ">I", 0xFFFFFFFF)))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                            (0xDD, ">I", 0xFFFFFFFF)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                            (0xDF, ">I", 0xFFFFFFFF)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, write_msgpack(
            (tuple(int(d) for d in obj.shape), obj.dtype.name,
             np.ascontiguousarray(obj).tobytes())))
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} as msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF)))
    out += struct.pack(">b", code) + payload


def _sorted_tree(obj):
    """Dict keys sorted at every level, as flax's serializer leaves them
    (it maps the tree through jax.tree_util, which sorts dict keys)."""
    if isinstance(obj, dict):
        return {k: _sorted_tree(obj[k]) for k in sorted(obj)}
    return obj


def write_msgpack(obj) -> bytes:
    """Encode ``obj`` (nested dicts with str keys, lists, tuples, ints,
    str, bytes and numpy arrays: what flax writes for a tree of arrays)
    as flax's ``msgpack_serialize`` does:
    dict keys sorted, arrays as ext type 1.  Arrays of a GiB or more,
    which flax would split into chunks, are refused."""
    out = bytearray()
    _pack(out, _sorted_tree(obj))
    return bytes(out)


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree


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
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        if not arr.flags.writeable:     # a view of a JAX array
            arr = arr.copy()
        sd[".".join(parts)] = torch.from_numpy(arr)
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """FullNet ``state_dict`` (or any dict of its parameter names, such as
    Adam's moments) -> the nested numpy tree of the JAX package, under a
    top-level ``params`` key: the exact inverse of ``params_from_jax``."""
    flat = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        parts = key.split(".")
        is_up_conv = (len(parts) >= 3 and parts[-2] == "Conv_0"
                      and parts[-3].startswith("UpBlock_"))
        if is_up_conv and parts[-1] in ("weight", "bias"):
            arr = arr[np.argsort(shuffle_perm(arr.shape[0] // 4))]
        if parts[-1] == "weight":
            if arr.ndim != 4:
                raise ValueError(f"unexpected weight rank at {key}")
            arr = arr.transpose(2, 3, 1, 0)          # OIHW -> HWIO
            parts[-1] = "kernel"
        flat[".".join(parts)] = np.ascontiguousarray(arr)
    return {"params": _nest(flat)}


def save_tree(ckpt_dir: str | Path, cfg: ModelConfig, tree) -> None:
    """Write ``config.json`` and ``params.msgpack`` of a parameter tree in
    the JAX package's layout (nested dicts of numpy arrays under
    ``params``): the files aivc_tpu/utils/checkpoint.py:save_checkpoint
    writes for the same tree and config."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    (ckpt_dir / "config.json").write_text(cfg.to_json())
    (ckpt_dir / "params.msgpack").write_bytes(write_msgpack(tree))


def save_checkpoint(ckpt_dir: str | Path, cfg: ModelConfig, params) -> None:
    """Write ``config.json`` and ``params.msgpack`` of a FullNet (or of its
    ``state_dict``-like dict of tensors, e.g. an EMA shadow): the files
    aivc_tpu/utils/checkpoint.py:save_checkpoint writes for the same
    parameters."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    save_tree(ckpt_dir, cfg, params_to_jax(params))


def _scalar(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def write_opt_state(path: str | Path, optimizer, names: List[str]) -> None:
    """``opt_state.msgpack`` of ``optimizer`` (train.trainer.Optimizer,
    one tensor of mu and nu per name in ``names``) in the layout of
    flax's serialization of optax's chain(clip_by_global_norm,
    adam(lr)) state."""
    adam = {"count": _scalar(optimizer.count),
            "mu": params_to_jax(dict(zip(names, optimizer.mu))),
            "nu": params_to_jax(dict(zip(names, optimizer.nu)))}
    sched = ({} if optimizer.schedule_count is None
             else {"count": _scalar(optimizer.schedule_count)})
    Path(path).write_bytes(write_msgpack({"0": {}, "1": {"0": adam,
                                                         "1": sched}}))


def read_opt_state(path: str | Path, optimizer, names: List[str]) -> None:
    """Load ``opt_state.msgpack`` (written by either package) into
    ``optimizer``.  Raises ValueError where the layout, the parameter
    names or a shape differ, or where the file has a schedule count and
    the optimizer a constant rate (or the reverse), as flax's
    ``from_bytes`` would."""
    tree = read_msgpack(Path(path).read_bytes())
    try:
        adam, sched = tree["1"]["0"], tree["1"]["1"]
        mu = params_from_jax(adam["mu"])
        nu = params_from_jax(adam["nu"])
        count = int(adam["count"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"{path}: not an optax adam state ({e})") from None
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError(f"{path}: parameter names differ from the model's")
    if ("count" in sched) != (optimizer.schedule_count is not None):
        raise ValueError(f"{path}: schedule state does not match the "
                         f"optimizer's learning rate")
    for i, n in enumerate(names):
        for dst, src in ((optimizer.mu, mu), (optimizer.nu, nu)):
            if tuple(src[n].shape) != tuple(dst[i].shape):
                raise ValueError(f"{path}: {n} has shape "
                                 f"{tuple(src[n].shape)}, the model "
                                 f"{tuple(dst[i].shape)}")
    with torch.no_grad():
        for i, n in enumerate(names):
            optimizer.mu[i].copy_(mu[n])
            optimizer.nu[i].copy_(nu[n])
    optimizer.count = count
    if "count" in sched:
        optimizer.schedule_count = int(sched["count"])


def read_params(ckpt_dir: str | Path):
    """params.msgpack -> nested dict of numpy arrays (the JAX tree)."""
    return read_msgpack((Path(ckpt_dir) / "params.msgpack").read_bytes())


def read_tree(ckpt_dir: str | Path
              ) -> Tuple[ModelConfig | ElicConfig, dict]:
    """-> (cfg, the parameter tree as ``read_params`` gives it): a
    checkpoint on the host, for surgery that ``save_tree`` writes back."""
    ckpt_dir = Path(ckpt_dir)
    cfg = model_config_from_json((ckpt_dir / "config.json").read_text())
    return cfg, read_params(ckpt_dir)


def model_from_params(cfg: ModelConfig | ElicConfig, tree, device=None
                      ) -> "torch.nn.Module":
    """The model of ``cfg`` (a FullNet, or an Elic for an ElicConfig)
    holding the parameter tree ``tree`` (nested arrays in the JAX
    package's layout), on ``device`` in eval mode."""
    from aivc_tpu_torch.device import resolve_device
    from aivc_tpu_torch.models.elic import Elic
    from aivc_tpu_torch.models.fullnet import FullNet

    dev = resolve_device(device)
    model = Elic(cfg) if isinstance(cfg, ElicConfig) else FullNet(cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.to(dev).eval()


def load_checkpoint(ckpt_dir: str | Path, device=None
                    ) -> Tuple[ModelConfig, "torch.nn.Module"]:
    """-> (cfg, its model on ``device`` in eval mode).  ``device`` defaults
    to the card; pass ``"cpu"`` explicitly to run on the host."""
    from aivc_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cfg, tree = read_tree(ckpt_dir)
    return cfg, model_from_params(cfg, tree, dev)
