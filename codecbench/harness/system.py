"""The system under test: ``aivc_tpu_torch`` coding whole clips through
``pipeline.video.encode_video`` / ``decode_video`` (and so
``FrameCodec``), built from a configuration file and a traffic mix.

Everything the benchmark takes from the program passes through here.
The spans the benchmark records are wrappers set on the codec instance
around its calls (``Spans``), and the check's capture of the symbols a
decode reads (``capture_decode``); neither edits the program.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.profiler


def model_config(config: dict):
    from aivc_tpu_torch.config import ModelConfig
    return ModelConfig.from_json(json.dumps(config["model"]))


class System:
    """One FrameCodec for the cell's frame size, from the configuration
    ``config`` (its checkpoint, with the compute dtype the file states)
    and the coding settings of ``traffic``."""

    def __init__(self, root: Path, config: dict, traffic: dict, device):
        from aivc_tpu_torch.config import CodingConfig
        from aivc_tpu_torch.pipeline.codec import FrameCodec
        from aivc_tpu_torch.utils.checkpoint import (model_from_params,
                                                     read_tree)

        self.device = torch.device(device)
        cfg = model_config(config)
        _, tree = read_tree(root / config["checkpoint"])
        model = model_from_params(cfg, tree, self.device)
        self.h, self.w = traffic["height"], traffic["width"]
        self.codec = FrameCodec(cfg, model, self.h, self.w,
                                device=self.device)
        del model
        self.coding = CodingConfig(
            coding_config=traffic["coding"], gop_size=traffic["gop_size"],
            intra_period=traffic["intra_period"],
            idx_rate=float(traffic["idx_rate"]))
        self.wave_batch = int(traffic["wave_batch"])

    def encode(self, frames):
        from aivc_tpu_torch.pipeline.video import encode_video
        return encode_video(self.codec, frames, self.coding,
                            wave_batch=self.wave_batch)

    def decode(self, stream: bytes) -> Dict[int, Dict[str, np.ndarray]]:
        """The decoded frames as host uint8 planes (what a player gets)."""
        from aivc_tpu_torch.pipeline.video import decode_video
        out = decode_video(self.codec, stream)
        return {i: out[i].planes for i in sorted(out)}

    def clip_specs(self, n: int):
        return clip_specs(self.coding.gop_struct_name(), self.wave_batch, n)


def clip_specs(gop_name: str, wave_batch: int, n: int):
    """Per frame of an n-frame clip of one GOP: its type and reference
    indices; and the decode's batches as lists of frame indices, in call
    order (the program's wave grouping)."""
    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.pipeline.video import _ai_groups, wave_groups

    if gop_name == "1_GOP_0":
        specs = {i: {"type": 0, "prev": None, "next": None}
                 for i in range(n)}
        return specs, _ai_groups(n, max(1, wave_batch))
    gop = generate_gop_struct(gop_name)
    if len(gop) != n:
        raise ValueError(f"a clip of {n} frames is not one GOP of "
                         f"{gop_name} ({len(gop)} frames)")
    specs = {f.idx: {"type": f.frame_type, "prev": f.prev_ref,
                     "next": f.next_ref} for f in gop.frames}
    waves = [[s.idx for s in group]
             for _, group in wave_groups(gop, max(1, wave_batch))]
    return specs, waves


class Spans:
    """Host-clock spans around the codec's per-wave calls, set on the
    instance: ``launch`` and ``finish`` (encode), ``batch`` (decode).
    Each record is (name, start, end, frames)."""

    def __init__(self, codec, label: bool = False):
        self.codec = codec
        self.label = label
        self.records: List[tuple] = []
        self._wrap("encode_frames_launch", "launch",
                   lambda a: len(a[0]))
        self._wrap("encode_frames_finish", "finish", lambda a: a[0]["k"])
        self._wrap("decode_frames_batch", "batch", lambda a: len(a[0]))

    def _wrap(self, method: str, name: str, frames):
        inner = getattr(self.codec, method)
        rec = self.records
        span = "codecbench." + name

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            if self.label:
                with torch.profiler.record_function(span):
                    out = inner(*args, **kw)
            else:
                out = inner(*args, **kw)
            rec.append((name, t0, time.perf_counter(), frames(args)))
            return out

        setattr(self.codec, method, wrapped)

    def remove(self) -> None:
        for m in ("encode_frames_launch", "encode_frames_finish",
                  "decode_frames_batch"):
            self.codec.__dict__.pop(m, None)


def capture_decode(system: System, stream: bytes):
    """Decode ``stream`` with the symbols each batch reads recorded: per
    decode batch, in call order, the frame type, per net the z and y
    symbols (keys ("z", net), ("y", net)) and the DC offsets ("dc").
    -> (decoded planes, batches)."""
    codec = system.codec
    batches: List[dict] = []

    def keep(key):
        return lambda v: batches[-1].__setitem__(key, v.detach().clone())

    hooks = [
        (codec, "decode_frames_batch",
         lambda fb, p, n, t, *a, **kw: batches.append({"type": t})),
        (codec, "_hyper", lambda which, z: keep(("z", which))(z)),
        (codec, "_motion", lambda q, *a: keep(("y", "mofnet"))(q)),
        (codec.model, "codecnet_synth",
         lambda q, *a: keep(("y", "codecnet"))(q)),
        (codec, "_apply_dc", lambda out, dc: keep("dc")(dc)),
    ]
    for obj, name, see in hooks:
        inner = getattr(obj, name)

        def wrapped(*a, _inner=inner, _see=see, **kw):
            _see(*a, **kw)
            return _inner(*a, **kw)
        setattr(obj, name, wrapped)
    try:
        planes = system.decode(stream)
    finally:
        for obj, name, _ in hooks:
            obj.__dict__.pop(name, None)
    return planes, batches
