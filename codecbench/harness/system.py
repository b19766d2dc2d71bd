"""The system under test: a codec of ``aivc_tpu_torch`` coding whole
clips through ``pipeline.video.encode_video`` / ``decode_video`` (and so
``FrameCodec``), with the coding settings of a traffic mix.  The
configuration's architecture (``architectures/<name>.py``) builds the
codec from its files.

Everything the benchmark takes from the program passes through here or
through the architecture.  The spans the benchmark records are wrappers
set on the codec instance around its calls (``Spans``); they edit
nothing of the program.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.profiler


class System:
    """One FrameCodec ``codec`` for the cell's frame size, with the coding
    settings of ``traffic``."""

    def __init__(self, codec, traffic: dict, device):
        from aivc_tpu_torch.config import CodingConfig

        self.device = torch.device(device)
        self.codec = codec
        self.h, self.w = traffic["height"], traffic["width"]
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
