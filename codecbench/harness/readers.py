"""The arithmetic of the per-layer metrics.  Each metric is a file
``metrics/<name>.py`` whose ``read(ctx)`` calls one of these with its own
arguments; ``ctx`` is what ``bench.run`` hands it.  Each returns None
where the run holds nothing to read, never 0."""

from __future__ import annotations

import statistics
from typing import Dict

from .trace import kernel_seconds

SECONDS = {"encode": "encode_s", "decode": "decode_s"}


def flops_share(ctx: Dict, side: str):
    """% of the card's peak: model FLOPs of every frame the window coded
    on ``side`` (the architecture's ``frame_flops``, by frame type) over
    the window's ``side`` seconds, over the configuration's peak."""
    w, t = ctx["window"], ctx["traffic"]
    if not w[SECONDS[side]]:
        return None
    flops = sum(n * ctx["frame_flops"](ctx["config"]["model"], ft,
                                       t["height"], t["width"], side)
                for ft, n in w["frames_by_type"].items())
    peak = ctx["peak_flops"][ctx["config"]["peak_dtype"]]
    return 100.0 * flops / w[SECONDS[side]] / peak


def finish_share(ctx: Dict):
    """% of the window's encode seconds spent inside
    FrameCodec.encode_frames_finish, from the benchmark's spans."""
    w = ctx["window"]
    if not w["encode_s"]:
        return None
    return 100.0 * w["finish_s"] / w["encode_s"]


def median_latency_ms(ctx: Dict):
    lat = ctx["window"]["latencies_ms"]
    return statistics.median(lat) if lat else None


def idle_share(ctx: Dict, side: str):
    """% of the traced ``side`` in which no kernel runs on the card: one
    minus the union of the kernels' spans over the traced window."""
    part = ctx["trace"] and ctx["trace"][side]
    if not part or part["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - part["busy_s"] / part["window_s"])


def roofline_share(ctx: Dict, kernel: str, side: str):
    """% of its roofline that ``kernel`` reaches in the traced ``side``:
    the least time its bytes need at the card's bandwidth
    (``rooflines/<kernel>.py``) over its kernels' device time."""
    part = ctx["trace"] and ctx["trace"][side]
    if not part:
        return None
    roof = ctx["load"](f"rooflines/{kernel}.py")
    dev_s = kernel_seconds(part, roof.KERNELS)
    moved = roof.bytes_moved(ctx["trace"]["calls"][side])
    if dev_s <= 0 or moved <= 0:
        return None
    return 100.0 * moved / ctx["hbm_bytes_s"] / dev_s
