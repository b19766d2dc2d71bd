"""Where a coded clip's idle card time goes, by the port's own spans
(tracing.py), run on demand.

    python -m aivc_tpu_torch.profile_codec [--coding RA|LDP|AI] [--float32]
        [--ckpt DIR] [--clips bounce,wheel,zoom] [--rounds 2] [--out FILE]

Codes 33-frame 1920x1080 clips of held-out families (eval/clips.py) with
bf16-r5 (both nets in float32 and TF32 off with ``--float32``), or the
checkpoint ``--ckpt`` names (an ELIC one codes All-Intra alone): RA GOP
16 / intra 32 and All-Intra at wave batch 8, encoded then decoded; LDP
intra 32, one frame a wave, encoded only.  For each clip: one warm
encode and decode; ``--rounds`` rounds of (off, on, on, off), each
timing the encode and the decode (planes pulled to the host) with
tracing off and inside ``tracing.recording()`` (what the spans cost);
then one encode and one decode under torch.profiler inside
``recording()``: the card's idle share of each, split by the class of
the innermost span the host was in ("dispatch", "host", or outside the
codec's calls) and by its name (ELIC's context steps: ``launch.ctx``,
``batch.ctx``), every span's count, seconds and self
seconds, the K1 / K2 steps of each wave (``finish.k1`` / ``batch.k2``),
and each frame's latency from its wave's ``launch`` start to its
``finish`` end in the recorded, unprofiled encodes.  Prints the card's
name and power limit, one JSON object a clip, then the summary; writes
all of it to ``--out`` too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from pathlib import Path
from typing import Dict, List

import torch

from aivc_tpu_torch import tracing

ROOT = Path(__file__).resolve().parents[1]
CODING = {"RA": (8, True), "AI": (8, True), "LDP": (1, False)}
FRAMES, HEIGHT, WIDTH = 33, 1080, 1920


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def latencies_ms(rec: tracing.Recording) -> List[float]:
    """Per frame: its wave's ``launch`` start to ``finish`` end, in ms."""
    start = {s.wave: s.start for s in rec.named("launch")}
    out = []
    for s in rec.named("finish"):
        out += [(s.end - start[s.wave]) / 1e6] * s.k
    return out


def traced(fn) -> Dict:
    """``fn()`` under torch.profiler (CPU and CUDA) inside
    ``recording()``, the card synchronised before and after: the window,
    the card's busy and idle seconds, the idle seconds by span class and
    by span name, and the spans' summary and step attributes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, tracing.recording() as rec:
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"error": "the profiler recorded no device events"}
    w0, w1 = rec.to_trace_us(t0, start_ns), rec.to_trace_us(t1, start_ns)
    spans = rec.on_trace(start_ns)
    window = (w1 - w0) / 1e6
    busy = tracing.union_length(
        (max(a, w0), min(b, w1)) for a, b in kernels if b > w0 and a < w1)
    by_cls = tracing.idle_by(kernels, [(s["start_us"], s["end_us"],
                                        s["class"]) for s in spans], w0, w1)
    by_name = tracing.idle_by(kernels, [(s["start_us"], s["end_us"],
                                         s["name"]) for s in spans], w0, w1)
    share = {c: 100.0 * by_cls.get(c, 0.0) / 1e6 / window
             for c in ("dispatch", "host")}
    return {"window_s": window, "busy_s": busy / 1e6,
            "idle_pct": 100.0 * (1.0 - busy / 1e6 / window),
            "dispatch_idle_pct": share["dispatch"],
            "host_idle_pct": share["host"],
            "outside_idle_s": by_cls.get(None, 0.0) / 1e6,
            "idle_s_by_span": sorted(
                ([n or "outside", v / 1e6] for n, v in by_name.items()),
                key=lambda nv: -nv[1]),
            "spans": rec.summary(),
            "k1": [s.attrs for s in rec.named("finish.k1")],
            "k2_steps": sum(s.attrs["steps"] for s in rec.named("batch.k2")),
            "kernels": len(kernels)}


def profile_clip(codec, coding, frames, wave_batch: int, decode: bool,
                 rounds: int) -> Dict:
    from aivc_tpu_torch.pipeline.video import decode_video, encode_video

    def enc():
        return encode_video(codec, frames, coding, wave_batch=wave_batch)

    def dec(stream):
        out = decode_video(codec, stream)
        return {i: out[i].planes for i in sorted(out)}

    sides = ("encode", "decode") if decode else ("encode",)
    stream = enc().bitstream
    if decode:
        dec(stream)
    secs = {m: {side: [] for side in sides} for m in ("off", "on")}
    lat: List[float] = []
    for _ in range(rounds):
        for mode in ("off", "on", "on", "off"):
            with (tracing.recording() if mode == "on"
                  else contextlib.nullcontext()) as rec:
                secs[mode]["encode"].append(timed(enc))
                if decode:
                    secs[mode]["decode"].append(timed(lambda: dec(stream)))
            if rec is not None:
                lat += latencies_ms(rec)
    out = {"bytes": len(stream), "seconds": secs,
           "cost_pct": {side: 100.0 * (statistics.median(secs["on"][side])
                                       / statistics.median(secs["off"][side])
                                       - 1.0) for side in sides},
           "latency_ms": {"p50": statistics.median(lat),
                          "p95": statistics.quantiles(lat, n=20)[-1]}}
    out["encode"] = traced(enc)
    if decode:
        out["decode"] = traced(lambda: dec(stream))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coding", choices=sorted(CODING), default="RA")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--ckpt", default=str(ROOT / "models_ckpt" / "bf16-r5"))
    ap.add_argument("--clips", default="bounce,wheel,zoom")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from aivc_tpu_torch import smoke
    from aivc_tpu_torch.config import CodingConfig
    from aivc_tpu_torch.eval.clips import FAMILIES
    from aivc_tpu_torch.pipeline.codec import make_codec
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_tree

    dev = torch.device("cuda")
    cfg, tree = read_tree(args.ckpt)
    if args.float32:
        cfg = smoke.f32_config(cfg)
    codec = make_codec(cfg, model_from_params(cfg, tree, dev), HEIGHT,
                       WIDTH, device=dev)
    if codec.intra_only and args.coding != "AI":
        ap.error(f"{cfg.name} is an intra-only model: --coding AI")
    wave_batch, decode = CODING[args.coding]
    coding = CodingConfig(coding_config=args.coding, gop_size=16,
                          intra_period=32, idx_rate=0.0)
    head = {"card": smoke.device_info()["smi"], "coding": args.coding,
            "float32": args.float32, "model": cfg.name,
            "wave_batch": wave_batch}
    print(json.dumps(head), flush=True)
    clips = []
    for name in args.clips.split(","):
        frames = FAMILIES[name](FRAMES, HEIGHT, WIDTH)
        res = {"clip": name, **profile_clip(codec, coding, frames,
                                            wave_batch, decode, args.rounds)}
        print(json.dumps(res), flush=True)
        clips.append(res)
    sides = ("encode", "decode") if decode else ("encode",)
    summary = {side: {key: [c[side][key] for c in clips]
                      for key in ("idle_pct", "dispatch_idle_pct",
                                  "host_idle_pct")}
               for side in sides}
    summary["cost_pct"] = [c["cost_pct"] for c in clips]
    summary["latency_ms"] = [c["latency_ms"] for c in clips]
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**head, "clips": clips, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
