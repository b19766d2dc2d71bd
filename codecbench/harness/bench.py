"""One run of one cell: set-up, the measured window, the traced
sub-window (``--trace 1``), the module guard, the correctness check and
the result line.  ``run.py`` is the command; tests call ``run`` with a
small configuration on the host.  What depends on the model (the system,
the capture of a decode's symbols, the reference's judgement, the FLOP
count) comes from the configuration's architecture
(``architectures/<name>.py``)."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import clips as clipgen
from . import trace as tr
from . import weights
from .manifest import Manifest, load_file
from .system import Spans, System

# Modules that may not be loaded in the process that prints the result,
# compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aivc_tpu")
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12


def forbidden_modules(modules=None) -> List[str]:
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                           else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of a codecbench cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Clip:
    def __init__(self, family: str, planes: Dict[str, np.ndarray]):
        self.family = family
        self.planes = planes
        self.frames = clipgen.frames_of(planes)


def make_clips(traffic: Dict, seed: int, device) -> tuple:
    """The mix's clips and the window's order, drawn from ``seed``: every
    family once, each from its own first time step and grain, in a
    seed-given order; and one index, drawn from the seed, among the first
    ``check_within`` clips, which the run judges all of (the diagnosis
    follows that one)."""
    rng = np.random.default_rng(seed)
    fams = list(traffic["families"])
    order = [int(i) for i in rng.permutation(len(fams))]
    t0s = rng.integers(0, traffic["t0_max"], size=len(fams))
    gseed = int(rng.integers(0, 2 ** 62))
    check_at = int(rng.integers(0, traffic["check_within"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(gseed)
    photos = clipgen.load_photos(device)
    out = []
    for i, fam in enumerate(fams):
        x = clipgen.FAMILIES[fam](traffic["frames"], traffic["height"],
                                  traffic["width"], int(t0s[i]), gen, photos)
        out.append(Clip(fam, clipgen.to_planes(x)))
    return [out[i] for i in order], check_at


def latencies_ms(records) -> List[float]:
    """Per frame: launch start to finish end of its wave, in ms."""
    out, start = [], None
    for name, t0, t1, k in records:
        if name == "launch":
            start = t0 if start is None else start
        elif name == "finish" and start is not None:
            out.extend([(t1 - start) * 1e3] * k)
            start = None
    return out


def differing(a: Dict[int, Dict], b: Dict[int, Dict]) -> Dict[int, int]:
    """Per frame of ``a``, the pixels in which ``b`` differs (all of them
    where ``b`` lacks the frame)."""
    out = {}
    for i, fa in a.items():
        fb = b.get(i)
        out[i] = sum(int(np.count_nonzero(fa[k] != fb[k])) if fb else
                     fa[k].size for k in ("y", "u", "v"))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """Each limited number beside its limit, and whether all hold: the one
    rule that decides ``correct`` for a run and for the control."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict[str, Dict]) -> None:
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)


def traced_window(system: System, clip: Clip, decode: bool,
                  cuda: bool) -> Optional[Dict]:
    """One more clip under the profiler: its encode, then its decode,
    each traced on its own, with the benchmark's host spans and the
    shapes of every K1-K3 launch."""
    if not cuda:
        return None
    from torch.profiler import record_function

    def spanned(name, fn, *a):
        with record_function(tr.SPAN_PREFIX + name):
            return fn(*a)

    spans = Spans(system.codec, label=True)
    try:
        with tr.KernelCalls() as enc_calls:
            enc = tr.profiled(lambda: spanned("encode_video", system.encode,
                                              clip.frames))
        stream = enc.pop("result").bitstream
        dec, dec_calls = None, None
        if decode:
            with tr.KernelCalls() as dec_calls:
                dec = tr.profiled(lambda: spanned("decode_video",
                                                  system.decode, stream))
            dec.pop("result")
    finally:
        spans.remove()
    return {"encode": enc, "decode": dec,
            "calls": {"encode": enc_calls, "decode": dec_calls},
            "frames": len(clip.frames)}


def run(argv, root: Path, t_start: float, device="cuda",
        require_card: bool = True,
        break_system: Optional[Callable] = None) -> int:
    args = parse(argv)
    man = Manifest(root)
    cell = man.workload(args.workload)
    config = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    limits = man.limits(cell["name"])
    arch = man.architecture(config)
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        print(f"codecbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import aivc_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"codecbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device(device)
    with weights.prepared(root, config, arch, dev) as weights_dir:
        return measure(args, man, cell, config, traffic, limits, arch,
                       weights_dir, root, t_start, dev, break_system)


def measure(args, man: Manifest, cell: Dict, config: Dict, traffic: Dict,
            limits: Dict, arch, weights_dir: Path, root: Path,
            t_start: float, dev: torch.device,
            break_system: Optional[Callable]) -> int:
    """Set-up, the window, the check and the result line of one run, with
    the configuration's parameters in ``weights_dir``."""
    cuda = dev.type == "cuda"
    system = arch.system(root, config, traffic, dev, weights_dir)
    if break_system is not None:
        break_system(system, arch)
    clips, _ = make_clips(traffic, args.seed, dev)
    n_judged = int(traffic["check_within"])
    specs, waves = system.clip_specs(traffic["frames"])
    types = [specs[i]["type"] for i in range(traffic["frames"])]
    decode_in_window = bool(traffic["decode"])
    # Warm-up: one clip of the cell's shapes, encoded and decoded.
    warm = system.encode(clips[-1].frames)
    system.decode(warm.bitstream)
    del warm
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    spans = Spans(system.codec)
    enc_s = dec_s = 0.0
    n_frames = 0
    by_type = {0: 0, 1: 0, 2: 0}
    kept: Dict[int, Dict] = {}
    i = 0
    t_w0 = time.perf_counter()
    while True:
        clip = clips[i % len(clips)]
        t0 = time.perf_counter()
        res = system.encode(clip.frames)
        t1 = time.perf_counter()
        enc_s += t1 - t0
        if i < n_judged:
            kept[i] = {"clip": clip, "stream": res.bitstream,
                       "encoder": {j: res.decoded_frames[j].planes
                                   for j in sorted(res.decoded_frames)}}
        if decode_in_window:
            t2 = time.perf_counter()
            dec = system.decode(res.bitstream)
            dec_s += time.perf_counter() - t2
            if i < n_judged:
                kept[i]["decoded"] = dec
        del res
        n_frames += len(clip.frames)
        for t in types:
            by_type[t] += 1
        i += 1
        if time.perf_counter() - t_w0 >= args.seconds and i >= n_judged:
            break
    n_clips = i
    spans.remove()
    records = spans.records
    lat = latencies_ms(records)

    metrics: Dict[str, float] = {"setup_s": setup_s}
    if enc_s > 0:
        metrics["encode_fps"] = n_frames / enc_s
    if dec_s > 0:
        metrics["decode_fps"] = n_frames / dec_s
    if lat:
        metrics["frame_p95_ms"] = float(np.percentile(lat, 95))

    traced = None
    if args.trace:
        traced = traced_window(system, clips[n_clips % len(clips)],
                               decode_in_window, cuda)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    # -- correctness ------------------------------------------------------
    diff: Dict = {}
    for c, k in kept.items():
        if "decoded" not in k:
            k["decoded"] = system.decode(k["stream"])
        again, k["batches"] = arch.capture_decode(system, k["stream"])
        # The decode of the window and the one that recorded the symbols
        # must both equal the encoder's reconstruction.
        twice = differing(k["encoder"], again)
        for j, n in differing(k["encoder"], k["decoded"]).items():
            diff[c, j] = n + twice[j]
    del system, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tally = arch.judge(weights_dir, config, traffic, kept, waves, specs,
                       dev)
    numbers = {"decode_vs_encoder_px": float(sum(diff.values())),
               **tally.numbers()}
    checks, correct = verdict(numbers, limits)
    failed = sum(1 for n in diff.values() if n)

    # -- result -----------------------------------------------------------
    want = man.metrics(cell["name"], traced=bool(args.trace))
    out_metrics: Dict[str, Dict] = {}
    ctx = {"cell": cell, "config": config, "traffic": traffic,
           "window": {"encode_s": enc_s, "decode_s": dec_s,
                      "frames": n_frames, "frames_by_type": by_type,
                      "clips": n_clips, "latencies_ms": lat,
                      "finish_s": sum(t1 - t0 for n, t0, t1, _ in records
                                      if n == "finish")},
           "trace": traced, "frame_flops": arch.frame_flops,
           "peak_flops": PEAK_FLOPS, "hbm_bytes_s": HBM_BYTES_S,
           "load": lambda rel: load_file(man.dir / rel)}
    for m in want:
        if args.trace:
            v = man.reader(m["name"]).read(ctx)
        else:
            # An end-to-end metric is named by its quantity, with a tag
            # after the first dot for a group of cells with a bound of
            # its own ("encode_fps.fp32").
            v = metrics.get(m["name"].split(".", 1)[0])
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    # Attempted: the frames the window encoded; failed: those of the judged
    # clips whose decode is not the encoder's reconstruction.
    result = {"correct": bool(correct), "attempted": n_frames,
              "failed": failed, "metrics": out_metrics, "device": device_info}
    if traced is not None:
        parts = [t for t in (traced.get("encode"), traced.get("decode")) if t]
        device_info["busy_s"] = sum(t["busy_s"] for t in parts)
        device_info["window_s"] = sum(t["window_s"] for t in parts)
        result["breakdown"] = {"device_ops": tr.top_ops(parts),
                               "idle_gaps": tr.idle_gaps(parts)}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"codecbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print_checks(checks)
    print(json.dumps(result))
    return 0
