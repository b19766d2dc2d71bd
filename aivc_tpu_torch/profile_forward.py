"""Where the RD forward's time goes on the card, run on demand.

    python -m aivc_tpu_torch.profile_forward [--height 720] [--width 1280]

Runs gop_rd_loss in eval mode (the forward phase of chip_smoke.py:
bf16-r5, a 9-frame 1_GOP_8 of synthetic frames, AIVC_WARP=pallas) once to
warm up, then times ROUNDS forwards, and one forward under
torch.profiler.  Prints one JSON object: the card's name and power
limit, the seconds of each forward, the profiled wall time, the device's
busy time (the union of its kernels' spans), the number of kernels
launched and those that took the most device time.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 5


def profile_call(fn, *args, top: int = 8) -> Dict:
    """One call of ``fn(*args)`` under torch.profiler, the card
    synchronized before and after: the wall time, device time by kernel
    (the top ones), the device's busy time and the number of kernels
    launched.  Returns {"error": ...} where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from aivc_tpu_torch.tracing import union_length

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn(*args)
        torch.cuda.synchronize()
    wall = time.time() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"error": "the profiler recorded no device events"}
    by_name: Dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union_length([(e.time_range.start, e.time_range.end)
                         for e in kern])
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "kernel_ms": sum(by_name.values()) / 1e3,
            "kernels": len(kern),
            "top": [(n[:60], t / 1e3) for n, t in ranked]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--idx_rate", type=float, default=0.0)
    args = ap.parse_args()
    os.environ["AIVC_WARP"] = "pallas"   # read when the package loads
    from aivc_tpu_torch import smoke
    from aivc_tpu_torch.pipeline.video import frames_444, synthetic_frames
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    dev = torch.device("cuda")
    cfg, model = load_checkpoint(ROOT / "models_ckpt" / "bf16-r5",
                                 device=dev)
    f444 = frames_444(synthetic_frames(9, args.height, args.width, seed=3),
                      dev)
    smoke.rd_forward(model, cfg, f444, args.idx_rate)        # warm-up
    secs = [smoke.rd_forward(model, cfg, f444, args.idx_rate)["seconds"]
            for _ in range(ROUNDS)]
    prof = profile_call(smoke.rd_forward, model, cfg, f444, args.idx_rate)
    out = {"card": smoke.device_info()["smi"],
           "frame": [args.width, args.height],
           "padded": list(f444[0].shape[2:]), "forward_s": secs,
           "mean_s": sum(secs) / len(secs), **prof}
    if "device_busy_ms" in prof:
        out["busy_share"] = prof["device_busy_ms"] / 1e3 / out["mean_s"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
