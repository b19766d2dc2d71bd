"""Where the time of kernels K1 (rANS encode), K3 (packed warp) and K5
(float warp with vertical clamp) goes on the card, for this checkout or
another one, run on demand.

    python aivc_tpu_torch/profile_kernels.py [--tree DIR]

``--tree`` (default: this checkout) puts DIR first on the import path, so
the kernels of another checkout of the port (an older commit unpacked
with ``git archive``) are measured by this script's own code: the same
inputs, the same timers.  Their wrappers' contract (``encode_cuda``,
``warp_packed_cuda``, ``warp_vclamped_cuda``) is the same in every commit
since each kernel was ported.  Run it for two trees in turns (a, b, b, a)
in one machine to compare them.

On the inputs of chip_smoke.py (the dense 4-chunk 1080p B-wave of
smoke.fused_inputs with bf16-r5's table; 4 frames of 1088x1920 with
random flows, |flow| < flow_bound; K5 on smoke.check_warp_vclamped's
1 x 3 x 768 x 1280 frame with random flows of +-40 / +-30, and on the
(x, flow) of the first B-frame launch of K5 in the 720p RD forward of
bf16-r5, captured here from the tree's own forward), each kernel is first
held bit for bit against its plain version, then timed six ways:

* ``device_us``: the device time of each launch of one call, by kernel
  name, under torch.profiler (mean of REPS calls), and their sum;
* ``cold_us``: the same with L2 cold: each call follows a write of
  FLUSH_BYTES that is read back (l2_flush), whose kernels are left out;
  ``cold_write_us`` with the write alone, which leaves L2 full of dirty
  lines that the call then writes back as it evicts them;
* ``events_ms``: CUDA events around REPS calls queued back to back
  (chip_smoke.py's timer before it hid the host);
* ``hidden_ms``: the same with the card asleep first for twice the host's
  time to queue the calls (chip_smoke.py's timer, smoke.time_ms with
  hide_host), so the events bracket the card's own time;
* ``host_us``: the host time of one wrapper call, the card kept busy so
  that the host never waits on it.

Prints the card's name and power limit and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "bf16-r5"
REPS = 20
# Cycles of torch.cuda._sleep per second: the H100's top SM clock, so a
# sleep lasts at least as long as asked (as smoke.SLEEP_CYCLES_PER_S).
SLEEP_CYCLES_PER_S = 1.98e9
# Bytes written (and read back) between two launches timed with L2 cold:
# 5x the H100's 50 MB L2.
FLUSH_BYTES = 256 << 20
# The 720p forward of chip_smoke.py and the K5 launch captured from it:
# 1_GOP_8 runs I0, P8 (launch 0), B4 (launches 1 and 2), ... in coding
# order, so launch 1 is the first B-frame's (smoke.first_b_warp).
FWD_H, FWD_W, FWD_FRAMES, K5_LAUNCH = 720, 1280, 9, 1


def _kernel_times(prof, reps: int) -> Dict[str, float]:
    by_name: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^.*::|\(.*$", "", e.name)
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / reps
    return by_name


def device_us(fn, reps: int = REPS, before=None) -> Dict[str, float]:
    """Mean device microseconds per call of fn, by kernel name, under
    torch.profiler; {"error": ...} where it records no device time.  With
    ``before``, each call follows one of before(), whose own kernels (by
    name, from a profile of before() alone) are left out."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    skip = set()
    if before is not None:
        with profile(activities=acts) as prof:
            before()
            torch.cuda.synchronize()
        skip = set(_kernel_times(prof, 1))
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    by_name = {k: v for k, v in _kernel_times(prof, reps).items()
               if k not in skip}
    if not by_name:
        return {"error": "the profiler recorded no device events"}
    by_name["total"] = sum(by_name.values())
    return by_name


def l2_flush(read: bool = True):
    """A callable that makes the card's L2 cold: it writes FLUSH_BYTES
    and, with ``read``, reads them back, so that L2 then holds only clean
    lines of other data.  Without the read it holds up to 50 MB of dirty
    lines, whose write-back the next kernel pays as it evicts them."""
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flush():
        buf.fill_(1)
        if read:
            buf.sum(dtype=torch.int32)

    return flush


def events_ms(fn, reps: int = REPS, hide_host: bool = False) -> float:
    """Mean milliseconds per call between CUDA events around reps calls;
    with ``hide_host`` the card first sleeps for twice the host's time to
    queue them."""
    fn()
    torch.cuda.synchronize()
    if hide_host:
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * host_s * reps * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = REPS) -> float:
    """Mean host microseconds of one call of fn, queued behind a sleep of
    the card that outlasts the calls."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * SLEEP_CYCLES_PER_S))
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def timings(fn) -> Dict:
    return {"device_us": device_us(fn),
            "cold_us": device_us(fn, before=l2_flush()),
            "cold_write_us": device_us(fn, before=l2_flush(read=False)),
            "events_ms": events_ms(fn),
            "hidden_ms": events_ms(fn, hide_host=True),
            "host_us": host_us(fn)}


def capture_k5(warp_ops, run, at: int):
    """The (x, flow) of K5's launch number ``at`` (from 0) in run()."""
    kernel, seen = warp_ops.warp_vclamped_cuda, []

    def watch(x, flow):
        seen.append((x.clone(), flow.clone()) if len(seen) == at else None)
        return kernel(x, flow)

    warp_ops.warp_vclamped_cuda = watch
    try:
        run()
    finally:
        warp_ops.warp_vclamped_cuda = kernel
    if len(seen) <= at:
        raise AssertionError(f"K5 launched {len(seen)} times, not {at + 1}")
    return seen[at]


def k5_record(warp_ops, x, flow) -> Dict:
    """K5 on (x, flow), bit for bit against the plain version, timed."""
    run = lambda: warp_ops.warp_vclamped_cuda(x, flow)  # noqa: E731
    if not torch.equal(run().view(torch.int32),
                       warp_ops.warp_vclamped(x, flow).view(torch.int32)):
        raise AssertionError("K5 differs from the plain warp")
    return {"shape": list(x.shape),
            "max_u": float(flow[:, 0].abs().max()),
            "max_v": float(flow[:, 1].abs().max()),
            "clamped_share": float((flow[:, 1].abs() > warp_ops.V_RADIUS - 1)
                                   .float().mean()),
            **timings(run)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose kernels are measured")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    # The tree's package, not this file's directory, answers the imports.
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(tree))
    # Read when the warp module is imported: the float warp takes K5.
    os.environ["AIVC_WARP"] = "pallas"
    from aivc_tpu_torch import kernels, smoke
    from aivc_tpu_torch.coding import vrans
    from aivc_tpu_torch.ops import warp as warp_ops
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import frames_444, synthetic_frames
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    if not kernels.__file__.startswith(str(tree)):
        raise RuntimeError(f"imported {kernels.__file__}, not from {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    t0 = time.time()
    kernels.lib()
    nvcc_s = time.time() - t0
    cfg, model = load_checkpoint(str(CKPT), device=dev)
    codec = FrameCodec(cfg, model, 1080, 1920, device=dev)
    sym, rows, k, segs = smoke.fused_inputs(codec, 4)
    table = codec.table
    enc = lambda: vrans.encode_cuda(sym, rows, table, k, segs)  # noqa: E731
    (buf, st, seg_g), (pbuf, pst, pseg) = enc(), vrans.encode_plain(
        sym, rows, table, k, segs)
    if not (torch.equal(st, pst) and torch.equal(seg_g, pseg) and all(
            torch.equal(buf[i, s:], pbuf[i, s:])
            for i, s in enumerate(seg_g[:, 0].tolist()))):
        raise AssertionError("K1 differs from the plain encode")
    # check_warp's input: seed 0, frames then u then v.
    g = torch.Generator(device="cpu").manual_seed(0)
    fb = int(-(-cfg.flow_bound // 1))
    shape = (4, codec.hp, codec.wp)
    packed = torch.randint(0, 1 << 24, shape, generator=g,
                           dtype=torch.int32).to(dev)
    u = ((torch.rand(shape, generator=g) * 2 - 1) * fb).to(dev)
    v = ((torch.rand(shape, generator=g) * 2 - 1) * fb).to(dev)
    wrp = lambda: warp_ops.warp_packed_cuda(packed, u, v)  # noqa: E731
    if not torch.equal(wrp().view(torch.int32),
                       warp_ops.warp_packed(packed, u, v).view(torch.int32)):
        raise AssertionError("K3 differs from the plain warp")
    f444 = frames_444(synthetic_frames(FWD_FRAMES, FWD_H, FWD_W, seed=3),
                      dev)
    # check_warp_vclamped's input at the padded frame's size: seed 0, the
    # frame then the flow.
    shape5 = (1, 3) + tuple(f444[0].shape[2:])
    g = torch.Generator(device="cpu").manual_seed(0)
    x5 = torch.rand(shape5, generator=g).to(dev)
    flow5 = ((torch.rand((1, 2) + shape5[2:], generator=g) * 2 - 1)
             * torch.tensor([40.0, 30.0]).view(1, 2, 1, 1)).to(dev)
    fcfg, fmodel = load_checkpoint(str(CKPT), device=dev)
    cap = capture_k5(warp_ops, lambda: smoke.rd_forward(
        fmodel, fcfg, f444, 0.0), K5_LAUNCH)
    print(json.dumps({"tree": str(tree), "smi": smi, "nvcc_s": nvcc_s,
                      "k1": {"steps": sym.shape[1] // k, **timings(enc)},
                      "k3": {"shape": list(shape), **timings(wrp)},
                      "k5_random": k5_record(warp_ops, x5, flow5),
                      "k5_forward": k5_record(warp_ops, *cap)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
