"""Rate-distortion sweep: encode at every rate index, one row per point
(the port of scripts/rd_sweep.py).

The clip is a raw YUV (``--input``), a held-out family of eval/clips.py
(``--family``) or the synthetic sinusoid of pipeline/video.py.  One
FrameCodec with the rate-priority K policy (the per-frame rANS flush
stays ~1% of the payload at every rate) codes one warm-up GOP at the
first rate, unrecorded, then the clip at each rate, fractional rates
included (ops/gain.py:interpolate_gain).  Each row: idx_rate, bpp,
bytes, psnr, ms_ssim, ms_ssim_db, enc_fps, and with ``--rate_audit``
analytic_bits and container_overhead_pct.  Then the line
{"sweep_wall_s", "procs", "kernel_launches"}: the last key, which the
JAX script does not print, holds the CUDA kernels' launches of the sweep
(summed over the workers with ``--procs``; zero on the host, where the
plain versions run).  ``--compare`` prints BD-rate, BD-PSNR and
BD-MS-SSIM(dB) of this sweep against an earlier sweep's JSONL.

``--procs N`` splits the rates into ``rates[i::N]`` and runs each subset
in a worker process of this module (each a standalone encode, so every
stream stays decodable on its own); a worker that fails raises with its
exit code.  Departure from the JAX script, which forces its workers onto
the CPU because one TPU chip cannot be shared: one H100 holds several
processes, so the workers run where the parent runs, the card unless
``--cpu``.  The parent builds the kernel library first, so the workers
load it instead of compiling it three times.  Each worker starts its own
K-policy history at its first rate, so where K moves (1080p) its rows
can differ in bytes from a sequential sweep's; with ``AIVC_VRANS_K``
pinned they are equal.

    python -m aivc_tpu_torch.scripts.rd_sweep --ckpt models_ckpt/bf16-r5 \\
        --input clip_1920x1080_30_420.yuv --rates 0,2.5,6 --rate_audit \\
        [--procs 3] [--compare old.jsonl] [--cpu]

It runs on the card; ``--cpu`` runs on the host.  With no card and no
``--cpu`` it exits 2.  ``--model`` (without ``--ckpt``) draws a random
model from torch.Generator seed 0, which JAX's PRNGKey(0) init does not
reproduce.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from aivc_tpu_torch.scripts import child_env, pick_device

# The CUDA kernels whose launches a sweep reports.
KERNELS = ("rans_encode", "rans_decode", "warp_packed")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.rd_sweep",
        description="rate-distortion sweep over the rate ladder")
    ap.add_argument("--input", default="",
                    help="raw .yuv (name_WxH_fps_420.yuv)")
    ap.add_argument("--family", default="",
                    help="use this held-out eval/clips.py family as the "
                         "clip instead of the synthetic sinusoid")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint dir (overrides --model)")
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--coding_config", default="RA")
    ap.add_argument("--gop_size", type=int, default=8)
    ap.add_argument("--intra_period", type=int, default=8)
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=416)
    ap.add_argument("--rates", default="", help="comma list; default all")
    ap.add_argument("--wave_batch", type=int, default=4)
    ap.add_argument("--compare", default="",
                    help="JSONL of a previous sweep; report BD-rate and "
                         "BD-PSNR of THIS sweep against it")
    ap.add_argument("--procs", type=int, default=0,
                    help="fan rate points out over N worker processes "
                         "(0 = sequential in-process); the workers run on "
                         "the parent's device")
    ap.add_argument("--rate_audit", action="store_true",
                    help="also report per-point container overhead: real "
                         "bytes vs analytic bits under the coder's own "
                         "CDFs")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    return ap


def all_rates(args) -> List[float]:
    """--rates, else every index of the checkpoint's ladder (3 for the
    random tiny model, 7 for the base one)."""
    if args.rates:
        return [float(r) for r in args.rates.split(",")]
    if args.ckpt:
        cfg_json = json.loads((Path(args.ckpt) / "config.json").read_text())
        return [float(i) for i in range(len(cfg_json["lambda_tradeoff"]))]
    return [float(i) for i in range(3 if args.model == "tiny" else 7)]


def load_model(args, device):
    """(cfg, FullNet): the checkpoint, or a random zoo model."""
    import torch

    from aivc_tpu_torch.config import ModelConfig
    from aivc_tpu_torch.models.zoo import TINY, init_fullnet
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    if args.ckpt:
        return load_checkpoint(args.ckpt, device=device)
    cfg = TINY if args.model == "tiny" else ModelConfig()
    return cfg, init_fullnet(cfg, torch.Generator().manual_seed(0),
                             device=device)


def load_clip(args):
    """(frames, h, w) of --input, --family or the synthetic sinusoid."""
    if args.input:
        from aivc_tpu_torch.io.yuv import YuvReader

        reader = YuvReader(args.input)
        n = min(args.frames, reader.n_frames)
        return ([reader.read_frame(i) for i in range(n)], reader.height,
                reader.width)
    if args.family:
        from aivc_tpu_torch.eval.clips import heldout_clips

        return (heldout_clips(args.frames, args.h, args.w,
                              names=[args.family])[0], args.h, args.w)
    from aivc_tpu_torch.pipeline.video import synthetic_frames

    return synthetic_frames(args.frames, args.h, args.w), args.h, args.w


def coding(args, idx_rate: float):
    from aivc_tpu_torch.config import CodingConfig

    return CodingConfig(coding_config=args.coding_config,
                        gop_size=args.gop_size,
                        intra_period=args.intra_period, idx_rate=idx_rate)


def point(idx_rate: float, res, frames, metrics, n_pix: int,
          audit: bool) -> Dict:
    """One row of the sweep, rounded as the JAX script rounds it."""
    row = {
        "idx_rate": idx_rate,
        "bpp": round(res.total_bytes * 8 / (n_pix * len(frames)), 5),
        "bytes": res.total_bytes,
        "psnr": round(float(metrics["psnr"]), 4),
        "ms_ssim": round(float(metrics["ms_ssim"]), 5),
        "ms_ssim_db": round(float(metrics["ms_ssim_db"]), 4),
        "enc_fps": round(res.fps, 3),
    }
    if audit:
        analytic = sum(fr.analytic_bits for fr in res.frame_results)
        real = sum(fr.bytes for fr in res.frame_results) * 8.0
        row["analytic_bits"] = round(analytic, 1)
        row["container_overhead_pct"] = round(
            100.0 * (real - analytic) / max(analytic, 1e-9), 3)
    return row


def sweep(args, device, emit=print, keep: bool = False):
    """The sequential sweep in this process: the warm-up GOP, then one
    row per rate, each emitted as it is made, then the wall line.
    Returns (rows, wall line, the EncodeResults where ``keep``, else
    None)."""
    from aivc_tpu_torch import kernels
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import encode_video, evaluate_frames

    cfg, model = load_model(args, device)
    frames, h, w = load_clip(args)
    codec = FrameCodec(cfg, model, h, w, device=device, rate_priority=True,
                       audit=args.rate_audit)
    rates = all_rates(args)
    # Warm-up: every rate shares the codec, so one unrecorded pass over
    # a GOP's frames takes the first use of each conv shape out of every
    # row's enc_fps.
    encode_video(codec, frames[:min(len(frames), args.gop_size + 1)],
                 coding(args, rates[0]), wave_batch=args.wave_batch)
    kernels.reset_launches()
    t0 = time.time()
    rows, results = [], []
    for idx_rate in rates:
        res = encode_video(codec, frames, coding(args, idx_rate),
                           wave_batch=args.wave_batch)
        metrics = evaluate_frames(frames, res.decoded_frames, device=device)
        rows.append(point(idx_rate, res, frames, metrics, h * w,
                          args.rate_audit))
        emit(json.dumps(rows[-1]))
        if keep:
            results.append(res)
    wall = {"sweep_wall_s": round(time.time() - t0, 2), "procs": 1,
            "kernel_launches": {k: kernels.LAUNCHES[k] for k in KERNELS}}
    emit(json.dumps(wall))
    return rows, wall, results if keep else None


def worker_argv(args, rates: List[float]) -> List[str]:
    """The command line of one worker: this module on ``rates``, with
    the parent's clip, model, coding and device flags."""
    argv = [sys.executable, "-m", "aivc_tpu_torch.scripts.rd_sweep",
            "--procs", "0"]
    if args.cpu:
        argv += ["--cpu"]
    for flag in ("input", "model", "ckpt", "coding_config", "family"):
        argv += [f"--{flag}", str(getattr(args, flag))]
    if args.rate_audit:
        argv += ["--rate_audit"]
    for flag in ("frames", "gop_size", "intra_period", "h", "w",
                 "wave_batch"):
        argv += [f"--{flag}", str(getattr(args, flag))]
    return argv + ["--rates", ",".join(str(r) for r in rates)]


def fan_out(args, device, emit=print):
    """The sweep over ``args.procs`` worker processes: rates[i::N] each,
    rows sorted by rate, then the wall line with the workers' launches
    summed.  Every worker is waited for; one that failed raises with
    its exit code.  Returns (rows, wall line)."""
    if device.type == "cuda":
        from aivc_tpu_torch import kernels

        kernels.lib()
    rates = all_rates(args)
    subsets = [rates[i::args.procs] for i in range(args.procs)]
    t0 = time.time()
    procs = [subprocess.Popen(worker_argv(args, sub), stdout=subprocess.PIPE,
                              text=True, env=child_env())
             for sub in subsets if sub]
    outs = [p.communicate()[0] for p in procs]
    for p in procs:
        if p.returncode != 0:
            raise RuntimeError(f"sweep worker failed (rc {p.returncode})")
    rows, launches = [], dict.fromkeys(KERNELS, 0)
    for out in outs:
        for ln in out.splitlines():
            if not ln.startswith("{"):
                continue
            obj = json.loads(ln)
            if "idx_rate" in obj:
                rows.append(obj)
            elif "kernel_launches" in obj:
                for k, n in obj["kernel_launches"].items():
                    launches[k] += n
    rows.sort(key=lambda r: r["idx_rate"])
    for row in rows:
        emit(json.dumps(row))
    wall = {"sweep_wall_s": round(time.time() - t0, 2), "procs": args.procs,
            "kernel_launches": launches}
    emit(json.dumps(wall))
    return rows, wall


def compare(ref_path: str, rows: List[Dict]) -> Dict:
    """BD-rate and BD-PSNR of ``rows`` against the sweep in ``ref_path``,
    and BD-MS-SSIM(dB) from the rows' ms_ssim_db."""
    from aivc_tpu_torch.ops.bd_metrics import bd_psnr, bd_rate

    with open(ref_path) as f:
        ref = [json.loads(line) for line in f
               if line.strip().startswith("{") and "idx_rate" in line]
    ref_rd = [(r["bpp"], r["psnr"]) for r in ref]
    test_rd = [(r["bpp"], r["psnr"]) for r in rows]
    out = {"bd_rate_pct_vs_ref": round(bd_rate(ref_rd, test_rd), 3),
           "bd_psnr_db_vs_ref": round(bd_psnr(ref_rd, test_rd), 4)}
    ref_ms = [(r["bpp"], r["ms_ssim_db"]) for r in ref]
    test_ms = [(r["bpp"], r["ms_ssim_db"]) for r in rows]
    out["bd_msssim_db_vs_ref"] = round(bd_psnr(ref_ms, test_ms), 4)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    emit = lambda s: print(s, flush=True)  # noqa: E731
    if args.procs > 1:
        rows, _ = fan_out(args, device, emit)
    else:
        rows, _, _ = sweep(args, device, emit)
    if args.compare:
        emit(json.dumps(compare(args.compare, rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
