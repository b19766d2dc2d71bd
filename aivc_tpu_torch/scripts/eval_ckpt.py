"""Checkpoint quality on held-out clips (the port of scripts/eval_ckpt.py).

Encodes and decodes a fixed set of held-out clips through the real
bitstream (FrameCodec, encode_video, decode_video) at several rate
indices, and prints bpp / PSNR / MS-SSIM per rate, ``--per_clip`` rows
with the inter frames' mean alpha, and a summary line (mean PSNR at mean
bpp), with the JAX script's keys and rounding.  Used to compare
checkpoints before one is promoted; ``bd_from_eval`` turns two runs'
rows into BD deltas.

Beyond the JAX script, every decode is held bit for bit against its
encoder's reconstruction (as eval/golden.py does): a drifting decode
raises instead of being scored.

    python -m aivc_tpu_torch.scripts.eval_ckpt --ckpt models_ckpt/bf16-r5 \\
        [--ckpt ...] [--h 240 --w 416] [--frames 9] [--rates 0,3,6] [--cpu]

It runs on the card; ``--cpu`` runs on the host.  With no card and no
``--cpu`` it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

import numpy as np

from aivc_tpu_torch.scripts import pick_device


def in_dist_clips(n_clips: int, n_frames: int, h: int, w: int):
    """The round-1 clips: ``n_clips - 1`` clips of the training generator
    (train/data.py:make_batch with the photo pool, seeds 1_000_000 + s,
    its RGB channels taken as YUV) and the synthetic sinusoid of seed
    777; with their names."""
    from aivc_tpu_torch.pipeline.video import synthetic_frames
    from aivc_tpu_torch.train.data import make_batch, photo_pool

    photos = photo_pool() if n_clips > 1 else ()
    clips = []
    for s in range(n_clips - 1):
        rng = np.random.default_rng(1_000_000 + s)
        batch = make_batch(rng, n_frames, 1, max(h, w), photos)
        frames = []
        for t in range(n_frames):
            rgbish = batch[t, 0, :h, :w]
            y = np.clip(np.round(rgbish[..., 0] * 255), 0,
                        255).astype(np.uint8)
            u = np.clip(np.round(rgbish[::2, ::2, 1] * 255), 0,
                        255).astype(np.uint8)
            v = np.clip(np.round(rgbish[::2, ::2, 2] * 255), 0,
                        255).astype(np.uint8)
            frames.append({"y": y, "u": u[: (h + 1) // 2, : (w + 1) // 2],
                           "v": v[: (h + 1) // 2, : (w + 1) // 2]})
        clips.append(frames)
    clips.append(synthetic_frames(n_frames, h, w, seed=777))
    names = [f"train_gen_{1_000_000 + s}" for s in range(n_clips - 1)]
    return clips, names + ["sinusoid"]


def heldout_clips(n_clips: int, n_frames: int, h: int, w: int,
                  in_dist: bool = False) -> Tuple[List, List[str]]:
    """(clips, names): the first ``n_clips`` out-of-generator families of
    eval/clips.py (0: all of them), or with ``in_dist`` the round-1
    clips (``in_dist_clips``)."""
    if in_dist:
        return in_dist_clips(n_clips, n_frames, h, w)
    from aivc_tpu_torch.eval import clips as eval_clips

    names = list(eval_clips.FAMILIES)[:n_clips] if n_clips else None
    return (eval_clips.heldout_clips(n_frames, h, w, names),
            names or list(eval_clips.FAMILIES))


def coding_for(kind: str, gop_size: int, idx_rate: float):
    """The CodingConfig of a run: RA with intra period = GOP, LDP with
    intra period = GOP, or AI."""
    from aivc_tpu_torch.config import CodingConfig

    if kind == "RA":
        return CodingConfig(coding_config="RA", gop_size=gop_size,
                            intra_period=gop_size, idx_rate=idx_rate)
    if kind == "LDP":
        return CodingConfig(coding_config="LDP", intra_period=gop_size,
                            idx_rate=idx_rate)
    return CodingConfig(coding_config="AI", idx_rate=idx_rate)


def check_decode(frames, dec, recon, what: str) -> None:
    """Raise unless ``dec`` holds every frame of the clip, equal bit for
    bit to the encoder's reconstruction ``recon``."""
    if sorted(dec) != list(range(len(frames))):
        raise RuntimeError(f"{what}: decoded frames {sorted(dec)}")
    for i in range(len(frames)):
        for c in ("y", "u", "v"):
            if not np.array_equal(dec[i][c], recon[i][c]):
                raise RuntimeError(f"{what}: decoded frame {i} plane {c} "
                                   "differs from the encoder's "
                                   "reconstruction")


def evaluate(ckpt: str, clips, clip_names, rates, args, device,
             emit=print) -> Tuple[List[Dict], Dict]:
    """One checkpoint over the clips at each rate: emits the per-clip
    rows where ``args.per_clip``, each rate's summary row and the mean
    line; returns (summary rows, mean line)."""
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import (
        decode_video,
        encode_video,
        evaluate_frames,
    )
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(ckpt, device=device)
    codec = FrameCodec(cfg, model, args.h, args.w, device=device)
    summary = []
    for r in rates:
        coding = coding_for(args.coding, args.gop_size, r)
        bpps, psnrs, mss = [], [], []
        for cname, frames in zip(clip_names, clips):
            res = encode_video(codec, frames, coding,
                               wave_batch=args.wave_batch)
            dec = decode_video(codec, res.bitstream)
            check_decode(frames, dec, res.decoded_frames,
                         f"{ckpt} {cname} idx_rate {r}")
            m = evaluate_frames(frames, dec, device=device)
            bpps.append(res.total_bytes * 8.0
                        / (args.h * args.w * len(frames)))
            psnrs.append(m["psnr"])
            mss.append(m["ms_ssim"])
            if args.per_clip:
                # alpha over the inter frames only: I-frames report 1.0.
                inter_a = [fr.alpha_mean for fr in res.frame_results
                           if fr.frame_type != 0]
                emit(json.dumps({
                    "ckpt": ckpt, "clip": cname, "idx_rate": r,
                    "bpp": round(float(bpps[-1]), 4),
                    "psnr": round(float(m["psnr"]), 3),
                    "ms_ssim": round(float(m["ms_ssim"]), 5),
                    "alpha_mean": round(float(np.mean(inter_a)), 4)
                    if inter_a else 1.0}))
        row = {"ckpt": ckpt, "coding": args.coding, "idx_rate": r,
               "bpp": round(float(np.mean(bpps)), 4),
               "psnr": round(float(np.mean(psnrs)), 3),
               "ms_ssim": round(float(np.mean(mss)), 5)}
        summary.append(row)
        emit(json.dumps(row))
    mean = {
        "ckpt": ckpt,
        "mean_bpp": round(float(np.mean([r["bpp"] for r in summary])), 4),
        "mean_psnr": round(float(np.mean([r["psnr"] for r in summary])), 3),
        "mean_ms_ssim": round(
            float(np.mean([r["ms_ssim"] for r in summary])), 5),
    }
    emit(json.dumps(mean))
    return summary, mean


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.eval_ckpt",
        description="checkpoint quality on held-out clips")
    ap.add_argument("--ckpt", action="append", default=[],
                    help="checkpoint dir (repeatable)")
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=416)
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--clips", type=int, default=0,
                    help="limit clip count (0 = every held-out family)")
    ap.add_argument("--in_dist", action="store_true",
                    help="round-1 behaviour: clips from the TRAINING "
                         "generator (disjoint seeds) instead of the "
                         "out-of-generator families")
    ap.add_argument("--per_clip", action="store_true",
                    help="also print one row per clip family")
    ap.add_argument("--gop_size", type=int, default=8)
    ap.add_argument("--coding", default="RA", choices=["RA", "LDP", "AI"],
                    help="coding structure (LDP: gop_size P-frames per "
                         "intra period)")
    ap.add_argument("--rates", default="0,3,6")
    ap.add_argument("--wave_batch", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    rates = [float(r) for r in args.rates.split(",")]
    clips, clip_names = heldout_clips(args.clips, args.frames, args.h,
                                      args.w, in_dist=args.in_dist)
    for ckpt in args.ckpt or ["models_ckpt/bf16-r5"]:
        evaluate(ckpt, clips, clip_names, rates, args, device,
                 emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
