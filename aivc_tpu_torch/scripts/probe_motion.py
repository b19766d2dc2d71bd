"""Probe a checkpoint's motion maps: raw flow magnitudes and the
alpha / beta logits (the port of scripts/probe_motion.py).

Decides whether turning ModelConfig.flow_bound on (softsign-bounded
flows, sigmoid alpha / beta; models/fullnet.py:mofnet_maps) is close to
a no-op for trained parameters: if |raw flow| stays well below the bound
and the logits are small, the bounded maps are near the ones the
parameters were trained under.  For the first 4 held-out families (5
frames each), MOFNet codes frame 2 as a B-frame between frames 0 and 4
at each rate, on frames edge-padded to multiples of 64, and the
percentiles of |raw flow| (channels 2-5 of its 6-channel output), |alpha
logit| (0) and |beta logit| (1) are printed.

Stated departure: the JAX script hands MOFNet the uint8 planes without
scaling them to [0, 1], unlike every coding path of both packages
(aivc_tpu/pipeline/codec.py divides by 255), so its numbers describe
inputs 255 times too large.  The port feeds MOFNet the frames as the
codec does (pipeline/video.py:frames_444).

    python -m aivc_tpu_torch.scripts.probe_motion \\
        --ckpt models_ckpt/bf16-r5 [--cpu]

It runs on the card; ``--cpu`` runs on the host.  With no card and no
``--cpu`` it exits 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from aivc_tpu_torch.scripts import pick_device

PERCENTILES = (50, 90, 99, 99.9, 100)


def probe(model, clips, rates, device) -> Dict[str, np.ndarray]:
    """{raw_flow, logit_a, logit_b: percentiles PERCENTILES of the
    absolute values over every clip and rate}."""
    import torch

    from aivc_tpu_torch.config import FRAME_B
    from aivc_tpu_torch.pipeline.video import frames_444

    stats = {"raw_flow": [], "logit_a": [], "logit_b": []}
    with torch.no_grad():
        for clip in clips:
            prev, cur, nxt = frames_444([clip[0], clip[2], clip[4]], device)
            for r in rates:
                out6, _ = model.mofnet(torch.cat([cur, prev, nxt], dim=1),
                                       torch.cat([prev, nxt], dim=1), r,
                                       FRAME_B)
                out6 = out6.float().abs().cpu().numpy()
                stats["logit_a"].append(out6[:, 0].ravel())
                stats["logit_b"].append(out6[:, 1].ravel())
                stats["raw_flow"].append(out6[:, 2:6].ravel())
    return {k: np.percentile(np.concatenate(v), PERCENTILES)
            for k, v in stats.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.probe_motion",
        description="raw flow and alpha/beta logit percentiles of MOFNet")
    ap.add_argument("--ckpt", default="models_ckpt/bf16-r4-cand")
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=416)
    ap.add_argument("--rates", default="0,3,6")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2

    from aivc_tpu_torch.eval.clips import FAMILIES, heldout_clips
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(args.ckpt, device=device)
    print(f"ckpt {args.ckpt}: flow_bound={cfg.flow_bound} "
          f"ac_max_val={cfg.ac_max_val} gdn_clamp={cfg.mofnet.gdn_clamp}")
    q = probe(model, heldout_clips(5, args.h, args.w, list(FAMILIES)[:4]),
              [float(x) for x in args.rates.split(",")], device)
    for k, v in q.items():
        print(f"{k:9s} p50 {v[0]:.3f}  p90 {v[1]:.3f}  p99 {v[2]:.3f}  "
              f"p99.9 {v[3]:.3f}  max {v[4]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
