"""Low-rate specialist surgery: shift the gain ladder toward high
lambdas (the port of scripts/make_lowrate.py).

One checkpoint's 7-row gain ladder bottoms out near 0.10 bpp on the
240p held-out clips, where the reference's model zoo reaches ~0.02 bpp.
This tool derives a low-rate specialist from a trained flagship, to be
fine-tuned (ladder name 7, ``models_ckpt/bf16-lr``).  Per gain matrix
[N, C] (ops/gain.py:shift_gain_tree):

* row i <- |row i + shift| for i < N - shift: each surviving row keeps
  the weights trained for its lambda;
* the rows past the old ladder extrapolate geometrically, the step ratio
  raised to ``--tail_boost`` and clamped to [1/ratio_cap, ratio_cap];
* lambda_tradeoff <- old[shift:], extended geometrically by
  ``--lam_ratio`` or the median ratio of the old ladder's last three
  steps, each new lambda rounded to 6 decimals; the config's name becomes
  ``<name>-lr`` unless ``--name`` is given.

Host-only surgery on the checkpoint's numpy tree, in flax's layout
(utils/checkpoint.py:read_tree), written back by save_tree: the files the
JAX script writes, byte for byte.  Touches no device.

    python -m aivc_tpu_torch.scripts.make_lowrate --src models_ckpt/bf16-r5 \\
        --out models_ckpt/bf16-lr0 [--shift 3] [--lam_ratio 2.75]
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace
from typing import List

import numpy as np


def lowrate_ladder(lam: List[float], shift: int,
                   lam_ratio: float = 0.0) -> List[float]:
    """The specialist's lambdas: ``lam[shift:]`` extended to len(lam) by
    ``lam_ratio`` or the median ratio of the last three steps."""
    n = len(lam)
    ratios = [lam[i + 1] / lam[i] for i in range(n - 4, n - 1)]
    r = lam_ratio or float(np.median(ratios))
    new_lam = list(lam[shift:])
    while len(new_lam) < n:
        new_lam.append(round(new_lam[-1] * r, 6))
    return new_lam


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.make_lowrate",
        description="derive a low-rate specialist checkpoint")
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--shift", type=int, default=3)
    ap.add_argument("--lam_ratio", type=float, default=0.0,
                    help="per-step lambda ratio for the extrapolated "
                         "points (default: median ratio of the source "
                         "ladder's last three steps)")
    ap.add_argument("--ratio_cap", type=float, default=4.0,
                    help="per-step clamp on the extrapolated gain ratio")
    ap.add_argument("--tail_boost", type=float, default=1.0,
                    help="exponent on the extrapolation step (2.0 = two "
                         "trained-ladder steps per synthetic row)")
    ap.add_argument("--name", default="",
                    help="config name for the specialist (default "
                         "<src name>-lr)")
    args = ap.parse_args(argv)

    from aivc_tpu_torch.ops.gain import shift_gain_tree
    from aivc_tpu_torch.utils.checkpoint import read_tree, save_tree

    cfg, params = read_tree(args.src)
    lam = list(cfg.lambda_tradeoff)
    n = len(lam)
    if not (0 < args.shift < n):
        raise SystemExit(f"--shift must be in 1..{n - 1}")
    new_lam = lowrate_ladder(lam, args.shift, args.lam_ratio)
    params, n_gain = shift_gain_tree(params, args.shift, args.ratio_cap,
                                     args.tail_boost)
    new_cfg = replace(cfg, name=args.name or f"{cfg.name}-lr",
                      lambda_tradeoff=tuple(new_lam))
    save_tree(args.out, new_cfg, params)
    print(f"low-rate specialist -> {args.out}")
    print(f"  lambda ladder: {lam} -> {new_lam}")
    print(f"  gain matrices shifted: {n_gain} (shift {args.shift}, "
          f"extrapolation ratio cap {args.ratio_cap})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
