"""Stochastic weight averaging over shelved training snapshots (the port
of scripts/swa.py).

Long training legs oscillate between snapshots, so promoting the best
snapshot by held-out eval picks an outlier of an oscillating process;
the uniform average of the snapshots sits nearer the centre of the basin
(Izmailov et al., SWA).  The sum is taken in float64 and each leaf cast
back to the first snapshot's dtype; snapshots of different model configs
are refused.

Host-only surgery on the checkpoints' numpy trees, in flax's layout
(utils/checkpoint.py:read_tree), written back by save_tree: the files the
JAX script writes, byte for byte.  Touches no device.

    python -m aivc_tpu_torch.scripts.swa --out models_ckpt/bf16-r6-swa \\
        models_ckpt/bf16-r6-s4000 models_ckpt/bf16-r6-s6000 ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.swa",
        description="uniform average of training snapshots")
    ap.add_argument("ckpts", nargs="+",
                    help="snapshot dirs to average (uniform weights)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from aivc_tpu_torch.utils.checkpoint import read_tree, save_tree

    cfg0 = tmpl = acc = None
    for ck in args.ckpts:
        cfg, params = read_tree(ck)
        if cfg0 is None:
            cfg0, tmpl = cfg, params
        elif cfg.to_json() != cfg0.to_json():
            raise SystemExit(f"config mismatch: {ck} differs from "
                             f"{args.ckpts[0]} — refusing to average "
                             f"across model configs")
        # float64 on the host: averaging float32 trees in float32 loses
        # the low bits the average exists to find.
        flat = tree_map(lambda x: np.asarray(x, np.float64), params)
        acc = flat if acc is None else tree_map(np.add, acc, flat)
        print(f"  + {ck}")
    n = len(args.ckpts)
    avg = tree_map(lambda s, t: np.asarray(s / n, t.dtype), acc, tmpl)
    save_tree(args.out, cfg0, avg)
    print(f"averaged {n} snapshots -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
