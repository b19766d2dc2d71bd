"""Gain-ladder smoothing surgery: rebuild selected gain rows from their
neighbours' geometric mean (the port of scripts/gain_smooth.py).

The rows of the multi-rate gain matrices are trained one ladder index at
a time, so one can end up a worse operating point than the model's own
geometric interpolation between its neighbours (bf16-r5's idx 1 sat
below both neighbours in MS-SSIM on the held-out suite).  Replacing row
r with sqrt(|row r-1| * |row r+1|) puts that index on the interpolation
path (ops/gain.py:interpolate_gain) and leaves every other index as it
was.

Host-only surgery on the checkpoint's numpy tree, in flax's layout
(utils/checkpoint.py:read_tree), written back by save_tree: the files the
JAX script writes, byte for byte.  Touches no device.

    python -m aivc_tpu_torch.scripts.gain_smooth \\
        --ckpt models_ckpt/bf16-r5 --out models_ckpt/bf16-r5-gs --rows 1
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def smooth_rows(tree, rows):
    """A copy of the parameter tree with each [N, C] *_gain leaf's
    ``rows`` replaced by the geometric mean of their neighbours (the
    whole leaf taken in absolute value, as the gains are used);
    returns (tree, number of leaves patched)."""
    n_patched = 0

    def visit(d):
        nonlocal n_patched
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = visit(v)
            elif k.endswith("_gain"):
                g = np.abs(np.asarray(v, np.float32))
                for r in rows:
                    if not 0 < r < g.shape[0] - 1:
                        raise ValueError(f"row {r} has no two neighbours")
                    g[r] = np.sqrt(g[r - 1] * g[r + 1])
                out[k] = g.astype(np.asarray(v).dtype)
                n_patched += 1
            else:
                out[k] = v
        return out

    return visit(tree), n_patched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.gain_smooth",
        description="rebuild gain-ladder rows from their neighbours")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rows", default="1",
                    help="comma-separated ladder rows to rebuild")
    args = ap.parse_args(argv)

    from aivc_tpu_torch.utils.checkpoint import read_tree, save_tree

    rows = [int(r) for r in args.rows.split(",")]
    cfg, params = read_tree(args.ckpt)
    params, n = smooth_rows(params, rows)
    if n == 0:
        raise SystemExit("no *_gain leaves found — wrong checkpoint?")
    save_tree(args.out, cfg, params)
    print(f"patched rows {rows} in {n} gain matrices -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
