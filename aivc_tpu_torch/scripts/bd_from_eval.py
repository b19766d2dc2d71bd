"""Bjontegaard deltas between two eval_ckpt runs (the port of
scripts/bd_from_eval.py).

Reads two files of eval_ckpt JSON lines (the per-rate summary rows:
{"ckpt", "idx_rate", "bpp", "psnr", "ms_ssim"}), treats each as an RD
curve over the rate indices they hold, and prints BD-rate / BD-PSNR /
BD-MS-SSIM(dB) of TEST vs REF, so that a checkpoint's promotion is
decided on the held-out content eval_ckpt measures.  Pure Python and
numpy (ops/bd_metrics.py); touches no device.

    python -m aivc_tpu_torch.scripts.bd_from_eval --ref v3_eval.jsonl \\
        --test r2_eval.jsonl
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List

from aivc_tpu_torch.ops.bd_metrics import bd_psnr, bd_rate


def load_rows(path: str, ckpt: str = "") -> List[Dict]:
    """Per-rate summary rows of ONE checkpoint, the last row of each rate
    index, in index order.

    A file may hold rows of several checkpoints (eval_ckpt runs append);
    one curve made of two models' points would give wrong deltas
    silently, so such a file needs ``ckpt`` to pick one."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            if "idx_rate" in r and "bpp" in r and "clip" not in r:
                rows.append(r)
    ckpts = sorted({r.get("ckpt", "") for r in rows})
    if ckpt:
        rows = [r for r in rows if r.get("ckpt", "") == ckpt]
        if not rows:
            raise SystemExit(
                f"no rows for ckpt={ckpt!r} in {path} (has: {ckpts})")
    elif len(ckpts) > 1:
        raise SystemExit(
            f"{path} mixes rows from {len(ckpts)} checkpoints {ckpts}; "
            f"pick one with --ref_ckpt/--test_ckpt")
    if not rows:
        raise SystemExit(f"no per-rate summary rows in {path}")
    by_idx = {}
    for r in rows:
        by_idx[r["idx_rate"]] = r
    return [by_idx[i] for i in sorted(by_idx)]


def msssim_db(r: Dict) -> float:
    return -10.0 * math.log10(max(1.0 - r["ms_ssim"], 1e-12))


def deltas(ref: List[Dict], test: List[Dict], ref_name: str = "",
           test_name: str = "") -> Dict:
    """The printed object: BD-rate (or why it is undefined: curves whose
    qualities do not overlap have no BD-rate integral), BD-PSNR,
    BD-MS-SSIM(dB), and the two checkpoints' names."""
    try:
        bdr = round(bd_rate(
            [(r["bpp"], r["psnr"]) for r in ref],
            [(r["bpp"], r["psnr"]) for r in test]), 3)
    except ValueError as e:
        bdr = f"undefined ({e})"
    return {
        "bd_rate_pct_vs_ref": bdr,
        "bd_psnr_db_vs_ref": round(bd_psnr(
            [(r["bpp"], r["psnr"]) for r in ref],
            [(r["bpp"], r["psnr"]) for r in test]), 4),
        "bd_msssim_db_vs_ref": round(bd_psnr(
            [(r["bpp"], msssim_db(r)) for r in ref],
            [(r["bpp"], msssim_db(r)) for r in test]), 4),
        "ref": ref[0].get("ckpt", ref_name),
        "test": test[0].get("ckpt", test_name),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.bd_from_eval",
        description="BD-rate / BD-PSNR / BD-MS-SSIM of two eval_ckpt runs")
    ap.add_argument("--ref", required=True)
    ap.add_argument("--test", required=True)
    ap.add_argument("--ref_ckpt", default="",
                    help="select this 'ckpt' value when --ref mixes runs")
    ap.add_argument("--test_ckpt", default="",
                    help="select this 'ckpt' value when --test mixes runs")
    args = ap.parse_args(argv)
    out = deltas(load_rows(args.ref, args.ref_ckpt),
                 load_rows(args.test, args.test_ckpt), args.ref, args.test)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
