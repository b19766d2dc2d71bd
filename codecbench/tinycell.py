"""A copy of the benchmark with two tiny cells of 64x64 RA clips of 9
frames, for the host tests: the same harness, run on the CPU.
``tiny.ra`` runs the program's tiny-toy checkpoint; ``tiny.seeded`` the
same shapes with weights drawn from a seed (``"weights": {"seed": 7}``,
no checkpoint)."""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CELL = "tiny.ra"
SEEDED = "tiny.seeded"
WEIGHT_SEED = 7
LIMITS = {"decode_vs_encoder_px": 0, "latent_excess": 0.01,
          "latent_mismatch": 0.01, "recon_gap": 0.05, "dc_gap": 0}


def make(root: Path) -> Path:
    """The benchmark copied under ``root`` with the tiny cells added; the
    checkpoints and the program linked in."""
    root = Path(root)
    shutil.copytree(HERE, root / "codecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for n in ("models_ckpt", "aivc_tpu_torch"):
        os.symlink(REPO / n, root / n)
    d = root / "codecbench"
    ck = json.loads((REPO / "models_ckpt/tiny-toy/config.json").read_text())
    (d / "configs/tiny.json").write_text(json.dumps(
        {"name": "tiny", "architecture": "aivc",
         "checkpoint": "models_ckpt/tiny-toy", "peak_dtype": "float32",
         "model": ck}))
    (d / "configs/tiny-seeded.json").write_text(json.dumps(
        {"name": "tiny-seeded", "architecture": "aivc",
         "weights": {"seed": WEIGHT_SEED}, "peak_dtype": "float32",
         "model": ck}))
    t = json.loads((d / "traffic/ra1080.json").read_text())
    t.update(height=64, width=64, gop_size=4, intra_period=8, frames=9,
             wave_batch=2, families=["sinusoid", "wheel", "staticcam"],
             t0_max=4)
    (d / "traffic/tiny_ra.json").write_text(json.dumps(t))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, config in ((CELL, "tiny"), (SEEDED, "tiny-seeded")):
        (d / f"limits/{cell}.json").write_text(json.dumps(LIMITS))
        b["configs"].append({"name": config, "source": "tiny-toy",
                             "file": f"codecbench/configs/{config}.json",
                             "reduced": [], "why": "host tests"})
        b["workloads"].append({"name": cell, "config": config,
                               "traffic": "tiny_ra", "chips": 1,
                               "why": "host tests"})
        for m in b["end_to_end"] + b["per_layer"]:
            if "r5.ra1080" in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def run_tiny(root: Path, capsys, seed=3000000001, trace=0, device="cpu",
             break_system=None, cell=CELL):
    """One run of a tiny cell -> (exit code, result dict, stderr)."""
    from harness.bench import run
    rc = run(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
              "--trace", str(trace)], Path(root), time.perf_counter(),
             device=device, require_card=device != "cpu",
             break_system=break_system)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out.err
