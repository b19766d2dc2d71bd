"""The tiny benchmark copy of tinycell.py with one more cell for the host
tests: ``tiny.elic``, ELIC at a tiny size of its own (N 16, M 40, groups
2/2/4/8/24) on weights drawn from a seed (``"weights": {"seed": 7}``),
All-Intra 64 x 96 clips of 5 frames in waves of 2."""

from __future__ import annotations

import json
from pathlib import Path

import tinycell

CELL = "tiny.elic"
CONFIG = "tiny-elic"
MODEL = {"name": "elic-tiny", "arch": "elic", "n": 16, "m": 40,
         "groups": [2, 2, 4, 8, 24], "ctx_hidden": [12, 8],
         "agg_hidden": [24, 16], "dtype": "float32", "ac_max_val": 64}
# The analysis's last kernel scaled so that a good share of the tiny
# clips' y symbols is non-zero.
GAIN = 4.0
LIMITS = {**tinycell.LIMITS, "scale_mismatch": 0.01}


def make(root: Path) -> Path:
    """tinycell.make's copy under ``root`` with the ELIC cell added."""
    root = tinycell.make(root)
    d = root / "codecbench"
    (d / f"configs/{CONFIG}.json").write_text(json.dumps(
        {"name": CONFIG, "architecture": "elic",
         "weights": {"seed": tinycell.WEIGHT_SEED},
         "init": {"g_a_gain": GAIN}, "peak_dtype": "float32",
         "model": MODEL}))
    t = json.loads((d / "traffic/ai1080.json").read_text())
    t.update(height=64, width=96, frames=5, wave_batch=2,
             families=["sinusoid", "wheel", "staticcam"], t0_max=4)
    (d / "traffic/tiny_ai.json").write_text(json.dumps(t))
    (d / f"limits/{CELL}.json").write_text(json.dumps(LIMITS))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": CONFIG, "source": "tiny ELIC",
                         "file": f"codecbench/configs/{CONFIG}.json",
                         "reduced": [], "why": "host tests"})
    b["workloads"].append({"name": CELL, "config": CONFIG,
                           "traffic": "tiny_ai", "chips": 1,
                           "why": "host tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "elic.ai1080" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root
