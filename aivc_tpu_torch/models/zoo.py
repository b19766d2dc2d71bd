"""Name -> checkpoint map of the trained rate ladder (the checkpoint part
of aivc_tpu/models/zoo.py).  Entries with gain surgery (names 5-6) wait
for a later slice and are refused."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

TRAINED_LADDER: Dict[str, dict] = {
    "tpu-msssim-2021cc-1": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 0.0},
    "tpu-msssim-2021cc-2": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 2.0},
    "tpu-msssim-2021cc-3": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 4.0},
    "tpu-msssim-2021cc-4": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 6.0},
    "tpu-msssim-2021cc-5": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 4.0,
                            "surgery": {"shift": 3, "tail_boost": 1.5}},
    "tpu-msssim-2021cc-6": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 5.0,
                            "surgery": {"shift": 3, "tail_boost": 1.5}},
    "tpu-msssim-2021cc-7": {"ckpt": "models_ckpt/bf16-lr", "idx_rate": 6.0},
}

REPO_ROOT = Path(__file__).resolve().parents[2]


def checkpoint_for(name: str) -> Optional[Tuple[Path, float]]:
    """-> (checkpoint dir, idx_rate) of a trained-ladder name, or None for
    an unknown name or a checkpoint missing on disk."""
    entry = TRAINED_LADDER.get(name)
    if entry is None:
        return None
    if "surgery" in entry:
        raise NotImplementedError(
            f"{name} needs gain surgery, which waits for a later slice")
    ckpt = REPO_ROOT / entry["ckpt"]
    return (ckpt, entry["idx_rate"]) if ckpt.is_dir() else None
