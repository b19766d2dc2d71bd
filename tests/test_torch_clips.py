"""The held-out clips of the port (eval/clips.py) against
scripts/eval_data.py: every one of the 11 families, byte for byte, at
48x64 and at the golden suite's 240x416 (3 frames each; the photo
families read the committed pool, the reference the packages' assets).
A photo family whose pool is short raises where the reference falls
back to a synthetic family.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu_torch.eval import clips

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import eval_data  # noqa: E402

PHOTO_FAMILIES = {"photowarp": 1, "zoomgrain": 3, "parallax": 2,
                  "rotpan": 1, "staticcam": 1}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_families_are_the_reference_families():
    assert list(clips.FAMILIES) == list(eval_data.FAMILIES)


@pytest.mark.parametrize("size", [(48, 64), (240, 416)])
@pytest.mark.parametrize("family", list(eval_data.FAMILIES))
def test_clip_equals_the_reference_byte_for_byte(family, size):
    h, w = size
    ours = clips.heldout_clips(3, h, w, names=[family])[0]
    ref = eval_data.heldout_clips(3, h, w, names=[family])[0]
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        for c in ("y", "u", "v"):
            assert a[c].dtype == b[c].dtype == np.uint8
            assert a[c].shape == b[c].shape
            assert a[c].tobytes() == b[c].tobytes(), (family, c)


def test_all_families_at_once():
    ours = clips.heldout_clips(2, 48, 64)
    assert len(ours) == len(clips.FAMILIES)


@pytest.mark.parametrize("family,need", list(PHOTO_FAMILIES.items()))
def test_short_pool_raises(family, need, monkeypatch):
    pool = clips.heldout_pool()
    monkeypatch.setattr(clips, "heldout_pool", lambda: pool[:need - 1])
    with pytest.raises(ValueError, match=f"{family} needs {need}"):
        clips.heldout_clips(2, 48, 64, names=[family])
    monkeypatch.setattr(clips, "heldout_pool", lambda: pool[:need])
    assert len(clips.heldout_clips(2, 48, 64, names=[family])[0]) == 2
