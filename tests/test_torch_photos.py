"""The committed photo pool (aivc_tpu_torch/assets/photo_pool.npz) on the
host, against the reference's loaders (scripts/photo_pool.py), which read
the assets of installed packages.

* ``eval/photos.py:train_pool`` and ``heldout_pool`` equal
  ``photo_pool.train_pool()`` and ``heldout_pool()`` to the bit (float32
  ``uint8 / 255``; the manifest excludes no image, so nothing is left
  out of the comparison), and ``train/data.py:photo_pool`` equals
  ``train_pool``.
* The clip generator draws its photo family from the file exactly as
  scripts/train_toy.py:make_batch draws it from the packages.
* ``python -m aivc_tpu_torch.eval.make_photo_pool`` writes the same
  arrays and manifest as are committed.
* The manifest states each image's pool, source, shape and licence.
* A missing, truncated or inconsistent file raises.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu_torch.eval import make_photo_pool, photos
from aivc_tpu_torch.train import data

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import photo_pool as ref_pool  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32))


def _manifest():
    return json.loads(photos.MANIFEST_FILE.read_text())


@pytest.mark.parametrize("pool", ["train", "heldout"])
def test_pool_equals_the_reference_to_the_bit(pool):
    assert _manifest()["excluded"] == []
    ours = photos.train_pool() if pool == "train" else photos.heldout_pool()
    ref = (ref_pool.train_pool() if pool == "train"
           else ref_pool.heldout_pool())
    assert len(ours) == (25 if pool == "train" else 5)
    _bit_equal(ours, ref)


def test_training_reads_the_committed_pool():
    _bit_equal(data.photo_pool(), photos.train_pool())


def test_photo_family_clips_equal_train_toys(tmp_path):
    """make_batch with the committed pool = train_toy.make_batch with the
    packages' pool, for seeds whose clips draw photographs."""
    cases = [(3, 3, 2, 64), (5, 2, 2, 96)]
    out = tmp_path / "jax.npz"
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        "import train_toy\n"
        f"cases = {cases!r}\n"
        "np.savez(sys.argv[1], *[train_toy.make_batch("
        "np.random.default_rng(s), n, b, z) for s, n, b, z in cases])\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(out)
    pool = data.photo_pool()
    for i, (s, n, b, z) in enumerate(cases):
        got = data.make_batch(np.random.default_rng(s), n, b, z, photos=pool)
        assert np.array_equal(got, ref[f"arr_{i}"]), (s, n, b, z)
        # the same seed without photographs gives other clips: these
        # seeds draw the photo family
        assert not np.array_equal(got, data.make_batch(
            np.random.default_rng(s), n, b, z, photos=[]))


def test_manifest_states_every_image():
    m = _manifest()
    rows = m["images"]
    assert m["counts"] == {"train": 25, "heldout": 5}
    assert [r["pool"] for r in rows] == ["train"] * 25 + ["heldout"] * 5
    with np.load(photos.POOL_FILE) as npz:
        assert sorted(npz.files) == sorted(r["key"] for r in rows)
        for r in rows:
            assert list(npz[r["key"]].shape) == r["shape"]
    for r in rows:
        assert r["source"] and r["licence"]
        assert any(t in r["licence"]
                   for t in make_photo_pool.REDISTRIBUTABLE)
    assert rows[0]["source"].startswith("sklearn/datasets/images/china.jpg")
    assert "creativecommons.org/licenses/by/2.0" in rows[0]["licence"]
    assert rows[-1]["source"].endswith("white_marble_tile2.png")


def test_tool_rebuilds_the_committed_file(tmp_path):
    make_photo_pool.main(["--out", str(tmp_path)])
    assert (json.loads((tmp_path / "photo_pool.json").read_text())
            == _manifest())
    with np.load(tmp_path / "photo_pool.npz") as new, \
            np.load(photos.POOL_FILE) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            assert np.array_equal(new[k], old[k]), k


def _use(monkeypatch, npz, manifest):
    monkeypatch.setattr(photos, "POOL_FILE", npz)
    monkeypatch.setattr(photos, "MANIFEST_FILE", manifest)
    photos._load.cache_clear()


@pytest.mark.parametrize("fault", ["missing", "truncated", "short_manifest",
                                   "wrong_shape"])
def test_damaged_pool_raises(fault, tmp_path, monkeypatch):
    npz, man = tmp_path / "photo_pool.npz", tmp_path / "photo_pool.json"
    shutil.copy(photos.MANIFEST_FILE, man)
    if fault != "missing":
        shutil.copy(photos.POOL_FILE, npz)
    if fault == "truncated":
        blob = npz.read_bytes()
        npz.write_bytes(blob[:len(blob) // 2])
    m = json.loads(man.read_text())
    if fault == "short_manifest":
        m["images"] = [r for r in m["images"] if r["key"] != "heldout_004"]
    if fault == "wrong_shape":
        m["images"][-1]["shape"][0] += 1
    man.write_text(json.dumps(m))
    try:
        _use(monkeypatch, npz, man)
        with pytest.raises(RuntimeError, match="photo pool"):
            photos.heldout_pool()
    finally:
        photos._load.cache_clear()
