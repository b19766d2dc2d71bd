"""Rehearsal of chip_smoke.py's training phases on the host, with
tiny-toy (the card runs them with bf16-r5): train-small's steps (the
checkpoint's precision, then float32) on two devices with the same
frames and noise (here both are the host, so the two must agree to the
bit), and train-recipe's subprocess, files and reloads for one step;
and the per-leaf distances that train-small holds the float32 step to."""

from pathlib import Path

import pytest
import torch

from aivc_tpu_torch import smoke
from aivc_tpu_torch.ops import warp as warp_ops

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "models_ckpt" / "tiny-toy")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_train_small_rehearsed(monkeypatch):
    """Both steps (tiny-toy is float32 already, so the two are one
    computation) on the host twice: equal to the bit, leaf by leaf."""
    # chip_smoke.py runs with AIVC_WARP=pallas; the phase trains off it
    monkeypatch.setattr(warp_ops, "_USE_PALLAS", True)
    r = smoke.train_small(CKPT, torch.device("cpu"), size=64, idx_rate=1)
    assert warp_ops._USE_PALLAS
    params = list(smoke.load_checkpoint(CKPT, device="cpu")[1].parameters())
    for t in (r, r["f32"]):
        assert t["cosine"] == pytest.approx(1.0) and t["rel_l2"] == 0.0
        assert t["worst_leaf_rel_l2"][1] == 0.0
        assert t["worst_leaf_cosine"][2] == pytest.approx(1.0)
        assert t["n_leaves"] == len(params)
        assert all(v == 0.0 for v in t["diffs"].values())
        for side in ("device", "host"):
            assert t[side]["step_skipped"] == 0.0
            assert t[side]["micro_skipped"] == 0.0
            assert t[side]["max_param_change"] > 0.0
        assert t["n_params"] == sum(p.numel() for p in params)


def test_train_recipe_rehearsed(tmp_path, monkeypatch):
    monkeypatch.setenv("AIVC_WARP", "pallas")     # the child must not see it
    # The child inherits the environment: two OpenMP threads, as the test
    # workers use (more spin against the other workers' threads).
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    r = smoke.train_recipe(CKPT, str(tmp_path / "r5-port"), ROOT,
                           torch.device("cpu"), steps=1)
    assert len(r["losses"]) == 1 and r["skipped"] == 0
    assert r["max_param_change"] > 0.0 and r["ema_max_change"] > 0.0
    assert (r["opt_count"], r["schedule_count"]) == (1, smoke.RECIPE_STEP0
                                                     + 1)
    assert r["timing"].startswith("timing: 1 steps on cpu")
    assert any(ln.startswith("photo pool: ") for ln in r["lines"])
    assert set(r["file_mb"]) == {"params", "config", "opt_state", "ema"}
    assert all(v == v and abs(v) < 1e30 for v in r["forward_logs"].values())


def test_leaf_distances_single_out_a_wrong_small_leaf():
    """A leaf of 8 values gone wrong beside a large correct one: the
    whole vector stays within train-small's limits, the worst leaf
    does not."""
    gen = torch.Generator().manual_seed(0)
    host = {"conv": torch.randn(100_000, generator=gen),
            "gdn.beta": torch.rand(8, generator=gen) * 1e-2,
            "zero": torch.zeros(3)}
    dev = dict(host, **{"gdn.beta": -host["gdn.beta"]})
    whole = torch.cat([v for v in dev.values()]) - torch.cat(
        [v for v in host.values()])
    assert float(whole.norm()) / float(torch.cat(
        list(host.values())).norm()) < smoke.TRAIN_SMALL_MAX_REL_L2
    rows = {k: (r, c) for k, r, c in smoke.leaf_distances(dev, host)}
    assert rows["conv"] == (0.0, pytest.approx(1.0))
    assert rows["zero"] == (0.0, 1.0)
    assert rows["gdn.beta"][0] == pytest.approx(2.0)
    assert rows["gdn.beta"][1] == pytest.approx(-1.0)
    assert rows["gdn.beta"][0] > smoke.TRAIN_SMALL_F32_LEAF_MAX_REL_L2
    assert rows["gdn.beta"][1] < smoke.TRAIN_SMALL_F32_LEAF_MIN_COSINE
    only_one = dict(host, zero=torch.ones(3))
    assert dict((k, (r, c)) for k, r, c in smoke.leaf_distances(
        only_one, host))["zero"] == (float("inf"), 0.0)
