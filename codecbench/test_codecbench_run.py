"""A whole run of a tiny cell on the host (the tiny-toy checkpoint, and
the same shapes with seeded weights): the result line, the reference
against the program, and planted faults that must come out not
correct."""

import json
import sys
import types

import pytest
import torch

from harness.faults import FAULTS, plant
from harness.manifest import Manifest
import tinycell

CELLS = [tinycell.CELL, tinycell.SEEDED]

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tinycell.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11, 900000000001])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(root, capsys, cell, seed):
    rc, res, err = tinycell.run_tiny(root, capsys, seed=seed, cell=cell)
    assert rc == 0
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"encode_fps", "decode_fps", "setup_s"}
    checks = res["checks"]
    assert checks["decode_vs_encoder_px"]["value"] == 0
    assert checks["latent_excess"]["value"] < 1e-3
    # Each compared number is printed last on stderr beside its limit.
    tail = err.strip().splitlines()[-len(checks):]
    assert [ln.split()[1] for ln in tail] == list(checks)


def test_the_run_judges_each_of_the_first_clips(root, capsys, monkeypatch):
    """Every one of the window's first ``check_within`` clips is judged, so
    a fault that one clip cannot show (half a wave of a still scene left
    out) shows in the other."""
    seen, real = [], Manifest.architecture

    def spying(self, config):
        arch = real(self, config)
        judge = arch.judge

        def spy(weights_dir, config, traffic, kept, *a):
            seen.append(sorted(kept))
            return judge(weights_dir, config, traffic, kept, *a)
        arch.judge = spy
        return arch
    monkeypatch.setattr(Manifest, "architecture", spying)
    rc, res, _ = tinycell.run_tiny(root, capsys)
    assert rc == 0 and res["correct"] is True
    assert seen == [[0, 1]]


def test_traced_result_line(root, capsys):
    rc, res, _ = tinycell.run_tiny(root, capsys, trace=1)
    assert rc == 0 and res["correct"] is True
    # On the host there is no device trace: only the host-clock layers.
    assert set(res["metrics"]) == {"mfu.encode", "mfu.decode",
                                   "finish_share.encode"}
    assert 0 < res["metrics"]["finish_share.encode"]["value"] < 100


def test_a_tagged_metric_reports_its_quantity(tmp_path, capsys):
    """encode_fps.fp32 is encode_fps in the cells it lists, with a bound
    of its own."""
    root = tinycell.make(tmp_path)
    path = root / "BENCHMARK.json"
    b = json.loads(path.read_text())
    for m in b["end_to_end"]:
        if m["name"] == "encode_fps.fp32":
            m["workloads"].append(tinycell.CELL)
    path.write_text(json.dumps(b))
    rc, res, _ = tinycell.run_tiny(root, capsys)
    assert rc == 0 and res["correct"] is True
    got = res["metrics"]
    assert got["encode_fps.fp32"]["unit"] == "frames/s"
    assert got["encode_fps.fp32"]["value"] == got["encode_fps"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(root, capsys, cell, fault):
    rc, res, err = tinycell.run_tiny(root, capsys, break_system=plant(fault),
                                     cell=cell)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("precision,correct", [("fp8", False),
                                               ("f32", True)])
def test_the_control_is_judged_by_the_cell_limits(root, precision, correct):
    """The control goes through the same verdict as a run.  TF32, the
    tiny float32 cell's own control, exists only on the card, so the host
    takes the float8 control; the reference standing in for itself
    passes."""
    import control
    res = control.control(tinycell.CELL, 2 ** 31 + 5, torch.device("cpu"),
                          root=root, precision=precision)
    assert set(res["checks"]) == set(tinycell.LIMITS)
    assert res["correct"] is correct, res["checks"]


def test_a_loaded_jax_refuses_the_result(root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res, err = tinycell.run_tiny(root, capsys)
    assert rc != 0 and res is None
    assert "forbidden modules loaded: ['jax']" in err
