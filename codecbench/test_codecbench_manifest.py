"""The manifest, discovery by name, the module guard and the command's
refusals, on the host."""

import json
import re
import subprocess
import sys

import pytest

from harness import weights
from harness.bench import FORBIDDEN, forbidden_modules
from harness.manifest import Manifest
import tinycell

REPO = tinycell.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
ARCH_FUNCTIONS = ("system", "capture_decode", "judge", "control",
                  "frame_flops", "init_tree")


def test_every_cell_finds_its_files():
    man = Manifest(REPO)
    b = man.data
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        config = man.config(w["config"])
        # Exactly one of a checkpoint that is there and a weight seed.
        if weights.seed_of(config) is None:
            assert (REPO / config["checkpoint"] / "params.msgpack").exists()
        arch = man.architecture(config)
        for fn in ARCH_FUNCTIONS:
            assert callable(getattr(arch, fn)), (config["name"], fn)
        traffic = man.traffic(w["traffic"])
        assert traffic["frames"] == 33
        limits = man.limits(w["name"])
        assert limits["decode_vs_encoder_px"] == 0
        e2e = man.metrics(w["name"], traced=False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layer = man.metrics(w["name"], traced=True)
        assert layer
        for m in layer:
            assert callable(man.reader(m["name"]).read)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_each_layer_metric_moves_what_its_cells_report():
    """A per-layer metric's cells report the end-to-end metric it moves,
    and each cell reports at least one more end-to-end metric than
    setup_s and at least one per-layer metric."""
    man = Manifest(REPO)
    e2e = {m["name"]: m for m in man.data["end_to_end"]}
    for m in man.data["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in man.metrics(w, False)}
    for w in man.data["workloads"]:
        assert len(man.metrics(w["name"], False)) >= 2
        assert man.metrics(w["name"], True)


@pytest.mark.parametrize("name", ["elic", None, "../harness/bench", 3])
def test_an_unknown_architecture_raises(name):
    with pytest.raises(KeyError, match=r"known: \['aivc'\]"):
        Manifest(REPO).architecture({"architecture": name})


@pytest.mark.parametrize("config", [
    {"checkpoint": "models_ckpt/bf16-r5", "weights": {"seed": 1}},
    {},
    {"weights": {"seed": -1}},
    {"weights": {"seed": "1"}},
    {"weights": {"seed": True}},
    {"weights": {"seed": 1, "scale": 2}},
    {"weights": 1},
])
def test_weights_are_one_checkpoint_or_one_seed(config):
    with pytest.raises(ValueError):
        weights.seed_of(config)


def test_a_dropped_in_cell_is_found(tmp_path):
    root = tinycell.make(tmp_path)
    man = Manifest(root)
    assert man.workload(tinycell.CELL)["traffic"] == "tiny_ra"
    assert weights.seed_of(man.config("tiny-seeded")) == tinycell.WEIGHT_SEED
    assert man.traffic("tiny_ra")["height"] == 64
    assert man.limits(tinycell.CELL) == tinycell.LIMITS
    names = {m["name"] for m in man.metrics(tinycell.CELL, traced=True)}
    assert {"mfu.encode", "k3_roofline.decode", "device_idle.decode"} <= names
    # A per-layer metric without a workloads list goes to every cell that
    # reports the end-to-end metric it moves.
    man.data["per_layer"].append({"name": "new.metric", "moves":
                                  "decode_fps"})
    assert "new.metric" in {m["name"] for m in man.metrics(tinycell.CELL,
                                                           traced=True)}
    assert "new.metric" not in {m["name"] for m in man.metrics(
        "r5.ldp1080", traced=True)}


@pytest.mark.parametrize("mods,found", [
    (["aivc_tpu_torch", "aivc_tpu_torch.pipeline.codec"], []),
    (["aivc_tpu_torch", "aivc_tpu.ops"], ["aivc_tpu"]),
    (["jaxlib.xla_client", "numpy"], ["jaxlib"]),
    (["jax", "flax.linen", "optax"], ["flax", "jax", "optax"]),
    (["aivc_tpu_torchx", "jaxtyping", "flaxen"], []),
])
def test_guard_compares_whole_top_level_names(mods, found):
    assert forbidden_modules(mods) == found
    assert set(found) <= set(FORBIDDEN)


def test_the_benchmark_and_the_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, 'codecbench'); "
            "sys.path.append('.'); import harness.bench, harness.trace, "
            "harness.faults, harness.weights, reference.judge, "
            "aivc_tpu_torch.pipeline.video, aivc_tpu_torch.coding.vrans, "
            "aivc_tpu_torch.utils.checkpoint; "
            "from harness.manifest import Manifest; m = Manifest('.'); "
            "[m.architecture(m.config(c['name'])) "
            "for c in m.data['configs']]; "
            "from harness.bench import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "codecbench/run.py", "--workload", "r5.ra1080",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_exits_without_a_result(tmp_path):
    (tmp_path / "codecbench").symlink_to(REPO / "codecbench")
    (tmp_path / "BENCHMARK.json").write_text(
        (REPO / "BENCHMARK.json").read_text())
    code = ("import sys, time; sys.path.insert(0, 'codecbench'); "
            "from pathlib import Path; from harness.bench import run; "
            "sys.exit(run(['--workload', 'r5.ra1080', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], Path('.'), time.time(), "
            "device='cpu', require_card=False))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "program is not in this checkout" in out.stderr
