"""The process-driving tools of the port on the host, and the port's
imports.

* ``scripts.aivc``: encode, decode and evaluate as three ``--cpu``
  processes on a small tiny-toy YUV write the bitstream a one-process
  CLI encode writes, and decode its reconstruction; a failing stage's
  exit code comes through (no card and no --cpu: the encode stage's 2).
* ``scripts.sanity``: the structural run prints ``[SANITY] OK``;
  --golden / --suite hand off to eval/golden.py with its flags;
  --update is refused; no card and no --cpu exits 2.
* ``scripts.train_supervised``: tests/test_supervisor.py's cases on the
  port's ``last_step`` and ``last_saved_step``; then the loop with a fake
  trainer that prints ``step`` and ``checkpoint @ step`` lines and
  stalls: killed after --stall_s 2, relaunched with --step0 N+1,
  --resume <out> and --seed 1, and the run ends at 0; a trainer that
  exits 2 is not relaunched.
* No module of aivc_tpu_torch/, and not chip_smoke.py, imports jax,
  jaxlib, flax, optax or the JAX package (a grep of the sources).
"""

import argparse
import contextlib
import io
import re
import sys
import time
from pathlib import Path

import pytest

import torch

from aivc_tpu_torch import cli
from aivc_tpu_torch.io.yuv import YuvWriter
from aivc_tpu_torch.pipeline.video import synthetic_frames
from aivc_tpu_torch.scripts import aivc, sanity, train_supervised as sup
from torch_scripts_ref import ROOT, TINY_TOY, limit_threads, run_port


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_thread_children(monkeypatch):
    """Child processes: a small OpenMP pool, and no card."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")


def clip_args(tmp_path, name):
    path = tmp_path / "clip_64x48_30_420.yuv"
    if not path.exists():
        with YuvWriter(path) as w:
            for f in synthetic_frames(5, 48, 64):
                w.write_frame(f)
    return ["-i", str(path), "-o", str(tmp_path / f"{name}.yuv"),
            "--bitstream_out", str(tmp_path / f"{name}.bin"),
            "--coding_config", "RA", "--gop_size", "4", "--intra_period",
            "4", "--model", str(TINY_TOY), "--wave_batch", "4"]


def test_aivc_three_processes_equal_one(tmp_path, one_thread_children):
    rc, out = run_port(aivc.main, clip_args(tmp_path, "sep") + ["--cpu"])
    assert rc == 0, out
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(clip_args(tmp_path, "one") + ["--cpu"]) == 0
    assert (tmp_path / "sep.bin").read_bytes() == \
        (tmp_path / "one.bin").read_bytes()
    assert (tmp_path / "sep.yuv").read_bytes() == \
        (tmp_path / "one.yuv").read_bytes()
    assert [ln.split(":")[0] for ln in out.splitlines()
            if ln.startswith("[aivc]")] == [
        f"[aivc] running {m}" for m in aivc.STAGES]


def test_aivc_failing_stage_rc(tmp_path, one_thread_children, capsys):
    assert aivc.main(clip_args(tmp_path, "x")) == 2
    err = capsys.readouterr().err
    assert "[aivc] stage encode failed with 2" in err
    assert not (tmp_path / "x.bin").exists()


def test_sanity_structural_ok():
    rc, out = run_port(sanity.main, ["--cpu"])
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[SANITY]")]
    assert lines[-2:] == ["[SANITY] enc/dec               : bit-exact",
                          "[SANITY] OK"]
    assert lines[0] == "[SANITY] frames                : 9"


def test_sanity_golden_flags_and_refusals(monkeypatch, capsys):
    from aivc_tpu_torch.eval import golden

    def argv(*flags):
        return sanity.golden_argv(argparse.Namespace(
            cpu="--cpu" in flags, golden="--golden" in flags,
            slow="--slow" in flags))

    assert argv("--cpu", "--golden") == ["--cpu", "--pins", golden.SANITY]
    assert argv("--suite") == []
    slow = argv("--cpu", "--slow")
    assert slow[:2] == ["--cpu", "--pins"] and "ra_1080p" in slow
    assert golden.SANITY not in slow
    assert sanity.main(["--cpu", "--golden", "--update"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sanity.main([]) == 2
    assert "--cpu" in capsys.readouterr().err


# -- the supervisor's log accounting (tests/test_supervisor.py's cases) ----

def test_last_step_counts_only_current_launch(tmp_path):
    log = tmp_path / "t.log"
    log.write_text(
        "=== supervisor launch #0 (remaining 9000) ===\n"
        "step     0  rate_idx 1  loss 1.0\n"
        "step  1950  rate_idx 3  loss 0.5\n"
        "=== supervisor launch #1 (remaining 7500) ===\n"
        "resumed params from models_ckpt/x\n"
        "step     0  rate_idx 2  loss 0.9\n"
        "step   700  rate_idx 0  loss 0.8\n")
    assert sup.last_step(log) == 700


def test_last_step_handles_missing_and_garbled(tmp_path):
    assert sup.last_step(tmp_path / "absent.log") == 0
    log = tmp_path / "t.log"
    log.write_text("=== supervisor launch #0 ===\nstep garbage\nstep\n")
    assert sup.last_step(log) == 0
    log.write_text("step    42  loss 1.0\n")
    assert sup.last_step(log) == 42


def test_last_saved_step_reads_actual_checkpoint_lines(tmp_path):
    log = tmp_path / "t.log"
    log.write_text(
        "=== supervisor launch #0 (remaining 9000) ===\n"
        "step   499  rate_idx 1  loss 1.0\n"
        "checkpoint @ step 500 -> models_ckpt/x\n"
        "step   740  rate_idx 3  loss 0.5\n"
        "snapshot @ step 600 -> models_ckpt/x-s600\n")
    assert sup.last_saved_step(log) == 600
    with log.open("a") as f:
        f.write("=== supervisor launch #1 (remaining 8300) ===\n"
                "step   501  rate_idx 2  loss 0.9\n")
    assert sup.last_saved_step(log) == -1


def test_last_saved_step_ignores_garbage(tmp_path):
    log = tmp_path / "t.log"
    log.write_text("checkpoint @ step notanumber -> x\n")
    assert sup.last_saved_step(log) == -1


def test_port_trainer_lines_are_counted(tmp_path):
    """The lines train/run.py prints (its log_line and save lines)."""
    from aivc_tpu_torch.train.run import log_line

    logs = {"loss": 1.0, "rate_bpp": 0.5, "psnr": 20.0, "ms_ssim": 0.9,
            "grad_norm": 1.0, "flow_mag": 0.1, "flow_max": 1.0,
            "alpha_mean": 0.5,
            "micro_skipped": 0.0, "step_skipped": 0.0}
    log = tmp_path / "t.log"
    log.write_text(f"=== supervisor launch #0 ===\n"
                   f"{log_line(7, 1.0, logs, 1, 3.0)}\n"
                   f"checkpoint @ step 5 -> out\n")
    assert sup.last_step(log) == 7 and sup.last_saved_step(log) == 5


FAKE_TRAINER = """
import argparse, json, sys, time
from pathlib import Path
ap = argparse.ArgumentParser()
for flag in ("--steps", "--step0", "--save_every", "--seed"):
    ap.add_argument(flag, type=int, default=0)
ap.add_argument("--out")
ap.add_argument("--resume", default="")
ap.add_argument("--size", type=int)
ap.add_argument("--refuse", action="store_true")
a = ap.parse_args()
with open(a.out + ".launches", "a") as f:
    f.write(json.dumps(vars(a)) + "\\n")
if a.refuse:
    sys.exit(2)
if a.step0 == 0:
    print("step     1  rate_idx 0  loss 1.0", flush=True)
    Path(a.out).mkdir(exist_ok=True)
    print(f"checkpoint @ step 1 -> {a.out}", flush=True)
    print("step     2  rate_idx 0  loss 0.9", flush=True)
    time.sleep(120)
for s in range(a.step0, a.steps):
    print(f"step {s:5d}  rate_idx 0  loss 0.5", flush=True)
"""


def fake_trainer(tmp_path):
    path = tmp_path / "fake_trainer.py"
    path.write_text(FAKE_TRAINER)
    return (sys.executable, str(path))


def launches(out: Path):
    import json

    return [json.loads(ln) for ln in
            Path(f"{out}.launches").read_text().splitlines()]


def test_supervisor_relaunches_a_stalled_run(tmp_path, capsys):
    out = tmp_path / "run"
    t0 = time.time()
    rc = sup.main(["--steps", "4", "--out", str(out), "--stall_s", "2",
                   "--first_step_grace_s", "2", "--", "--size", "64"],
                  trainer=fake_trainer(tmp_path))
    assert rc == 0
    assert time.time() - t0 < 30
    first, second = launches(out)
    assert (first["step0"], first["seed"], first["resume"],
            first["save_every"], first["steps"]) == (0, 0, "", 500, 4)
    assert (second["step0"], second["seed"], second["resume"],
            second["steps"], second["size"]) == (2, 1, str(out), 4, 64)
    said = capsys.readouterr().out
    assert "stalled" in said and "target 4 steps reached" in said
    log = Path(f"{out}.log").read_text()
    assert log.count("=== supervisor launch") == 2
    assert "step     3" in log


def test_supervisor_stops_on_a_refused_command_line(tmp_path):
    out = tmp_path / "run"
    rc = sup.main(["--steps", "4", "--out", str(out), "--stall_s", "2",
                   "--", "--refuse", "--seed", "9"],
                  trainer=fake_trainer(tmp_path))
    assert rc == 2
    (only,) = launches(out)
    assert only["seed"] == 9


# -- imports ---------------------------------------------------------------

FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|aivc_tpu)\b(?!_torch)"
    r"|import_module\(\s*[\"'](?:jax|jaxlib|flax|optax|aivc_tpu)\b(?!_torch)",
    re.M)


def test_port_sources_import_nothing_of_jax():
    files = sorted((ROOT / "aivc_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 60
    assert any(f.parent.name == "scripts" for f in files)
    bad = {str(f.relative_to(ROOT)): m.group(0).strip()
           for f in files for m in [FORBIDDEN.search(f.read_text())] if m}
    assert bad == {}
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from aivc_tpu.config import X")
    assert not FORBIDDEN.search("from aivc_tpu_torch import kernels")
