"""The training entry point, ``python -m aivc_tpu_torch.train``, and its
clip generator, on the host.

* ``train/data.py:make_batch`` equals scripts/train_toy.py:make_batch for
  the same seed, to the bit, with the photo pool empty on both sides
  (the JAX script runs in a subprocess: importing it configures JAX's
  compilation cache).
* ``--cpu --model tiny --size 64 --steps 3`` with ``--ema`` and
  ``--snapshot_every 2`` prints train_toy's log line for every step and
  writes the checkpoint, its optimizer state, the EMA twin and the
  snapshots; the checkpoint resumes with its optimizer state.
* A forced collapse (``--health_psnr 1000``) exits 3 and saves nothing.
* Without a card and without ``--cpu`` it exits 2 and names the flag.
* The prefetch threads give the clips of drawing them one by one, slot
  i % workers for step i, also where --step0 is no multiple of
  --workers; no slot has two jobs in flight.
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from aivc_tpu_torch.train import run
from aivc_tpu_torch.train.data import make_batch
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, read_msgpack
from tests.torch_train_ref import ROOT, limit_threads

LOG_LINE = re.compile(
    r"^step +\d+  rate_idx \d  loss -?\d+\.\d{4}  psnr -?\d+\.\d{2}  "
    r"bpp \d+\.\d{4}  gnorm \d+\.\d{2}  flow \d+\.\d{2}/\d+\.\d  "
    r"alpha \d\.\d{2}  (mskip \d  )?\(\d+s\)$")
CASES = [(0, 3, 2, 48), (1, 5, 2, 64), (7, 9, 1, 40)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def test_make_batch_equals_train_toys(tmp_path):
    out = tmp_path / "jax.npz"
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        "import train_toy\n"
        "train_toy._NATURAL = []\n"
        f"cases = {CASES!r}\n"
        "np.savez(sys.argv[1], *[train_toy.make_batch("
        "np.random.default_rng(s), n, b, z) for s, n, b, z in cases])\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(out)
    for i, (s, n, b, z) in enumerate(CASES):
        got = make_batch(np.random.default_rng(s), n, b, z, photos=[])
        assert got.shape == (n, b, z, z, 3) and got.dtype == np.float32
        assert np.array_equal(got, ref[f"arr_{i}"]), (s, n, b, z)


def _train(argv, capsys):
    rc = run.main(argv)
    return rc, capsys.readouterr()


def test_train_cpu_writes_checkpoint_ema_and_snapshot(tmp_path, capsys):
    out = tmp_path / "run"
    rc, cap = _train(["--cpu", "--model", "tiny", "--size", "64",
                      "--steps", "3", "--batch", "1", "--log_every", "1",
                      "--ema", "0.9", "--snapshot_every", "2", "--workers",
                      "2", "--lr", "1e-4", "--lr_final", "1e-5",
                      "--out", str(out)], capsys)
    assert rc == 0, cap.err
    lines = cap.out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 3 and all(LOG_LINE.match(ln) for ln in steps), \
        steps
    assert any(ln.startswith("photo pool: ") for ln in lines)
    assert any(ln.startswith("timing: 3 steps on cpu") for ln in lines)
    for d in ("run", "run-s2"):
        for f in ("config.json", "params.msgpack", "opt_state.msgpack"):
            assert (tmp_path / d / f).is_file(), (d, f)
    for d in ("run-ema", "run-ema-s2"):
        for f in ("config.json", "params.msgpack"):
            assert (tmp_path / d / f).is_file(), (d, f)
    state = read_msgpack((out / "opt_state.msgpack").read_bytes())
    assert int(state["1"]["0"]["count"]) == 3
    assert int(state["1"]["1"]["count"]) == 3
    _, model = load_checkpoint(out, device="cpu")
    _, ema = load_checkpoint(tmp_path / "run-ema", device="cpu")
    p = dict(model.named_parameters())
    e = dict(ema.named_parameters())
    assert any(not torch.equal(p[k], e[k]) for k in p)
    rc, cap = _train(["--cpu", "--resume", str(out), "--size", "64",
                      "--steps", "4", "--step0", "3", "--batch", "1",
                      "--workers", "1", "--lr", "1e-4", "--lr_final",
                      "1e-5", "--out", str(tmp_path / "more")], capsys)
    assert rc == 0, cap.err
    assert "resumed optimizer state" in cap.out
    assert "schedule fast-forwarded" not in cap.out
    state = read_msgpack((tmp_path / "more" / "opt_state.msgpack")
                         .read_bytes())
    assert int(state["1"]["0"]["count"]) == 4


def test_forced_collapse_exits_3_and_saves_nothing(tmp_path, capsys):
    out = tmp_path / "run"
    rc, cap = _train(["--cpu", "--model", "tiny", "--size", "64",
                      "--steps", "20", "--batch", "1", "--workers", "1",
                      "--health_psnr", "1000", "--out", str(out)], capsys)
    assert rc == 3
    assert "DIVERGED @ step 14" in cap.out
    assert not out.exists() and list(tmp_path.iterdir()) == []


def test_no_card_without_cpu_flag_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would train on it")
    rc, cap = _train(["--model", "tiny", "--steps", "1", "--out",
                      str(tmp_path / "run")], capsys)
    assert rc == 2 and "--cpu" in cap.err
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("step0,workers,n", [(1, 2, 5), (5, 4, 9)])
def test_prefetched_clips_repeat_with_step0_off_the_slots(step0, workers,
                                                          n):
    """Exact: the prefetched (frames, rate index, GOP) of n steps equal,
    to the bit, those drawn in sequence from fresh slots, job i on slot
    i % workers."""
    def maker():
        return run.clip_maker(0, step0, workers, [2, 3], [0.5, 0.5],
                              np.full(7, 1 / 7), 1, 16, [])

    got = list(run.prefetch(maker(), workers, n))
    seq = maker()
    ref = [seq(i % workers) for i in range(n)]
    for (fg, rg, gg), (fr, rr, gr) in zip(got, ref):
        assert (rg, gg) == (rr, gr) and np.array_equal(fg, fr)
    assert len(got) == n


def test_prefetch_keeps_one_job_per_slot_in_flight():
    lock, busy, seen = threading.Lock(), set(), []

    def make(slot):
        with lock:
            assert slot not in busy, slot
            busy.add(slot)
        time.sleep(0.01 * (slot % 2))
        with lock:
            busy.discard(slot)
            seen.append(slot)
        return slot

    assert list(run.prefetch(make, 3, 10)) == [i % 3 for i in range(10)]
    assert sorted(seen) == sorted(i % 3 for i in range(10))
