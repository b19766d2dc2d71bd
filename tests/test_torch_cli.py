"""The command line, ``python -m aivc_tpu_torch``, on the host.

  * In-process with ``--cpu`` on tiny-toy (64x64, 5 frames): RA, LDP and
    AI encode, decode bit-exactly (the md5 manifest reads "identical")
    and evaluate, printing JAX's [RESULT] labels in JAX's order (its CLI
    run in-process on the same clip with the same flags); RA's bytes
    within 2% and PSNR within 0.05 dB of JAX's (f32 model; measured: 373
    B on both sides, PSNR gap 2e-5 dB).
  * ``--mode encode``, then ``--mode decode`` in a second process, then
    ``--mode evaluate``: the same frames as the one-process run.
  * ``--log_dir``'s files and the md5 manifest are the bytes JAX's
    writers give for the same frame results and frames.
  * Without ``--cpu`` and with no card it exits nonzero and names the
    flag; a ladder name whose checkpoint is not on disk is refused (no
    other model is picked).
  * Neither the CLI nor any module of the port imports jax, flax or the
    JAX package.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu_torch import cli
from aivc_tpu_torch.io.yuv import YuvReader, YuvWriter
from aivc_tpu_torch.pipeline.video import synthetic_frames

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"
N = 5
FLAGS = ["--bitstream_debug", "--rate_audit"]
FLAG_LABELS = ("analytic rate bits", "real rate bits", "container overhead",
               "enc/dec drift check")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = d / "clip_64x64_30_420.yuv"
    with YuvWriter(path) as w:
        for f in synthetic_frames(N, 64, 64):
            w.write_frame(f)
    return path


def _args(clip, out_dir, structure, *extra):
    gop = {"RA": 4, "LDP": 4, "AI": 1}[structure]
    return ["--cpu", "-i", str(clip), "-o", str(out_dir / "dec.yuv"),
            "--bitstream_out", str(out_dir / "clip.bin"),
            "--coding_config", structure, "--gop_size", str(gop),
            "--intra_period", str(max(gop, 1)), "--model", str(CKPT),
            "--wave_batch", "3" if structure == "AI" else "2", *extra]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _results(out: str):
    """[RESULT] lines -> [(label, value)] in order."""
    rows = []
    for ln in out.splitlines():
        if ln.startswith("[RESULT]"):
            label, value = ln[len("[RESULT]"):].split(":", 1)
            rows.append((label.strip(), value.strip()))
    return rows


@pytest.fixture(scope="module")
def port_runs(clip, tmp_path_factory):
    runs = {}
    for s in ("RA", "LDP", "AI"):
        d = tmp_path_factory.mktemp(f"port_{s}")
        rc, out = _run(cli.main, _args(clip, d, s, *FLAGS, "--log_dir",
                                       str(d / "logs")))
        assert rc == 0, out
        runs[s] = (d, out)
    return runs


@pytest.fixture(scope="module")
def jax_run(clip, tmp_path_factory):
    from aivc_tpu import cli as jcli

    d = tmp_path_factory.mktemp("jax_RA")
    rc, out = _run(jcli.main, _args(clip, d, "RA", *FLAGS))
    assert rc == 0, out
    return d, out


@pytest.mark.parametrize("structure", ["RA", "LDP", "AI"])
def test_results_labels_match_jax(port_runs, jax_run, structure):
    ours = _results(port_runs[structure][1])
    ref = _results(jax_run[1])
    assert [k for k, _ in ours] == [k for k, _ in ref]
    got = dict(ours)
    assert got["enc/dec drift check"] == "identical"
    assert float(got["psnr"].split()[0]) > 10.0
    assert float(got["bitstream bytes"]) == (
        port_runs[structure][0] / "clip.bin").stat().st_size


def test_ra_numbers_match_jax(port_runs, jax_run):
    ours = dict(_results(port_runs["RA"][1]))
    ref = dict(_results(jax_run[1]))
    nb, rb = int(ours["bitstream bytes"]), int(ref["bitstream bytes"])
    assert abs(nb - rb) <= 0.02 * rb
    psnr = float(ours["psnr"].split()[0])
    assert abs(psnr - float(ref["psnr"].split()[0])) <= 0.05


def test_labels_without_flags(clip, tmp_path, jax_run):
    rc, out = _run(cli.main, _args(clip, tmp_path, "RA"))
    assert rc == 0
    assert [k for k, _ in _results(out)] == [
        k for k, _ in _results(jax_run[1]) if k not in FLAG_LABELS]


def test_stages_in_separate_processes(clip, tmp_path, port_runs):
    enc_args = _args(clip, tmp_path, "RA", "--bitstream_debug",
                     "--mode", "encode")
    rc, out = _run(cli.main, enc_args)
    assert rc == 0 and "bitstream bytes" in out
    assert (tmp_path / "clip.bin").read_bytes() == \
        (port_runs["RA"][0] / "clip.bin").read_bytes()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "aivc_tpu_torch",
         *_args(clip, tmp_path, "RA", "--bitstream_debug", "--mode",
                "decode")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert dict(_results(proc.stdout))["enc/dec drift check"] == "identical"
    a = YuvReader(tmp_path / "dec.yuv", 64, 64)
    b = YuvReader(port_runs["RA"][0] / "dec.yuv", 64, 64)
    assert a.n_frames == b.n_frames == N
    for i in range(N):
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(a.read_frame(i)[c],
                                          b.read_frame(i)[c])
    rc, out = _run(cli.main, _args(clip, tmp_path, "RA", "--mode",
                                   "evaluate"))
    assert rc == 0
    assert dict(_results(out))["psnr"] == \
        dict(_results(port_runs["RA"][1]))["psnr"]


def test_log_files_and_manifest_match_jax_writers(port_runs, tmp_path):
    from aivc_tpu.pipeline.video import FrameResult as JFrameResult
    from aivc_tpu.utils import debug as jdebug
    from aivc_tpu.utils.logging import FrameResultLogger as JLogger
    from aivc_tpu_torch.utils import debug as tdebug

    d = port_runs["RA"][0]
    rows = [json.loads(ln) for ln in
            (d / "logs" / "detailed.jsonl").read_text().splitlines()]
    assert len(rows) == N
    logger = JLogger(tmp_path / "jax_logs")
    for r in rows:
        logger.log(JFrameResult(**r))
    logger.close()
    for name in ("detailed.txt", "detailed.jsonl"):
        assert (d / "logs" / name).read_bytes() == \
            (tmp_path / "jax_logs" / name).read_bytes(), name
    reader = YuvReader(d / "dec.yuv", 64, 64)
    # the encoder's manifest lists the frames in coding order
    order = json.loads((d / "clip.bin.md5.json").read_text())
    frames = {int(i): reader.read_frame(int(i)) for i in order}
    tdebug.write_md5_manifest(frames, tmp_path / "ours.json")
    jdebug.write_md5_manifest(frames, tmp_path / "jax.json")
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes() == \
        (d / "clip.bin.md5.json").read_bytes()


def test_no_card_without_cpu_flag_exits_nonzero(clip, tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _args(clip, tmp_path, "RA") if a != "--cpu"]
    assert cli.main(argv) != 0
    assert "--cpu" in capsys.readouterr().err
    assert not (tmp_path / "clip.bin").exists()


def test_missing_ladder_checkpoint_is_refused(clip, tmp_path, monkeypatch,
                                              capsys):
    from aivc_tpu_torch.models import zoo

    monkeypatch.setattr(zoo, "REPO_ROOT", tmp_path)
    argv = _args(clip, tmp_path, "RA")
    argv[argv.index("--model") + 1] = "tpu-msssim-2021cc-7"
    assert cli.main(argv) != 0
    err = capsys.readouterr().err
    assert "models_ckpt/bf16-lr" in err and "not on disk" in err


def test_port_imports_nothing_of_jax():
    """Import the CLI, the training entry point and every module of the
    port (the golden runner among them) in a fresh process: none of jax,
    flax, optax, the JAX package or its scripts may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import aivc_tpu_torch, aivc_tpu_torch.cli, aivc_tpu_torch.__main__\n"
        "import aivc_tpu_torch.train.__main__, aivc_tpu_torch.train.run\n"
        "for m in pkgutil.walk_packages(aivc_tpu_torch.__path__, "
        "'aivc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'aivc_tpu', 'scripts', "
        "'train_toy', 'photo_pool', 'eval_data', 'sanity'))\n"
        "print(len([n for n in sys.modules if n.startswith("
        "'aivc_tpu_torch')]), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(" ", 1)
    assert bad.strip() == "[]"
    assert int(n) >= 30
