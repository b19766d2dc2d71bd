"""Rehearsal of chip_smoke.py's phases on the host at a tiny size (the
kernel wrappers take their plain versions there), and of its refusal to
run without a card or without the package."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aivc_tpu_torch import smoke
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.pipeline.video import synthetic_frames
from aivc_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec():
    cfg, model = load_checkpoint(CKPT, device="cpu")
    return FrameCodec(cfg, model, 128, 128, device="cpu")


def test_phases_rehearsed_on_host(codec):
    records = smoke.check_rans(codec, batch=2, reps=1)
    records += smoke.check_warp(torch.device("cpu"), 2, 64, 128, 32, reps=1)
    assert [r["name"] for r in records] == ["rans_encode", "rans_decode",
                                            "warp_packed"]
    res = smoke.code_clip(codec, synthetic_frames(9, 128, 128))
    assert res["bytes"] > 0 and res["psnr"] > 10
    line = json.loads(smoke.kernels_line(records, {"rans_encode": 5,
                                                   "rans_decode": 14,
                                                   "warp_packed": 14}))
    for r in line["kernels"]:
        assert set(r) == KEYS and r["launches"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert r["max_abs_err"] == 0.0


def test_small_agreement_rehearsed_on_host():
    out = smoke.small_agreement(str(CKPT), torch.device("cpu"), size=64,
                                n_frames=5)
    assert out["device"]["bytes"] == out["host"]["bytes"]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_without_card(monkeypatch, capsys):
    mod = _load_chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
