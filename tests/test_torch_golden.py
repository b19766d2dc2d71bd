"""The golden suite on the host (eval/golden.py): the port, with
device="cpu", against the pins of docs/golden_suite.json, which the JAX
package made on the CPU backend (bf16-r5, wave batch 4, the held-out
clips of eval/clips.py).  Each decode must equal the encoder's
reconstruction bit for bit.

Limits (golden.HOST_LIMITS): bytes 0.5%, PSNR 0.10 dB, MS-SSIM 0.004,
about 5-7 times the worst error measured on this host.  Measured (port -
pin): ai_240p -0.0374% / +0.01706 dB / +0.00081; ra_240p -0.0734% /
+0.00033 dB / -0.00003; ldp_240p +0.0351% / +0.01621 dB / -0.00009.
ra_720p and ra_1080p are marked slow, as the suite marks them and as
tests/test_golden.py does.  ra_240p_lowrate and the sanity pin have files
of their own (test_torch_golden_lowrate.py, test_torch_golden_sanity.py)
so that no file runs long.

Also the entry point, ``python -m aivc_tpu_torch.eval.golden``: its
lines, a miss (exit 1), a skipped pin (reported with its reason, never
as passed) and no card without --cpu (exit 2).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import torch

from aivc_tpu_torch.eval import golden

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def check_pin(name: str) -> None:
    pin = golden.suite_pins()[name]
    assert golden.skip_reason(pin) is None
    got = golden.run_pin(pin, "cpu")
    cmp = golden.compare(got, pin["expect"], golden.HOST_LIMITS)
    line = golden.report_line(name, got, pin["expect"], cmp)
    assert got["bit_exact"], line
    assert cmp["ok"], line


@pytest.mark.parametrize("name", ["ai_240p", "ra_240p", "ldp_240p"])
def test_pin_within_host_limits(name):
    check_pin(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ra_720p", "ra_1080p"])
def test_slow_pin_within_host_limits(name):
    check_pin(name)


def test_sanity_py_counterparts():
    """run_suite_config / run_golden_config (scripts/sanity.py's) give
    run_pin's numbers rounded as the pins are: ai_240p, and the sanity
    pin's clip cut to 3 frames of 64x64 in GOPs of 2."""
    pins = golden.suite_pins()
    cfg = pins["ai_240p"]["config"]
    got = golden.run_suite_config("ai_240p", cfg, "models_ckpt/bf16-r5",
                                  "cpu")
    assert got == golden._rounded(golden.run_pin(pins["ai_240p"], "cpu"))
    short = dict(pins[golden.SANITY]["config"], frames=3, h=64, w=64,
                 gop_size=2, intra_period=2)
    got = golden.run_golden_config(short, "cpu")
    ref = golden.run_pin({"config": short, "ckpt": short["ckpt"]}, "cpu")
    assert got == golden._rounded(ref) and ref["bit_exact"]


def test_pins_are_read_from_the_suite_files():
    pins = golden.suite_pins()
    assert list(pins) == ["ra_240p", "ldp_240p", "ai_240p", "ra_720p",
                          "ra_1080p", "ra_240p_lowrate", golden.SANITY]
    assert pins["ra_240p_lowrate"]["ckpt"] == "models_ckpt/bf16-lr"
    assert pins[golden.SANITY]["config"]["frames"] == 33
    assert golden.select(None, False) == [
        "ra_240p", "ldp_240p", "ai_240p", "ra_240p_lowrate"]
    assert golden.select(None, True)[-2:] == ["ra_240p_lowrate",
                                              golden.SANITY]
    assert golden.select(["ra_1080p"], True) == ["ra_1080p", golden.SANITY]
    with pytest.raises(ValueError, match="unknown pins"):
        golden.select(["ra_4k"], False)


LINE = re.compile(
    r"\[GOLDEN\] ai_240p: OK  bytes \d+ \(pin 5341, [+-]\d+\.\d{4}%, limit "
    r"0\.50%\)  psnr \d+\.\d{5} dB \(pin 26\.21162, [+-]\d\.\d{5}, limit "
    r"0\.1\)  ms-ssim 0\.\d{5} \(pin 0\.87957, [+-]\d\.\d{5}, limit "
    r"0\.004\)  decode bit-exact  \d+\.\d s$")


def test_entry_point_lines_and_exit_code():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "aivc_tpu_torch.eval.golden", "--cpu",
         "--pins", "ai_240p"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == ("[GOLDEN] 1 pins on the host, limits: bytes 0.50%, "
                        "psnr 0.1 dB, ms-ssim 0.004")
    assert LINE.match(lines[1]), lines[1]
    assert lines[-1] == "[GOLDEN] 1 passed, 0 missed, 0 skipped"


def test_entry_point_miss_skip_and_no_card(monkeypatch, capsys):
    monkeypatch.setattr(golden, "HOST_LIMITS",
                        {"bytes": 0.0, "psnr": 0.0, "ms_ssim": 0.0})
    assert golden.main(["--cpu", "--pins", "ai_240p"]) == 1
    out = capsys.readouterr().out
    assert "[GOLDEN] ai_240p: MISS" in out
    assert out.strip().endswith("0 passed, 1 missed, 0 skipped")

    pins = golden.suite_pins()
    pins["ra_240p_lowrate"]["ckpt"] = "models_ckpt/absent"
    monkeypatch.setattr(golden, "suite_pins", lambda: pins)
    assert golden.main(["--cpu", "--pins", "ra_240p_lowrate"]) == 0
    out = capsys.readouterr().out
    assert ("[GOLDEN] ra_240p_lowrate: skipped (models_ckpt/absent not "
            "present)") in out
    assert out.strip().endswith("0 passed, 0 missed, 1 skipped")

    if not torch.cuda.is_available():
        assert golden.main(["--pins", "ai_240p"]) == 2
        assert "--cpu" in capsys.readouterr().err
