"""The golden and formats phases of chip_smoke.py rehearsed on the host
(smoke.golden_runs, smoke.formats_runs): the phases' checks and lines at
a small size, where the kernel wrappers take their plain versions and no
launch is captured.  golden: ai_240p within the host limits, MS-SSIM
within smoke.ORACLE_MS_SSIM_TOL (2e-4) of the numpy oracle, a pin
without its checkpoint skipped with the reason, a miss raising.
formats: bf16-r5 at 64x64, 5 frames, RA GOP 4, wave batch 4.
"""

from pathlib import Path

import pytest

import torch

from aivc_tpu_torch import smoke
from aivc_tpu_torch.eval import golden
from aivc_tpu_torch.pipeline.video import synthetic_frames

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "models_ckpt" / "bf16-r5")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_golden_phase_rehearsed(monkeypatch):
    pins = golden.suite_pins()
    pins["ra_240p_lowrate"]["ckpt"] = "models_ckpt/absent"
    monkeypatch.setattr(golden, "suite_pins", lambda: pins)
    lines = []
    out = smoke.golden_runs(torch.device("cpu"),
                            names=("ai_240p", "ra_240p_lowrate"),
                            limits=golden.HOST_LIMITS, say=lines.append)
    assert out["ra_240p_lowrate"] == {
        "skipped": "models_ckpt/absent not present"}
    r = out["ai_240p"]
    assert r["bit_exact"] and r["cmp"]["ok"]
    assert r["oracle_err"] <= smoke.ORACLE_MS_SSIM_TOL
    assert lines[0].startswith("golden ai_240p: OK  bytes ")
    assert "against the numpy oracle's" in lines[1]
    assert lines[2] == ("golden ra_240p_lowrate: skipped "
                        "(models_ckpt/absent not present)")
    with pytest.raises(AssertionError, match="ai_240p: outside the limits"):
        smoke.golden_runs(torch.device("cpu"), names=("ai_240p",),
                          limits={"bytes": 0.0, "psnr": 0.0,
                                  "ms_ssim": 0.0}, say=lines.append)


def test_formats_phase_rehearsed():
    frames = synthetic_frames(5, 64, 64)
    out = smoke.formats_runs(CKPT, frames, torch.device("cpu"),
                             wave_batch=4, gop=4)
    assert out["v2"]["sched"] == out["v1"]["sched"] == 0x1F
    assert out["v2"]["elide"] and not out["v1"]["elide"]
    assert out["sched"]["sched"] == 0x0D
    # the v1 stream codes the same reconstruction as the v2 stream
    assert out["v1"]["psnr"] == out["v2"]["psnr"]
    assert out["v1"]["bytes"] != out["v2"]["bytes"]
    assert out["v1"]["captured_enc"] is None
    assert out["v1"]["captured_dec"] == []
    assert "AIVC_GDN_LOWP=1" in out["refused"]
    assert "AIVC_DC_OFFSET=1" in out["refused"]
    assert all(c.get("__dc__") is not None
               for c in smoke.frame_chunks(out["v2"]["bitstream"]))
