"""The scripts phase of chip_smoke.py rehearsed on the host
(smoke.scripts_runs): a 7-rate tiny checkpoint
(torch_scripts_ref.tiny7: tiny-toy's tree, a 7-row geometric gain
ladder, bf16-r5's lambdas) on 5 frames of
48x64, RA GOP 4, wave batch 4, the eval and probe parts at 48x64.  The
kernel wrappers take their plain versions here, so no CUDA launch is
counted.  Every check of the phase runs: the in-process sweep streams
decode bit-exactly, the pinned workers' rows equal the pinned in-process
rows, eval_ckpt's decodes are bit-exact, scripts.aivc's stream equals
the CLI's.  A pinned K other than the codec's own choice changes the
bytes.
"""

import contextlib
import io

import pytest

import torch

from aivc_tpu_torch import cli, smoke
from aivc_tpu_torch.pipeline.video import synthetic_frames
from torch_scripts_ref import ROOT, limit_threads, tiny7

H, W, N, GOP = 48, 64, 5, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")


def test_scripts_phase_rehearsed(tmp_path, small_children):
    ckpt = tiny7(tmp_path / "tiny7")
    frames = synthetic_frames(N, H, W)
    clip = smoke.write_clip(frames, tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--cpu", "-i", str(clip), "-o",
                         str(tmp_path / "ra.yuv"), "--bitstream_out",
                         str(tmp_path / "ra.bin"), "--coding_config", "RA",
                         "--gop_size", str(GOP), "--intra_period", str(GOP),
                         "--model", ckpt, "--wave_batch", "4"]) == 0
    work = tmp_path / "work"
    work.mkdir()
    out = smoke.scripts_runs(ckpt, frames, torch.device("cpu"), work, ROOT,
                             (tmp_path / "ra.bin").read_bytes(), gop=GOP,
                             wave_batch=4, pin_k=16, eval_size=(H, W))
    sw = out["sweep"]
    rates = [float(r) for r in smoke.SWEEP_RATES.split(",")]
    for name in ("free", "free_procs", "pinned", "pinned_procs"):
        assert [r["idx_rate"] for r in sw[name]["rows"]] == rates, name
        assert sw[name]["wall"]["kernel_launches"] == {
            "rans_encode": 0, "rans_decode": 0, "warp_packed": 0}
    assert sw["free_procs"]["wall"]["procs"] == smoke.SWEEP_PROCS
    for name in ("free", "pinned"):
        assert sw[name]["decode"]["streams"] == len(rates)
    # the tests' size keeps K at 8: workers and one process agree, and a
    # pin of 16 writes other bytes
    assert sw["free_procs"]["bytes_minus_sequential"] == [0] * len(rates)
    assert {k for ks in sw["free"]["ks"] for k in ks} == {8}
    assert {k for ks in sw["pinned"]["ks"] for k in ks} == {16}
    assert [r["bytes"] for r in sw["pinned"]["rows"]] != \
        [r["bytes"] for r in sw["free"]["rows"]]
    ev = out["eval"]
    assert ev["families"] == ["wheel", "bounce", "zoom"]
    assert "low-rate specialist" in ev["make_lowrate"]
    for name in ("flagship", "lowrate"):
        assert len(ev[name]["summary"]) == 4
    assert set(ev["bd"]) == {"bd_rate_pct_vs_ref", "bd_psnr_db_vs_ref",
                             "bd_msssim_db_vs_ref", "ref", "test"}
    assert ev["bd"]["test"] == str(work / "lowrate")
    assert out["latents"]["lines"][0].startswith('{"ckpt": ')
    assert out["motion"]["lines"][1].startswith("raw_flow  p50 ")
    a = out["aivc"]
    assert a["bytes"] == (tmp_path / "ra.bin").stat().st_size
    assert [s.split(":")[0] for s in a["stages"]] == [
        "[aivc] running encode", "[aivc] running decode",
        "[aivc] running evaluate"]
    assert a["results"]["bitstream bytes"] == str(a["bytes"])
    assert "psnr" in a["results"]


def test_workers_disagreeing_fails_the_phase(tmp_path, small_children,
                                             monkeypatch):
    """A pinned worker row that differs from the in-process row raises."""
    from aivc_tpu_torch.scripts import rd_sweep

    real = rd_sweep.fan_out

    def off_by_one(args, device, emit=print):
        rows, wall = real(args, device, emit)
        return [dict(r, bytes=r["bytes"] + 1) for r in rows], wall

    monkeypatch.setattr(rd_sweep, "fan_out", off_by_one)
    ckpt = tiny7(tmp_path / "tiny7")
    frames = synthetic_frames(N, H, W)
    with pytest.raises(AssertionError, match="workers' rows"):
        smoke.scripts_runs(ckpt, frames, torch.device("cpu"), tmp_path,
                           ROOT, b"", gop=GOP, wave_batch=4, pin_k=16,
                           eval_size=(H, W))
