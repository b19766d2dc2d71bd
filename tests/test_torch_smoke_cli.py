"""Rehearsal of chip_smoke.py's CLI phase on the host at a tiny size
(tiny-toy, 64x64, 9 frames; the kernel wrappers take their plain
versions there), and of its watches and the rate-priority check."""

from pathlib import Path

import pytest
import torch

from aivc_tpu_torch import smoke
from aivc_tpu_torch.coding import vrans
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.pipeline.video import synthetic_frames
from aivc_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_phase_rehearsed_on_host(tmp_path):
    cfg, model = load_checkpoint(CKPT, device="cpu")
    codec = FrameCodec(cfg, model, 64, 64, device="cpu")
    frames = synthetic_frames(9, 64, 64)
    lib = smoke.code_clip(codec, frames)
    runs = smoke.cli_runs(frames, str(CKPT), tmp_path, torch.device("cpu"),
                          ROOT, lib["bitstream"], print)
    assert set(runs) >= {"ra", "ra-debug", "ai", "ldp", "host", "resume",
                         "resume-again", "priority", "ladder5"}
    assert runs["ra"]["results"]["bitstream bytes"] == str(lib["bytes"])
    for name in ("ra", "ai", "ldp", "host", "resume", "priority"):
        r = runs[name]
        assert r["checked"] == 9, name
        assert {"psnr", "ms-ssim", "encoding fps", "decoding fps",
                "rate bpp"} <= set(r["results"]), name
    assert runs["ladder5"]["checked"] == 2
    for name in ("ra", "ra-debug"):
        assert runs[name]["decode_process"]["results"][
            "enc/dec drift check"] == "identical"
    # only the RA run keeps its reconstructions, for the manifest
    assert "recon" not in runs["ra"] and runs["ai"]["recon"] is None
    for name in ("ra", "priority"):
        assert "container overhead" in runs[name]["results"]
    # the rate-priority stream is smaller: fewer lanes, a smaller flush
    assert int(runs["priority"]["results"]["bitstream bytes"]) <= \
        int(runs["ra"]["results"]["bitstream bytes"])
    # on the host no kernel launches, so RansWatch captures nothing
    assert runs["priority"]["captured"] is None


def test_rans_watch_keeps_the_deepest_launch(monkeypatch):
    seen = []

    def stand_in(sym, rows, table, k, segment_steps=()):
        seen.append(sym.shape[1] // k)
        return vrans.encode_plain(sym, rows, table, k, segment_steps)

    monkeypatch.setattr(vrans, "encode_cuda", stand_in)
    cfg, model = load_checkpoint(CKPT, device="cpu")
    codec = FrameCodec(cfg, model, 64, 64, device="cpu")
    watch = smoke.RansWatch()
    try:
        for steps in (3, 9, 5):
            sym = torch.full((1, 8 * steps), codec._pad_sym["y"],
                             dtype=torch.int32)
            rows = torch.full_like(sym, codec._row_off["y"])
            vrans.encode_cuda(sym, rows, codec.table, 8, (steps,))
    finally:
        watch.close()
    assert vrans.encode_cuda is stand_in
    assert seen == [3, 9, 5]
    assert watch.inputs[0].shape[1] == 8 * 9 and watch.inputs[3] == 8


def test_check_rans_on_rehearsed_on_host():
    cfg, model = load_checkpoint(CKPT, device="cpu")
    codec = FrameCodec(cfg, model, 64, 64, device="cpu",
                       rate_priority=True)
    sym, rows, k, segs = smoke.fused_inputs(codec, 2)
    rec = smoke.check_rans_on((sym, rows, codec.table, k, segs),
                              plain_budget_s=0.05, reps=1)
    assert rec["steps"] == sym.shape[1] // k
    assert 1 <= rec["checked_steps"] <= rec["steps"]
    assert rec["enc_us_per_step"] > 0 and rec["dec_us_per_step"] > 0
