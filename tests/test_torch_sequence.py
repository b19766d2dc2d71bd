"""The rest of the sequence layer on the host (tiny-toy, 64x64, 7 frames):
batched All-Intra (wave batch 3, across GOP boundaries) and LDP (GOP 4),
each decoded bit-exactly in the port and held against JAX's CPU run of
the same clip: bytes within 2%, PSNR within 0.05 dB (f32 model; measured
AI 567 B and LDP 734 B on both sides, PSNR gap 0).  Also the wave_batch cross-check of decode_video and
the resume manifest's keys, which equal JAX's.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.config import ModelConfig as JModelConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu.pipeline.codec import FrameCodec as JFrameCodec
from aivc_tpu_torch.coding import bitstream as tbs
from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, read_params

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"
H = W = 64
N = 7
CASES = {"AI": (1, 3), "LDP": (4, 1)}   # structure -> (gop size, wave batch)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return tvideo.synthetic_frames(N, H, W, seed=2)


@pytest.fixture(scope="module")
def codec():
    cfg, model = load_checkpoint(CKPT, device="cpu")
    return FrameCodec(cfg, model, H, W, device="cpu")


def _coding(cls, structure):
    gop, _ = CASES[structure]
    return cls(coding_config=structure, gop_size=gop, intra_period=gop)


@pytest.fixture(scope="module")
def runs(codec, frames):
    return {s: tvideo.encode_video(codec, frames, _coding(CodingConfig, s),
                                   wave_batch=CASES[s][1])
            for s in CASES}


@pytest.mark.parametrize("structure", list(CASES))
def test_decodes_bitexact(codec, runs, structure):
    enc = runs[structure]
    header, gops = tbs.unpack_video(enc.bitstream)
    assert header.wave_batch == CASES[structure][1]
    if structure == "AI":
        assert len(gops) == N        # one single-frame GOP a frame
    dec = tvideo.decode_video(codec, enc.bitstream)
    assert sorted(dec) == list(range(N))
    for i in range(N):
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(dec[i][c], enc.decoded_frames[i][c])


def test_all_intra_batches_across_gops(codec, frames, runs):
    """Wave batch 3 over 7 I-frames (7 GOPs of one frame) codes the
    batches (0-2), (3-5), (6)."""
    calls = []
    orig = codec.encode_frames_batch

    def spy(frames_u8, *a, **k):
        calls.append(len(frames_u8))
        return orig(frames_u8, *a, **k)

    codec.encode_frames_batch = spy
    try:
        enc = tvideo.encode_video(codec, frames, _coding(CodingConfig, "AI"),
                                  wave_batch=3)
    finally:
        del codec.encode_frames_batch
    assert calls == [3, 3, 1]
    assert enc.bitstream == runs["AI"].bitstream


@pytest.mark.parametrize("structure", list(CASES))
def test_matches_jax(frames, runs, structure, tmp_path):
    cfg = JModelConfig.from_json((CKPT / "config.json").read_text())
    params = {"params": read_params(CKPT)["params"]}
    jcodec = JFrameCodec(cfg, params, H, W, entropy_backend="device")
    jenc = jvideo.encode_video(jcodec, frames,
                               _coding(JCodingConfig, structure),
                               wave_batch=CASES[structure][1],
                               stream_dir=str(tmp_path / "jax"))
    enc = runs[structure]
    ours = tvideo.evaluate_frames(frames, enc.decoded_frames,
                                  device="cpu")["psnr"]
    ref = tvideo.evaluate_frames(frames, jenc.decoded_frames,
                                 device="cpu")["psnr"]
    assert abs(len(enc.bitstream) - len(jenc.bitstream)) <= (
        0.02 * len(jenc.bitstream))
    assert abs(ours - ref) <= 0.05
    assert enc.bitstream[:tbs.VideoHeader.SIZE] == \
        jenc.bitstream[:tbs.VideoHeader.SIZE]
    # the resume manifest has JAX's keys
    codec_cfg, model = load_checkpoint(CKPT, device="cpu")
    tvideo.encode_video(FrameCodec(codec_cfg, model, H, W, device="cpu"),
                        frames, _coding(CodingConfig, structure),
                        wave_batch=CASES[structure][1],
                        stream_dir=str(tmp_path / "port"))
    a = json.loads((tmp_path / "port" / "manifest.json").read_text())
    b = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert a == b
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


@pytest.mark.parametrize("structure", list(CASES))
def test_wave_batch_mismatch_raises(codec, runs, structure):
    enc = runs[structure]
    wb = CASES[structure][1]
    assert sorted(tvideo.decode_video(codec, enc.bitstream,
                                      wave_batch=wb)) == list(range(N))
    with pytest.raises(ValueError, match="does not match the bitstream"):
        tvideo.decode_video(codec, enc.bitstream, wave_batch=wb + 1)
