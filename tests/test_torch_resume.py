"""Resumable encodes (``stream_dir``) on the host, tiny-toy at 64x64.

A full encode into a fresh directory, then one finished chunk deleted
and the encode run again: the second run re-encodes only what is
missing, re-decodes the rest to rebuild the references, and writes the
same bytes (exact) with the same per-frame results.  For All-Intra with
wave batch 3 a deleted frame sends its whole batch back to the encoder
at the encoder's grouping.  A rerun with other settings is refused.
"""

from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"
H = W = 64
N = 7
CASES = {"RA": (4, 2, "device", 1), "AI": (1, 3, "device", 4),
         "LDP": (4, 1, "host", 0)}   # gop, wave batch, backend, deleted


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_checkpoint(CKPT, device="cpu")


@pytest.fixture(scope="module")
def frames():
    return tvideo.synthetic_frames(N, H, W, seed=4)


def _coding(structure, idx_rate=0.0):
    gop = CASES[structure][0]
    return CodingConfig(coding_config=structure, gop_size=gop,
                        intra_period=gop, idx_rate=idx_rate)


def _encode(model, frames, structure, stream_dir, idx_rate=0.0):
    cfg, m = model
    _, wb, backend, _ = CASES[structure]
    codec = FrameCodec(cfg, m, H, W, device="cpu", entropy_backend=backend)
    return tvideo.encode_video(codec, frames, _coding(structure, idx_rate),
                               wave_batch=wb, stream_dir=stream_dir)


@pytest.mark.parametrize("structure", list(CASES))
def test_resume_gives_identical_bytes(model, frames, structure, tmp_path):
    ref = _encode(model, frames, structure, None)
    sd = str(tmp_path / "stream")
    first = _encode(model, frames, structure, sd)
    assert first.bitstream == ref.bitstream
    deleted = CASES[structure][3]
    chunk = tmp_path / "stream" / f"gop_{deleted:05d}.bin"
    assert chunk.exists()
    chunk.unlink()
    again = _encode(model, frames, structure, sd)
    assert again.bitstream == ref.bitstream
    assert chunk.exists()
    assert [vars(r) for r in again.frame_results] == \
        [vars(r) for r in ref.frame_results]
    for i in range(N):
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(again.decoded_frames[i][c],
                                          ref.decoded_frames[i][c])


def test_resume_reencodes_only_missing(model, frames, tmp_path):
    """RA GOP 4 (5 frames a GOP, I-frame included) over 7 frames is two
    GOPs: with GOP 0 on disk only GOP 1's frames reach the encoder and
    GOP 0 is decoded instead."""
    sd = str(tmp_path / "stream")
    _encode(model, frames, "RA", sd)
    (tmp_path / "stream" / "gop_00001.bin").unlink()
    cfg, m = model
    codec = FrameCodec(cfg, m, H, W, device="cpu")
    coded, decoded = [], []
    enc_orig, dec_orig = codec.encode_frames_launch, codec.decode_frames_batch

    def enc_spy(frames_u8, *a, **k):
        coded.append(len(frames_u8))
        return enc_orig(frames_u8, *a, **k)

    def dec_spy(fbs, *a, **k):
        decoded.append(len(fbs))
        return dec_orig(fbs, *a, **k)

    # encode_gop launches each wave's encode (then finishes it)
    codec.encode_frames_launch, codec.decode_frames_batch = enc_spy, dec_spy
    tvideo.encode_video(codec, frames, _coding("RA"), wave_batch=2,
                        stream_dir=sd)
    assert sum(decoded) == 5        # GOP 0, from disk
    assert sum(coded) == 5          # GOP 1 (frames 5-9, the tail padded)


@pytest.mark.parametrize("structure", ["RA", "AI"])
def test_resume_replays_the_stream_count_policy(model, frames, structure,
                                                tmp_path):
    """The device backend sizes each wave's stream count K from the
    bytes of the waves before it (FrameCodec._k_hint).  A resumed encode
    decodes the finished GOPs instead, and replays the same updates from
    their stored bytes, so the next GOP sees the same K as in one go
    (the frames here are too small for K to leave 8, so the policy's
    state is compared directly)."""
    cfg, m = model
    _, wb, _, deleted = CASES[structure]
    one_go = FrameCodec(cfg, m, H, W, device="cpu")
    sd = str(tmp_path / "stream")
    tvideo.encode_video(one_go, frames, _coding(structure), wave_batch=wb,
                        stream_dir=sd)
    assert one_go._k_hint
    (tmp_path / "stream" / f"gop_{deleted:05d}.bin").unlink()
    resumed = FrameCodec(cfg, m, H, W, device="cpu")
    tvideo.encode_video(resumed, frames, _coding(structure), wave_batch=wb,
                        stream_dir=sd)
    assert resumed._k_hint == one_go._k_hint
    # decoding alone leaves the policy as it was
    fresh = FrameCodec(cfg, m, H, W, device="cpu")
    data = (tmp_path / "stream" / "gop_00000.bin").read_bytes()
    tvideo._decode_gop_chunk(fresh, data, wb, "device")
    assert fresh._k_hint == {}


def test_mismatched_resume_is_refused(model, frames, tmp_path):
    sd = str(tmp_path / "stream")
    _encode(model, frames, "RA", sd)
    with pytest.raises(ValueError, match="belongs to a different encode"):
        _encode(model, frames, "RA", sd, idx_rate=1.0)
    with pytest.raises(ValueError, match="wave_batch"):
        cfg, m = model
        tvideo.encode_video(FrameCodec(cfg, m, H, W, device="cpu"), frames,
                            _coding("RA"), wave_batch=1, stream_dir=sd)
