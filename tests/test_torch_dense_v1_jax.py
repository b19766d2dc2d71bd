"""The dense v1 fused stream (AIVC_VRANS_ELIDE=0) of the port against
JAX's on the same clip (64x64, RA GOP 4, 5 frames, wave batch 2, device
backend, both packages on the host).

tiny-toy (float32): the streams are equal byte for byte (measured:
identical, 365 B).  bf16-r5 is held as the v2 stream is in
test_torch_pipeline.py: bytes within 2%, PSNR within 0.05 dB (measured:
487 B both, 1.0e-3 dB).
"""

import pytest

import torch

from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from test_torch_dense_v1 import (H, N, R5, TINY, W, _coding, _jax_codec,
                                 env, models)  # noqa: F401

BYTES_RTOL, PSNR_ATOL = 0.02, 0.05


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", ["tiny", "r5"])
def test_v1_stream_matches_jax(models, model):
    frames = tvideo.synthetic_frames(N, H, W)
    with env(AIVC_VRANS_ELIDE="0"):
        codec = FrameCodec(*models[model], H, W, device="cpu")
        jcodec = _jax_codec(TINY if model == "tiny" else R5, H, W)
    assert not jcodec.elide
    enc = tvideo.encode_video(codec, frames, _coding(), wave_batch=2)
    jenc = jvideo.encode_video(jcodec, frames, JCodingConfig(
        coding_config="RA", gop_size=4, intra_period=4), wave_batch=2)
    if model == "tiny":
        assert enc.bitstream == jenc.bitstream
    ours = tvideo.evaluate_frames(frames, enc.decoded_frames,
                                  device="cpu")["psnr"]
    ref = tvideo.evaluate_frames(frames, jenc.decoded_frames,
                                 device="cpu")["psnr"]
    assert abs(len(enc.bitstream) - len(jenc.bitstream)) <= (
        BYTES_RTOL * len(jenc.bitstream))
    assert abs(ours - ref) <= PSNR_ATOL
