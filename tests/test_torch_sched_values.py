"""The two schedule switches that change the port's values, on the host
(pipeline/codec.py; aivc_tpu/pipeline/codec.py:180-218).

* Encode -> decode is bit-exact under AIVC_GDN_LOWP=0 and under
  AIVC_DC_OFFSET=0 (bf16-r5, 64x64, RA GOP 4, wave batch 2); with bit 4
  clear no frame carries a DC trailer, and a codec with the correction
  on refuses such frames.
* Under AIVC_GDN_LOWP=0 the bf16 model's GDN runs with float32
  parameters and reconstructs otherwise than with them in bf16; it stays
  within 2% bytes and 0.05 dB of JAX's stream under the same switch
  (measured: 595 B both, 0.021 dB).  tiny-toy's stream under
  AIVC_DC_OFFSET=0 equals JAX's byte for byte (measured: 359 B).
"""

import numpy as np
import pytest

import torch

from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu_torch.coding import bitstream as tbs
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.smoke import frame_chunks
from test_torch_dense_v1 import (H, R5, TINY, W, _coding, _jax_codec, env,
                                 models)  # noqa: F401

BYTES_RTOL, PSNR_ATOL = 0.02, 0.05


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _encode_decode(model, frames, **switches):
    with env(**switches):
        codec = FrameCodec(*model, H, W, device="cpu")
    enc = tvideo.encode_video(codec, frames, _coding(), wave_batch=2)
    dec = tvideo.decode_video(codec, enc.bitstream)
    for i in range(len(frames)):
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(dec[i][c],
                                          enc.decoded_frames[i][c])
    return codec, enc


def test_gdn_lowp_off_is_bitexact_and_changes_the_values(models):
    frames = tvideo.synthetic_frames(5, H, W)
    codec, enc = _encode_decode(models["r5"], frames, AIVC_GDN_LOWP="0")
    assert codec.sched_bits == 0x1D
    assert not codec.cfg.codecnet.gdn_lowp and not codec.cfg.mofnet.gdn_lowp
    _, lowp = _encode_decode(models["r5"], frames)
    assert not all(np.array_equal(enc.decoded_frames[i]["y"],
                                  lowp.decoded_frames[i]["y"])
                   for i in range(5))
    with pytest.raises(ValueError, match="AIVC_GDN_LOWP=0"):
        tvideo.decode_video(FrameCodec(*models["r5"], H, W, device="cpu"),
                            enc.bitstream)
    with env(AIVC_GDN_LOWP="0"):
        jcodec = _jax_codec(R5, H, W)
    jenc = jvideo.encode_video(jcodec, frames, JCodingConfig(
        coding_config="RA", gop_size=4, intra_period=4), wave_batch=2)
    ours = tvideo.evaluate_frames(frames, enc.decoded_frames,
                                  device="cpu")["psnr"]
    ref = tvideo.evaluate_frames(frames, jenc.decoded_frames,
                                 device="cpu")["psnr"]
    assert abs(len(enc.bitstream) - len(jenc.bitstream)) <= (
        BYTES_RTOL * len(jenc.bitstream))
    assert abs(ours - ref) <= PSNR_ATOL


def test_dc_offset_off_writes_no_trailer(models):
    frames = tvideo.synthetic_frames(5, H, W)
    codec, enc = _encode_decode(models["r5"], frames, AIVC_DC_OFFSET="0")
    assert codec.sched_bits == 0x0F
    assert all(c.get("__dc__") is None for c in frame_chunks(enc.bitstream))
    _, on = _encode_decode(models["r5"], frames)
    assert all(c.get("__dc__") is not None
               for c in frame_chunks(on.bitstream))
    with pytest.raises(ValueError, match="AIVC_DC_OFFSET=0"):
        tvideo.decode_video(FrameCodec(*models["r5"], H, W, device="cpu"),
                            enc.bitstream)
    # past the header check, frames without a trailer are refused too
    _, gops = tbs.unpack_video(enc.bitstream)
    first = tbs.unpack_gop(gops[0])[1][0]
    with pytest.raises(ValueError, match="no DC trailer"):
        FrameCodec(*models["r5"], H, W, device="cpu").decode_frames_batch(
            [first], [None], [None], 0, 0.0)


def test_dc_offset_off_matches_jax_byte_for_byte(models):
    frames = tvideo.synthetic_frames(5, H, W)
    _, enc = _encode_decode(models["tiny"], frames, AIVC_DC_OFFSET="0")
    with env(AIVC_DC_OFFSET="0"):
        jcodec = _jax_codec(TINY, H, W)
    jenc = jvideo.encode_video(jcodec, frames, JCodingConfig(
        coding_config="RA", gop_size=4, intra_period=4), wave_batch=2)
    assert enc.bitstream == jenc.bitstream
