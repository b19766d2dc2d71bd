"""The whole slice on the host: tiny-toy encode -> decode inside the port
is bit-exact, and its bytes and PSNR stay within a stated tolerance of
the JAX pipeline on the same clip (64x64, RA GOP 4, 5 frames, device
entropy backend, wave batch 2).

Tolerance (f32 model): bytes within 2%, PSNR within 0.05 dB.  Measured on
the CPU: identical frame sizes (373 B in all), PSNR gap 2.2e-5 dB.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from aivc_tpu import gop as jgop
from aivc_tpu.coding import bitstream as jbs
from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.config import ModelConfig as JModelConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu.pipeline.codec import FrameCodec as JFrameCodec
from aivc_tpu_torch import gop as tgop
from aivc_tpu_torch.coding import bitstream as tbs
from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, read_params

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"
H = W = 64
N, GOP, WAVES = 5, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run():
    cfg, model = load_checkpoint(CKPT, device="cpu")
    codec = FrameCodec(cfg, model, H, W, device="cpu")
    frames = tvideo.synthetic_frames(N, H, W)
    coding = CodingConfig(coding_config="RA", gop_size=GOP,
                          intra_period=GOP)
    enc = tvideo.encode_video(codec, frames, coding, wave_batch=WAVES)
    return codec, frames, enc


def test_encode_decode_bitexact(port_run):
    codec, frames, enc = port_run
    dec = tvideo.decode_video(codec, enc.bitstream)
    assert sorted(dec) == list(range(N))
    for i in range(N):
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(dec[i][c],
                                          enc.decoded_frames[i][c])
    header, _ = tbs.unpack_video(enc.bitstream)
    assert header.sched == 0x1F and header.wave_batch == WAVES
    assert header.backend == tbs.BACKEND_DEVICE


def test_matches_jax_pipeline(port_run):
    _, frames, enc = port_run
    cfg = JModelConfig.from_json((CKPT / "config.json").read_text())
    params = {"params": read_params(CKPT)["params"]}
    jcodec = JFrameCodec(cfg, params, H, W, entropy_backend="device")
    jenc = jvideo.encode_video(
        jcodec, frames, JCodingConfig(coding_config="RA", gop_size=GOP,
                                      intra_period=GOP), wave_batch=WAVES)
    ours = tvideo.evaluate_frames(frames, enc.decoded_frames,
                                  device="cpu")["psnr"]
    ref = tvideo.evaluate_frames(frames, jenc.decoded_frames,
                                 device="cpu")["psnr"]
    assert abs(len(enc.bitstream) - len(jenc.bitstream)) <= (
        0.02 * len(jenc.bitstream))
    assert abs(ours - ref) <= 0.05
    # the header is the same bytes
    assert enc.bitstream[:tbs.VideoHeader.SIZE] == (
        jenc.bitstream[:jbs.VideoHeader.SIZE])


def test_decoder_refuses_mismatched_streams(port_run):
    codec, _, enc = port_run
    data = bytearray(enc.bitstream)
    data[21] = 0x0F            # another compute schedule
    with pytest.raises(ValueError, match="schedule"):
        tvideo.decode_video(codec, bytes(data))
    data = bytearray(enc.bitstream)
    data[20] = 6               # another alphabet
    with pytest.raises(ValueError, match="alphabet"):
        tvideo.decode_video(codec, bytes(data))


@pytest.mark.parametrize("name", ["1_GOP_0", "LDP_4", "1_GOP_8", "2_GOP_16"])
def test_gop_schedules_match(name):
    ours, ref = tgop.generate_gop_struct(name), jgop.generate_gop_struct(name)
    assert [tuple(vars(f).values()) for f in ours.frames] == [
        tuple(vars(f).values()) for f in ref.frames]
    for wb in (1, 2, 8):
        a = [(t, [s.idx for s in sp]) for t, sp in tvideo.wave_groups(ours, wb)]
        b = [(t, [s.idx for s in sp]) for t, sp in jvideo.wave_groups(ref, wb)]
        assert a == b


def test_containers_match():
    chunks = {"codecnet_z": b"\x81\x01\x02abc", "mofnet_z": b"xyz"}
    fb = tbs.pack_frame(chunks, None, dc=(3, -4, 127))
    assert fb == jbs.pack_frame(chunks, None, dc=(3, -4, 127))
    assert tbs.unpack_frame(fb) == jbs.unpack_frame(fb)
    gh = tbs.GopHeader("1_GOP_8", 1.5)
    assert gh.pack() == jbs.GopHeader("1_GOP_8", 1.5).pack()
    vh = dict(h_x=1080, w_x=1920, h_y=68, w_y=120, h_z=17, w_z=30,
              nb_gop=3, idx_first_frame=0, idx_last_frame=32, backend=1,
              wave_batch=8, ac_log2=6, sched=0x1F)
    assert tbs.VideoHeader(**vh).pack() == jbs.VideoHeader(**vh).pack()
    video = tbs.pack_video(tbs.VideoHeader(**vh), [gh.pack() + fb] * 3)
    assert video == jbs.pack_video(jbs.VideoHeader(**vh),
                                   [gh.pack() + fb] * 3)


def test_yuv_io_round_trip_matches(tmp_path):
    from aivc_tpu.io import yuv as jyuv
    from aivc_tpu_torch.io import yuv as tyuv

    frames = tvideo.synthetic_frames(3, 18, 22, seed=3)
    path = tmp_path / "clip_22x18_25_420.yuv"
    with tyuv.YuvWriter(path) as w:
        for f in frames:
            w.write_frame(f)
    assert tyuv.parse_geometry(path) == jyuv.parse_geometry(path)
    ours, ref = tyuv.YuvReader(path), jyuv.YuvReader(path)
    assert ours.n_frames == ref.n_frames == 3
    for i, f in enumerate(frames):
        a, b = ours.read_frame(i), ref.read_frame(i)
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(a[c], b[c])
            np.testing.assert_array_equal(a[c], f[c])
