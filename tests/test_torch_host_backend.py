"""The host entropy backend, the debug self-checks, the rate audit and
rate priority on the host (tiny-toy, 64x64, 5 frames, RA GOP 4, wave
batch 2).

  * a host-backend encode decodes bit-exactly in the port, through the
    header's BACKEND_HOST flag, and never reaches the rANS wrappers;
  * either codec decodes either backend's stream, bit-exactly;
  * against JAX's host-backend run of the same clip (f32 model): bytes
    within 2%, PSNR within 0.05 dB (measured: 229 B on both sides, PSNR
    gap 2.2e-5 dB);
  * debug: [AC] lines report every chunk lossless, the latent md5 trailer
    travels with the frames, and a corrupted latent is named at decode;
  * audit: the analytic bits equal JAX's audit of the same latents
    within 1e-6 relative (float32 sums in JAX, float64 here; measured
    8.1e-8);
  * rate priority: the stream count equals JAX's _pick_k for the same
    symbol counts and payload hints (exact).
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.config import ModelConfig as JModelConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu.pipeline.codec import FrameCodec as JFrameCodec
from aivc_tpu_torch.coding import bitstream as tbs
from aivc_tpu_torch.coding import vrans
from aivc_tpu_torch.config import FRAME_B, FRAME_I, FRAME_P, CodingConfig
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


def _coding():
    return CodingConfig(coding_config="RA", gop_size=GOP, intra_period=GOP)


@pytest.fixture(scope="module")
def model():
    return load_checkpoint(CKPT, device="cpu")


def _codec(model, **kw):
    cfg, m = model
    return FrameCodec(cfg, m, H, W, device="cpu", **kw)


@pytest.fixture(scope="module")
def frames():
    return tvideo.synthetic_frames(N, H, W)


@pytest.fixture(scope="module")
def host_run(model, frames):
    codec = _codec(model, entropy_backend="host")
    return tvideo.encode_video(codec, frames, _coding(), wave_batch=WAVES)


@pytest.fixture(scope="module")
def device_run(model, frames):
    codec = _codec(model)
    return tvideo.encode_video(codec, frames, _coding(), wave_batch=WAVES)


def _assert_same_frames(dec, enc):
    assert sorted(dec) == sorted(enc.decoded_frames)
    for i in dec:
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(dec[i][c], enc.decoded_frames[i][c])


def test_host_backend_decodes_bitexact(model, host_run):
    header, _ = tbs.unpack_video(host_run.bitstream)
    assert header.backend == tbs.BACKEND_HOST
    assert header.sched == 0x1F and header.wave_batch == WAVES
    dec = tvideo.decode_video(_codec(model, entropy_backend="host"),
                              host_run.bitstream)
    _assert_same_frames(dec, host_run)
    # four length-prefixed chunks a frame; I-frames carry empty MOFNet ones
    fr = tbs.unpack_frame(tbs.unpack_gop(tbs.unpack_video(
        host_run.bitstream)[1][0])[1][0])
    assert fr["mofnet_z"] == b"" and fr["codecnet_z"] and fr["codecnet_y"]


@pytest.mark.parametrize("stream,decoder", [("host", "device"),
                                            ("device", "host")])
def test_cross_backend_decode(model, host_run, device_run, stream, decoder):
    enc = host_run if stream == "host" else device_run
    dec = tvideo.decode_video(_codec(model, entropy_backend=decoder),
                              enc.bitstream)
    _assert_same_frames(dec, enc)


def test_host_backend_never_reaches_rans(model, frames, host_run,
                                         monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("rANS wrapper reached on the host backend")

    monkeypatch.setattr(vrans, "encode_batch", refuse)
    monkeypatch.setattr(vrans, "decode_batch", refuse)
    codec = _codec(model, entropy_backend="host")
    enc = tvideo.encode_video(codec, frames, _coding(), wave_batch=WAVES)
    assert enc.bitstream == host_run.bitstream
    _assert_same_frames(tvideo.decode_video(codec, enc.bitstream), enc)


def test_host_backend_matches_jax(frames, host_run):
    cfg = JModelConfig.from_json((CKPT / "config.json").read_text())
    params = {"params": read_params(CKPT)["params"]}
    jcodec = JFrameCodec(cfg, params, H, W, entropy_backend="host")
    jenc = jvideo.encode_video(
        jcodec, frames, JCodingConfig(coding_config="RA", gop_size=GOP,
                                      intra_period=GOP), wave_batch=WAVES)
    ours = tvideo.evaluate_frames(frames, host_run.decoded_frames,
                                  device="cpu")["psnr"]
    ref = tvideo.evaluate_frames(frames, jenc.decoded_frames,
                                 device="cpu")["psnr"]
    assert abs(len(host_run.bitstream) - len(jenc.bitstream)) <= (
        0.02 * len(jenc.bitstream))
    assert abs(ours - ref) <= 0.05
    assert host_run.bitstream[:tbs.VideoHeader.SIZE] == \
        jenc.bitstream[:tbs.VideoHeader.SIZE]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_debug_self_check_and_trailer(model, frames, backend, capsys):
    codec = _codec(model, entropy_backend=backend, debug=True)
    enc = tvideo.encode_video(codec, frames, _coding(), wave_batch=WAVES)
    out = capsys.readouterr().out
    tag = "[AC]" if backend == "host" else "[AC-dev]"
    lines = [ln for ln in out.splitlines() if ln.startswith(tag)]
    per_frame = 4 if backend == "host" else 1
    # I-frames code two chunks on the host backend
    n_i = sum(r.frame_type == FRAME_I for r in enc.frame_results)
    n_chunks = (per_frame * len(enc.frame_results)
                - (2 * n_i if backend == "host" else 0))
    # the padded tail frame of the last GOP is coded too
    assert len(lines) >= n_chunks
    assert all(ln.endswith("lossless Ok!") for ln in lines)
    for gop in tbs.unpack_video(enc.bitstream)[1]:
        for fb in tbs.unpack_gop(gop)[1]:
            dg = tbs.unpack_frame(fb)["__digests__"]
            assert {"codecnet_z", "codecnet_y"} <= set(dg)
    _assert_same_frames(tvideo.decode_video(codec, enc.bitstream), enc)


def _corrupt_first_frame(data: bytes, edit) -> bytes:
    """Apply ``edit`` (frame chunks dict -> frame chunks dict) to the
    first frame of the first GOP and repack the stream."""
    header, gops = tbs.unpack_video(data)
    gh, fbs = tbs.unpack_gop(gops[0])
    fr = tbs.unpack_frame(fbs[0])
    chunks = {k: v for k, v in fr.items() if not k.startswith("__")}
    chunks = edit(chunks)
    fbs[0] = tbs.pack_frame(chunks, fr["__digests__"], dc=fr["__dc__"])
    return tbs.pack_video(header, [tbs.pack_gop(gh, fbs)] + gops[1:])


def test_debug_names_the_corrupted_latent(model, frames):
    codec = _codec(model, entropy_backend="host", debug=True)
    enc = tvideo.encode_video(codec, frames, _coding(), wave_batch=WAVES)

    def flip_z(chunks):
        z = bytearray(chunks["codecnet_z"])
        z[1] ^= 0x5A            # a byte of the coder's initial state
        return {**chunks, "codecnet_z": bytes(z)}

    bad = _corrupt_first_frame(enc.bitstream, flip_z)
    with pytest.raises(ValueError, match="latent md5 mismatch at frame 0 "
                                         "chunk codecnet_z"):
        tvideo.decode_video(codec, bad)

    # Device backend: tiny-toy's I-frame latents are near-certain symbols,
    # so a flipped stream byte may decode the same; a digest that no
    # longer matches names its latent the same way.
    dcodec = _codec(model, debug=True)
    denc = tvideo.encode_video(dcodec, frames, _coding(), wave_batch=WAVES)
    header, gops = tbs.unpack_video(denc.bitstream)
    gh, fbs = tbs.unpack_gop(gops[0])
    fr = tbs.unpack_frame(fbs[0])
    digests = dict(fr["__digests__"])
    digests["codecnet_y"] = bytes(16)
    fbs[0] = tbs.pack_frame({"codecnet_z": fr["codecnet_z"]}, digests,
                            dc=fr["__dc__"])
    bad = tbs.pack_video(header, [tbs.pack_gop(gh, fbs)] + gops[1:])
    with pytest.raises(ValueError, match="latent md5 mismatch at frame 0 "
                                         "chunk codecnet_y"):
        tvideo.decode_video(dcodec, bad)


@pytest.mark.parametrize("frame_type", [FRAME_I, FRAME_P])
def test_analytic_bits_match_jax_audit(model, frames, frame_type):
    codec = _codec(model, audit=True)
    prev = [codec.ref_to_444(frames[0]), codec.ref_to_444(frames[1])]
    with torch.no_grad():
        w = codec._encode_transforms(frames[2:4], prev, [None, None],
                                     frame_type, 0.0)
    ours = codec._analytic_bits(w).numpy()
    cfg = JModelConfig.from_json((CKPT / "config.json").read_text())
    params = {"params": read_params(CKPT)["params"]}
    jcodec = JFrameCodec(cfg, params, H, W, audit=True)

    def nhwc(t, dt=jnp.int16):
        return jnp.asarray(t.permute(0, 2, 3, 1).numpy(), dt)

    if frame_type == FRAME_I:
        ref = jcodec._audit_i(nhwc(w["z_c"], jnp.float32), nhwc(w["q_c"]),
                              nhwc(w["bins_c"], jnp.uint8))
    else:
        ref = jcodec._audit_pb(
            nhwc(w["z_m"], jnp.float32), nhwc(w["q_m"]),
            nhwc(w["bins_m"], jnp.uint8), nhwc(w["z_c"], jnp.float32),
            nhwc(w["q_c"]), nhwc(w["bins_c"], jnp.uint8))
    ref = np.asarray(ref, np.float64)
    assert ours.dtype == np.float32 and ours.shape == (2,)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    fbs, _, stats = codec.encode_frames_batch(frames[2:4], prev,
                                              [None, None], frame_type, 0.0)
    assert [s["analytic_bits"] for s in stats] == ours.tolist()


def test_rate_priority_picks_k_as_jax(model):
    cfg = JModelConfig.from_json((CKPT / "config.json").read_text())
    params = {"params": read_params(CKPT)["params"]}
    for rp in (False, True):
        ours = _codec(model, rate_priority=rp)
        ref = JFrameCodec(cfg, params, H, W, rate_priority=rp)
        for n_total in (100, 20_000, 600_000, 3_000_000, 40_000_000):
            for hint in (None, 50, 900, 30_000, 2_000_000):
                for c in (ours, ref):
                    c._k_hint = {} if hint is None else {FRAME_B: hint}
                got = ours._pick_k(FRAME_B, n_total)
                assert got == ref._pick_k(FRAME_B, n_total), (rp, n_total,
                                                              hint)
                if rp:
                    assert n_total // got <= 65536 or got == vrans.K_MAX
