"""The dense v1 fused stream (AIVC_VRANS_ELIDE=0) on the host, against
aivc_tpu (pipeline/codec.py:243-248, 357-367, 1184-1200, 1650-1690).

* v1 chunk bytes equal JAX's ``encode_chunk`` / ``serialize_chunk`` for
  the same symbols, rows and K, and each package parses the other's.
* The dense segment plan ``_fused_n`` equals JAX's for I, P and B frames
  at 64x64 and 1080p, at every K, and the stream count of a v1 wave
  (``_pick_k`` with the dense total) equals JAX's ``_pick_k`` under the
  same byte hints.
* Encode -> decode is bit-exact under AIVC_VRANS_ELIDE=0 on tiny-toy
  (float32) and bf16-r5, 64x64, RA GOP 4, wave batch 2 and 3; every
  chunk is v1.  The whole stream against JAX's: test_torch_dense_v1_jax.py.
* A wave that mixes v1 and v2 chunks raises JAX's error; a resumed v1
  encode writes the same bytes and replays the stream-count policy; the
  host backend writes no fused stream, switch or not.
"""

from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu.coding import vrans as jv
from aivc_tpu.config import ModelConfig as JModelConfig
from aivc_tpu.pipeline.codec import FrameCodec as JFrameCodec
from aivc_tpu_torch.coding import bitstream as tbs
from aivc_tpu_torch.coding import vrans as tv
from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.smoke import switched as env
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, read_params

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "models_ckpt" / "tiny-toy"
R5 = ROOT / "models_ckpt" / "bf16-r5"
H = W = 64
N = 5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return {name: load_checkpoint(path, device="cpu")
            for name, path in (("tiny", TINY), ("r5", R5))}


def _jax_codec(ckpt: Path, h: int, w: int):
    cfg = JModelConfig.from_json((ckpt / "config.json").read_text())
    params = {"params": read_params(ckpt)["params"]}
    return JFrameCodec(cfg, params, h, w, entropy_backend="device")


def _coding(gop=4, structure="RA"):
    return CodingConfig(coding_config=structure, gop_size=gop,
                        intra_period=gop)


@pytest.mark.parametrize("n", [700, 5000, 40000])
def test_v1_chunk_bytes_equal_jax(n):
    rng = np.random.default_rng(n)
    cdf = np.asarray(FrameCodec(*load_checkpoint(TINY, device="cpu"), H, W,
                                device="cpu").fused_rows)
    enc = jv.make_enc_tables(cdf)
    rows = rng.integers(0, cdf.shape[0], n).astype(np.int32)
    freq = np.diff(cdf.astype(np.int64), axis=1)
    sym = np.array([rng.choice(freq.shape[1], p=freq[r] / freq[r].sum())
                    for r in rows[:64]] * (n // 64 + 1))[:n].astype(np.int32)
    ref = jv.encode_chunk(sym, rows, enc)

    k = tv.pick_k(n)
    _, n_pad = tv.plan(n, k)
    s = np.full(n_pad, enc.pad_sym, np.int32)
    r = np.zeros(n_pad, np.int32)
    s[:n], r[:n] = sym, rows
    table = tv.make_table(cdf, "cpu")
    buf, states, seg_g = tv.encode_plain(torch.from_numpy(s)[None],
                                         torch.from_numpy(r)[None], table, k)
    words = buf[0, int(seg_g[0, 0]):].numpy()
    ours = tv.serialize_chunk(k, states[0].numpy(), words)
    assert ours == ref
    assert not ours[0] & tv.CHUNK_V2
    w, st, kk = tv.parse_chunk(ref)
    jw, jst, jk = jv.parse_chunk(ours, n)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(st, jst)
    assert kk == jk == k
    assert tv.parse_chunk_v2(ours)[3] is None
    back, _, _ = tv.decode_plain(torch.from_numpy(w.astype(np.int32))
                                 .to(torch.uint16)[None],
                                 torch.from_numpy(st)[None],
                                 torch.from_numpy(r)[None], table, k)
    np.testing.assert_array_equal(back[0, :n].numpy(), sym)


@pytest.mark.parametrize("size", [(64, 64), (1080, 1920)])
def test_dense_segment_plan_equals_jax(models, size):
    h, w = size
    ours = FrameCodec(*models["r5"], h, w, device="cpu")
    ref = _jax_codec(R5, h, w)
    for ft in (0, 1, 2):                           # I, P, B
        for k in (8, 64, 256, 1024, 2048):
            assert ours._fused_n(ft, k) == ref._fused_n(ft, k), (ft, k)
        for hint in (None, 300, 5000, 40000, 200000):
            for c in (ours, ref):
                c._k_hint = {} if hint is None else {ft: hint}
            n8 = ours._fused_n(ft, 8)[0]
            assert ours._pick_k(ft, n8) == ref._pick_k(ft), (ft, hint)


@pytest.mark.parametrize("model,wave_batch", [("tiny", 2), ("tiny", 3),
                                              ("r5", 2), ("r5", 3)])
def test_v1_encode_decode_bitexact(models, model, wave_batch):
    frames = tvideo.synthetic_frames(N, H, W, seed=wave_batch)
    with env(AIVC_VRANS_ELIDE="0"):
        codec = FrameCodec(*models[model], H, W, device="cpu")
    assert not codec.elide
    enc = tvideo.encode_video(codec, frames, _coding(), wave_batch=wave_batch)
    dec = tvideo.decode_video(codec, enc.bitstream)
    for i in range(N):
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(dec[i][c],
                                          enc.decoded_frames[i][c])
    _, gops = tbs.unpack_video(enc.bitstream)
    for g in gops:
        for fb in tbs.unpack_gop(g)[1]:
            payload = tbs.unpack_frame(fb)["codecnet_z"]
            assert not payload[0] & tv.CHUNK_V2          # dense v1 chunk
    # a codec that elides decodes the v1 stream too: the format is read
    # from the chunks
    dec2 = tvideo.decode_video(FrameCodec(*models[model], H, W,
                                          device="cpu"), enc.bitstream)
    for i in range(N):
        np.testing.assert_array_equal(dec2[i]["y"], dec[i]["y"])


def test_mixed_wave_raises(models):
    frames = tvideo.synthetic_frames(2, H, W)
    v2 = FrameCodec(*models["tiny"], H, W, device="cpu")
    with env(AIVC_VRANS_ELIDE="0"):
        v1 = FrameCodec(*models["tiny"], H, W, device="cpu")
    fb2, _, _ = v2.encode_frames_batch(frames, [None] * 2, [None] * 2, 0,
                                       0.0)
    fb1, _, _ = v1.encode_frames_batch(frames, [None] * 2, [None] * 2, 0,
                                       0.0)
    with pytest.raises(ValueError, match="mixed v1/v2 vrans chunks"):
        v2.decode_frames_batch([fb1[0], fb2[1]], [None] * 2, [None] * 2, 0,
                               0.0)
    with pytest.raises(ValueError, match="mixed v1/v2 vrans chunks"):
        v1.decode_frames_batch([fb2[0], fb1[1]], [None] * 2, [None] * 2, 0,
                               0.0)


def test_resumed_v1_encode(models, tmp_path):
    frames = tvideo.synthetic_frames(7, H, W, seed=4)
    sd = tmp_path / "stream"
    with env(AIVC_VRANS_ELIDE="0"):
        one_go = FrameCodec(*models["tiny"], H, W, device="cpu")
        resumed = FrameCodec(*models["tiny"], H, W, device="cpu")
    full = tvideo.encode_video(one_go, frames, _coding(), wave_batch=2,
                               stream_dir=str(sd))
    (sd / "gop_00001.bin").unlink()
    again = tvideo.encode_video(resumed, frames, _coding(), wave_batch=2,
                                stream_dir=str(sd))
    assert again.bitstream == full.bitstream
    assert resumed._k_hint == one_go._k_hint
    # an eliding encoder may not resume the dense stream
    with pytest.raises(ValueError, match="elide"):
        tvideo.encode_video(FrameCodec(*models["tiny"], H, W, device="cpu"),
                            frames, _coding(), wave_batch=2,
                            stream_dir=str(sd))


def test_host_backend_ignores_the_switch(models):
    frames = tvideo.synthetic_frames(3, H, W)
    out = []
    for elide in ("1", "0"):
        with env(AIVC_VRANS_ELIDE=elide):
            codec = FrameCodec(*models["tiny"], H, W, device="cpu",
                               entropy_backend="host")
        assert not codec.elide
        out.append(tvideo.encode_video(codec, frames, _coding(2),
                                       wave_batch=1).bitstream)
    assert out[0] == out[1]
