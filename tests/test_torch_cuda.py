"""Kernels K1-K5 on the card against their plain versions, the codec's
closed loop and the RD forward's launches on the card.  Imports no JAX, so it runs on the card's
machine:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a card every test skips (the fixture decides, at run time).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from aivc_tpu_torch import kernels
from aivc_tpu_torch.coding import vrans
from aivc_tpu_torch.coding.cdf import build_laplace_table
from aivc_tpu_torch.ops import gdn as tg
from aivc_tpu_torch.ops import warp as tw

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _symbols(rng, cdf, rows):
    slots = rng.integers(0, vrans.PROB_SCALE, size=rows.shape)
    sym = np.empty(rows.shape, np.int32)
    for r in np.unique(rows):
        sel = rows == r
        sym[sel] = np.searchsorted(cdf[r], slots[sel], side="right") - 1
    return sym


@pytest.mark.parametrize("k", [8, 64, 1024, 2048])
@pytest.mark.parametrize("ac", [64, 256])
def test_rans_kernels_match_plain(card, k, ac):
    rng = np.random.default_rng(k + ac)
    cdf = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=ac)
    t = vrans.make_table(cdf, card)
    b, steps = 3, 7
    n = steps * k
    rows = rng.integers(0, cdf.shape[0], size=(b, n)).astype(np.int32)
    sym = torch.from_numpy(_symbols(rng, cdf, rows)).to(card)
    rows_t = torch.from_numpy(rows).to(card)
    segs = (2, 1, 4)
    before = dict(kernels.LAUNCHES)
    buf, st, seg_g = vrans.encode_batch(sym, rows_t, t, k, segs)
    pbuf, pst, pseg = vrans.encode_plain(sym, rows_t, t, k, segs)
    assert kernels.LAUNCHES["rans_encode"] == before["rans_encode"] + 1
    assert torch.equal(st, pst) and torch.equal(seg_g, pseg)
    for i in range(b):
        s = int(seg_g[i, 0])
        assert torch.equal(buf[i, s:], pbuf[i, s:])
    words = torch.zeros((b, n + 16), dtype=torch.uint16, device=card)
    for i in range(b):
        s = int(seg_g[i, 0])
        words[i, :n - s] = buf[i, s:]
    # staged: the first two segments, then the rest from the carry
    n1 = 2 * k
    s1, st1, g1 = vrans.decode_batch(words, st, rows_t[:, :n1].contiguous(),
                                     t, k)
    p1 = vrans.decode_plain(words, st, rows_t[:, :n1].contiguous(), t, k)
    assert all(torch.equal(a, c) for a, c in zip((s1, st1, g1), p1))
    s2, st2, g2 = vrans.decode_batch(words, st1,
                                     rows_t[:, n1:].contiguous(), t, k, g1)
    p2 = vrans.decode_plain(words, st1, rows_t[:, n1:].contiguous(), t, k,
                            g1)
    assert all(torch.equal(a, c) for a, c in zip((s2, st2, g2), p2))
    assert torch.equal(torch.cat([s1, s2], dim=1), sym)
    assert torch.equal(g2.long(), n - seg_g[:, 0].long())


@pytest.mark.parametrize("shape", [(1, 64, 128), (3, 72, 200)])
def test_warp_kernel_bit_identical(card, shape):
    g = torch.Generator().manual_seed(shape[2])
    packed = torch.randint(0, 1 << 24, shape, generator=g,
                           dtype=torch.int32).to(card)
    u = ((torch.rand(shape, generator=g) * 2 - 1) * 40).to(card)
    v = ((torch.rand(shape, generator=g) * 2 - 1) * 40).to(card)
    out = tw.mc_warp(packed, u, v, "bounded")
    ref = tw.warp_packed(packed, u, v)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_wrappers_reject_bad_inputs(card):
    packed = torch.zeros((1, 8, 8), dtype=torch.int64, device=card)
    u = torch.zeros((1, 8, 8), device=card)
    with pytest.raises(ValueError):
        tw.warp_packed_cuda(packed, u, u)
    t = vrans.make_table(build_laplace_table(scale=vrans.PROB_SCALE,
                                             ac_max=64), card)
    sym = torch.zeros((1, 100), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        vrans.encode_cuda(sym, sym, t, 64)


def test_codec_closed_loop_on_card(card):
    from aivc_tpu_torch.config import CodingConfig
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline import video
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(ROOT / "models_ckpt" / "bf16-r5",
                                 device=card)
    codec = FrameCodec(cfg, model, 128, 192, device=card)
    frames = video.synthetic_frames(5, 128, 192)
    kernels.reset_launches()
    enc = video.encode_video(codec, frames, CodingConfig(
        coding_config="RA", gop_size=4, intra_period=4), wave_batch=2)
    dec = video.decode_video(codec, enc.bitstream)
    for i in range(5):
        for c in ("y", "u", "v"):
            assert np.array_equal(dec[i][c], enc.decoded_frames[i][c])
    assert all(kernels.LAUNCHES[k] > 0
               for k in ("rans_encode", "rans_decode", "warp_packed"))


@pytest.mark.parametrize("shape", [(1, 3, 64, 128), (2, 5, 72, 256)])
def test_warp_vclamped_kernel_bit_identical(card, shape):
    g = torch.Generator().manual_seed(shape[3])
    x = torch.randn(shape, generator=g).to(card)
    b, _, h, w = shape
    flow = ((torch.rand((b, 2, h, w), generator=g) * 2 - 1)
            * torch.tensor([50.0, 30.0]).view(1, 2, 1, 1)).to(card)
    before = kernels.LAUNCHES["warp_vclamped"]
    out = tw.warp_vclamped_cuda(x, flow)
    assert kernels.LAUNCHES["warp_vclamped"] == before + 1
    ref = tw.warp_vclamped(x, flow)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 32, 48), (2, 256, 10, 30)])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_bit_identical(card, dtype, shape, inverse):
    g = torch.Generator().manual_seed(shape[1] + shape[3])
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2).to(dtype).to(card)
    beta_r = (torch.rand(c, generator=g) + 0.5).sqrt().to(card)
    gamma_r = (torch.rand((c, c), generator=g) * 0.05).sqrt().to(card)
    beta, gamma = tg.reparam(beta_r, gamma_r)
    out = tg.gdn_fused_cuda(x, beta, gamma, inverse)
    ref = tg.gdn_fused_plain(x, beta, gamma, inverse)
    assert out.dtype == dtype and torch.equal(out, ref)


def test_gdn_fused_routes_on_card(card):
    """Rows % 512 == 0 and C % 128 == 0 launch K4; other shapes are
    gdn_apply, as gdn_pallas's shape rule says."""
    g = torch.Generator().manual_seed(0)
    beta_r = (torch.rand(128, generator=g) + 0.5).to(card)
    gamma_r = (torch.rand((128, 128), generator=g) * 0.2).to(card)
    before = kernels.LAUNCHES["gdn_fused"]
    tg.gdn_fused(torch.randn((1, 128, 16, 32), generator=g).to(card),
                 beta_r, gamma_r)
    assert kernels.LAUNCHES["gdn_fused"] == before + 1
    x = torch.randn((1, 128, 10, 10), generator=g).to(card)
    assert torch.equal(tg.gdn_fused(x, beta_r, gamma_r),
                       tg.gdn_apply(x, beta_r, gamma_r, False))
    assert kernels.LAUNCHES["gdn_fused"] == before + 1


def test_new_wrappers_reject_bad_inputs(card):
    x = torch.zeros((1, 3, 64, 128), device=card, requires_grad=True)
    flow = torch.zeros((1, 2, 64, 128), device=card)
    with pytest.raises(ValueError):
        tw.warp_vclamped_cuda(x, flow)
    with pytest.raises(ValueError):
        tw.warp_vclamped_cuda(torch.zeros((1, 3, 64, 200), device=card),
                              torch.zeros((1, 2, 64, 200), device=card))
    beta = torch.ones(96, device=card)
    with pytest.raises(ValueError):
        tg.gdn_fused_cuda(torch.zeros((1, 96, 8, 64), device=card), beta,
                          torch.eye(96, device=card), False)
    with pytest.raises(ValueError):
        tg.gdn_fused_cuda(torch.zeros((1, 128, 8, 64), device=card,
                                      dtype=torch.float16),
                          torch.ones(128, device=card),
                          torch.eye(128, device=card), False)
    with pytest.raises(ValueError):     # forward only
        tg.gdn_fused_cuda(torch.zeros((1, 128, 8, 64), device=card,
                                      requires_grad=True),
                          torch.ones(128, device=card),
                          torch.eye(128, device=card), False)


def test_rd_forward_launches_on_card(card, monkeypatch):
    """The forward launches K5 once per float warp and K4 never (no model
    calls gdn_fused); K4 launches once per captured GDN input in its
    check, each output equal to its plain version."""
    from aivc_tpu_torch import smoke
    from aivc_tpu_torch.pipeline import video
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    monkeypatch.setattr(tw, "_USE_PALLAS", True)
    cfg, model = load_checkpoint(ROOT / "models_ckpt" / "bf16-r5",
                                 device=card)
    # 128x256: every captured GDN input has rows % 512 == 0.
    f444 = video.frames_444(video.synthetic_frames(3, 128, 256), card)
    watch = smoke.GdnWatch(model, capture=smoke.GDN_LAYERS)
    kernels.reset_launches()
    smoke.rd_forward(model, cfg, f444, 1.0, "1_GOP_2")
    watch.close()
    assert kernels.LAUNCHES["warp_vclamped"] == smoke.warp_calls("1_GOP_2")
    assert kernels.LAUNCHES["gdn_fused"] == 0
    rec = smoke.check_gdn(watch.inputs, reps=1)
    assert rec["launches"] == len(smoke.GDN_LAYERS)
    assert rec["max_abs_err"] == 0.0
