"""Kernels K1-K3 on the card against their plain versions, and the codec's
closed loop on the card.  Imports no JAX, so it runs on the card's
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
    assert all(v > 0 for v in kernels.LAUNCHES.values())
