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


@pytest.mark.parametrize("k", [8, 16, 32, 64, 128, 256, 512, 1024, 2048])
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


def _encoded(card, k, steps, b, ac=64, seed=0):
    """A table and b chunks of steps * k symbols, encoded by the plain
    version: (table, rows, sym, words from offset 0 [b, n], states, g)."""
    rng = np.random.default_rng(seed)
    cdf = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=ac)
    t = vrans.make_table(cdf, card)
    n = steps * k
    rows = rng.integers(0, cdf.shape[0], size=(b, n)).astype(np.int32)
    sym = torch.from_numpy(_symbols(rng, cdf, rows)).to(card)
    rows_t = torch.from_numpy(rows).to(card)
    buf, st, seg_g = vrans.encode_plain(sym, rows_t, t, k)
    total = n - seg_g[:, 0].long()
    words = torch.zeros((b, int(total.max())), dtype=torch.uint16,
                        device=card)
    for i in range(b):
        words[i, :int(total[i])] = buf[i, int(seg_g[i, 0]):]
    return t, rows_t, sym, words, st, total


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("k", [8, 256, 2048])
def test_rans_decode_words_end_at_w_cap(card, k):
    """w_cap is the longest chunk's word count exactly, then one word
    short of it (an odd width: the ring's plain-copy path), where the
    last word reads as 0, as in the plain version."""
    t, rows, sym, words, st, _ = _encoded(card, k, 9, 3, seed=k)
    out = vrans.decode_cuda(words, st, rows, t, k)
    assert _same(out, vrans.decode_plain(words, st, rows, t, k))
    assert torch.equal(out[0], sym)
    for w in (words[:, :-1].contiguous(), words[:, :-2].contiguous()):
        out = vrans.decode_cuda(w, st, rows, t, k)
        assert _same(out, vrans.decode_plain(w, st, rows, t, k))


@pytest.mark.parametrize("n_seg", [2, 3, 4])
@pytest.mark.parametrize("k", [64, 2048])
def test_rans_decode_resumed_over_segments(card, n_seg, k):
    """A chunk decoded over n_seg launches, each resuming from the last
    one's (states, g); the words start at a nonzero offset g0."""
    t, rows, sym, words, st, _ = _encoded(card, k, 11, 2, seed=n_seg)
    pad = 37
    shifted = torch.zeros((2, pad + words.shape[1] + 5), dtype=torch.uint16,
                          device=card)
    shifted[:, :pad] = 0xBEEF
    shifted[:, pad:pad + words.shape[1]] = words
    g = torch.full((2,), pad, dtype=torch.int32, device=card)
    cuts = np.linspace(0, 11, n_seg + 1).round().astype(int) * k
    x, got = st, []
    for a, b in zip(cuts[:-1], cuts[1:]):
        seg = rows[:, a:b].contiguous()
        before = kernels.STEPS["rans_decode"]
        out = vrans.decode_cuda(shifted, x, seg, t, k, g)
        assert kernels.STEPS["rans_decode"] == before + (b - a) // k
        assert _same(out, vrans.decode_plain(shifted, x, seg, t, k, g))
        got.append(out[0])
        _, x, g = out
    assert torch.equal(torch.cat(got, dim=1), sym)


@pytest.mark.parametrize("k", [8, 2048])
def test_rans_decode_single_step(card, k):
    t, rows, sym, words, st, _ = _encoded(card, k, 1, 4, seed=1)
    out = vrans.decode_cuda(words, st, rows, t, k)
    assert _same(out, vrans.decode_plain(words, st, rows, t, k))
    assert torch.equal(out[0], sym)


def _decode_table(card, cdf, k, steps=4, b=2, seed=3):
    """Encode b chunks with table cdf by the plain version, then decode
    them by K2: equal to decode_plain's symbols, states and g."""
    t = vrans.make_table(cdf, card)
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cdf.shape[0], size=(b, steps * k)).astype(np.int32)
    sym = torch.from_numpy(_symbols(rng, cdf, rows)).to(card)
    rows_t = torch.from_numpy(rows).to(card)
    buf, st, seg_g = vrans.encode_plain(sym, rows_t, t, k)
    words = torch.zeros((b, steps * k), dtype=torch.uint16, device=card)
    for i in range(b):
        s = int(seg_g[i, 0])
        words[i, :steps * k - s] = buf[i, s:]
    out = vrans.decode_cuda(words, st, rows_t, t, k)
    assert _same(out, vrans.decode_plain(words, st, rows_t, t, k))
    assert torch.equal(out[0], sym)
    return t, words, st, rows_t


def _smem(n_rows, n_sym, k):
    """K2's shared memory for the layout decode_layout picks, in bytes;
    the kernel's own count must agree with coding/vrans.py's."""
    wide, bits = vrans.decode_layout(n_rows, n_sym)
    ix = torch.empty((), dtype=vrans.index_format(n_sym)[1]).element_size()
    c = kernels.lib().aivc_rans_decode_smem_bytes(n_rows, n_sym, k, ix, bits,
                                                  int(wide))
    assert c == vrans.decode_smem_bytes(n_rows, n_sym, k, wide, bits)
    return c


def _tiled(rows, n_rows):
    return np.tile(rows, (-(-n_rows // rows.shape[0]), 1))[:n_rows]


def test_rans_decode_table_at_the_shared_memory_limit(card):
    """The most rows of 128 symbols that fit a block at K = 2048 (the
    cdf16 layout, the index down to 0 bits: a search of the whole row)
    decode like the plain version; one row more raises."""
    k = 2048
    lap = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=64)
    n_sym = lap.shape[1] - 1
    n_rows = 1
    while _smem(n_rows + 1, n_sym, k) <= kernels.MAX_SMEM:
        n_rows += 1
    assert vrans.decode_layout(n_rows, n_sym) == (False, 0)
    _, words, st, rows_t = _decode_table(card, _tiled(lap, n_rows), k)
    big = vrans.make_table(_tiled(lap, n_rows + 1), card)
    with pytest.raises(ValueError):
        vrans.decode_cuda(words, st, rows_t, big, k)


def _layout_tables():
    """(name, CDF rows, expected decode_layout): the checkpoints' fused
    tables (ac 128 and 256, from tests/data/fused_freqs.npz, which
    tests/test_torch_rans_index.py holds equal to the checkpoints), the
    largest ac 64 table of the wide layout and the next, of cdf16."""
    freqs = np.load(ROOT / "tests" / "data" / "fused_freqs.npz")
    for key, expect in (("bf16_r4m", (False, 8)), ("bf16_r3", (False, 5))):
        f = freqs[key].astype(np.int64)
        yield key, np.concatenate([np.zeros((f.shape[0], 1), np.int64),
                                   np.cumsum(f, axis=1)], axis=1), expect
    lap = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=64)
    n_rows = 1
    while vrans.decode_layout(n_rows + 1, 128)[0]:
        n_rows += 1
    yield "wide-limit", _tiled(lap, n_rows), (True, 9)
    yield "narrow-next", _tiled(lap, n_rows + 1), (False, 9)


@pytest.mark.parametrize("k", [64, 2048])
@pytest.mark.parametrize("name,cdf,expect", list(_layout_tables()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_rans_decode_each_layout_matches_plain(card, name, cdf, expect, k):
    """K2 on tables of both layouts, bit-identical to decode_plain: the
    fused tables of bf16-r4m and bf16-r3 (too large for start_freq
    beside their index) and the tables either side of the switch."""
    n_rows, n_sym = cdf.shape[0], cdf.shape[1] - 1
    assert vrans.decode_layout(n_rows, n_sym) == expect
    assert _smem(n_rows, n_sym, k) <= kernels.MAX_SMEM
    _decode_table(card, cdf, k, seed=k)


def _encode_matches_plain(card, cdf, k, steps, b, segs=(), seed=0,
                          sym_range=None):
    """K1 on b chunks of steps * k symbols (drawn from their rows, or
    uniformly from sym_range), bit-identical to encode_plain: states,
    segment cursors and every chunk's words.  Returns seg_g."""
    rng = np.random.default_rng(seed)
    t = vrans.make_table(cdf, card)
    n = steps * k
    rows = rng.integers(0, cdf.shape[0], size=(b, n)).astype(np.int32)
    sym = (_symbols(rng, cdf, rows) if sym_range is None else
           rng.integers(*sym_range, size=(b, n)).astype(np.int32))
    sym_t = torch.from_numpy(sym).to(card)
    rows_t = torch.from_numpy(rows).to(card)
    launches = kernels.LAUNCHES["rans_encode"]
    walked = kernels.STEPS["rans_encode"]
    buf, st, seg_g = vrans.encode_cuda(sym_t, rows_t, t, k, segs)
    assert kernels.LAUNCHES["rans_encode"] == launches + 1
    assert kernels.STEPS["rans_encode"] == walked + steps
    pbuf, pst, pseg = vrans.encode_plain(sym_t, rows_t, t, k, segs)
    assert torch.equal(st, pst) and torch.equal(seg_g, pseg)
    for i in range(b):
        s = int(seg_g[i, 0])
        assert torch.equal(buf[i, s:], pbuf[i, s:])
    return seg_g


def test_rans_encode_wave_batch_8(card):
    """The clip's wave batch: 8 chunks at K = 2048 over four segments."""
    cdf = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=64)
    _encode_matches_plain(card, cdf, 2048, 13, 8, (3, 4, 5, 1), seed=8)


@pytest.mark.parametrize("segs", [(6,), (5, 1), (1, 3, 2), (2, 1, 1, 2)])
@pytest.mark.parametrize("k", [8, 64, 2048])
def test_rans_encode_segments(card, segs, k):
    """1 to 4 segments, with segments of one step, first and last."""
    cdf = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=64)
    _encode_matches_plain(card, cdf, k, sum(segs), 3, segs, seed=len(segs))


@pytest.mark.parametrize("k", [1, 8, 32, 2048])
def test_rans_encode_single_step(card, k):
    cdf = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=64)
    _encode_matches_plain(card, cdf, k, 1, 5, seed=k)


def _one_row(freqs):
    return np.concatenate([[0], np.cumsum(freqs)])[None].astype(np.int64)


@pytest.mark.parametrize("k", [8, 2048])
def test_rans_encode_every_lane_emits(card, k):
    """Symbols of frequency 1: x >= 1 << 16 always holds, so every lane
    emits a word at every step and the chunk has n_pad words."""
    cdf = _one_row([1] * 127 + [vrans.PROB_SCALE - 127])
    seg_g = _encode_matches_plain(card, cdf, k, 9, 3, (4, 5), seed=1,
                                  sym_range=(0, 127))
    assert torch.equal(seg_g[:, 0], torch.zeros_like(seg_g[:, 0]))
    assert torch.equal(seg_g[:, 1], torch.full_like(seg_g[:, 1], 4 * k))


@pytest.mark.parametrize("k", [8, 2048])
def test_rans_encode_no_lane_emits(card, k):
    """One symbol holds all but one slot of the row: the states grow by
    ~1 / 65535 a step and never reach freq << 16, so no word is
    emitted."""
    cdf = _one_row([vrans.PROB_SCALE - 1, 1])
    steps = 9
    seg_g = _encode_matches_plain(card, cdf, k, steps, 3, (4, 5), seed=2,
                                  sym_range=(0, 1))
    assert torch.equal(seg_g, torch.full_like(seg_g, steps * k))


@pytest.mark.parametrize("k", [64, 2048])
@pytest.mark.parametrize("key", ["bf16_r4m", "bf16_r3"])
def test_rans_encode_checkpoint_tables(card, key, k):
    """The fused tables of bf16-r4m (ac 128) and bf16-r3 (ac 256) from
    tests/data/fused_freqs.npz: the largest tables K1 holds in shared
    memory."""
    f = np.load(ROOT / "tests" / "data" / "fused_freqs.npz")[key]
    cdf = np.concatenate([np.zeros((f.shape[0], 1), np.int64),
                          np.cumsum(f.astype(np.int64), axis=1)], axis=1)
    _encode_matches_plain(card, cdf, k, 5, 3, (2, 3), seed=k)


@pytest.mark.parametrize("b", [4, 16])
def test_rans_encode_table_at_the_shared_memory_limit(card, b):
    """The most rows of 128 symbols that fit beside the ring of a one-warp
    block (MAX_SMEM - 4096 bytes of table): K1 shrinks pass A's block to
    fit them, at the batch that picks 64 threads and the one that picks
    256, and matches encode_plain; one row more raises."""
    k = 2048
    lap = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=64)
    n_sym = lap.shape[1] - 1
    n_rows = (kernels.MAX_SMEM - 4096) // (2 * n_sym)
    lib = kernels.lib()
    assert lib.aivc_rans_encode_smem_bytes(n_rows, n_sym) <= kernels.MAX_SMEM
    assert lib.aivc_rans_encode_smem_bytes(n_rows + 1, n_sym) > \
        kernels.MAX_SMEM
    _encode_matches_plain(card, _tiled(lap, n_rows), k, 3, b, (1, 2), seed=b)
    big = vrans.make_table(_tiled(lap, n_rows + 1), card)
    sym = torch.zeros((b, 3 * k), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        vrans.encode_cuda(sym, sym, big, k)


def _warp_matches_plain(card, packed, u, v):
    """K3 through its wrapper, bit-identical to warp_packed."""
    before = kernels.LAUNCHES["warp_packed"]
    out = tw.warp_packed_cuda(packed, u, v)
    assert kernels.LAUNCHES["warp_packed"] == before + 1
    ref = tw.warp_packed(packed, u, v)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("shape", [(4, 1, 197), (4, 1, 1), (4, 5, 197),
                                   (2, 9, 1), (4, 1, 64)])
def test_warp_kernel_ragged_width(card, shape):
    """Widths that are not a multiple of 4 (pixel by pixel), one row, one
    column."""
    g = torch.Generator().manual_seed(shape[1] * 1000 + shape[2])
    packed = torch.randint(0, 1 << 24, shape, generator=g,
                           dtype=torch.int32).to(card)
    u = ((torch.rand(shape, generator=g) * 2 - 1) * 38).to(card)
    v = ((torch.rand(shape, generator=g) * 2 - 1) * 38).to(card)
    _warp_matches_plain(card, packed, u, v)


def test_warp_kernel_flows_hit_every_border(card):
    """Flows of +-38 (and +-37.5, +-0.25) on a 40 x 64 frame: sample
    coordinates beyond all four borders, clamped as in the plain
    version."""
    b, h, w = 4, 40, 64
    g = torch.Generator().manual_seed(38)
    packed = torch.randint(0, 1 << 24, (b, h, w), generator=g,
                           dtype=torch.int32)
    vals = torch.tensor([-38.0, 38.0, -37.5, 37.5, -0.25, 0.25, 0.0])
    u = vals[torch.randint(0, len(vals), (b, h, w), generator=g)]
    v = vals[torch.randint(0, len(vals), (b, h, w), generator=g)]
    sx = torch.arange(w).view(1, 1, w) + u
    sy = torch.arange(h).view(1, h, 1) + v
    assert (sx < 0).any() and (sx > w - 1).any()
    assert (sy < 0).any() and (sy > h - 1).any()
    _warp_matches_plain(card, packed.to(card), u.to(card), v.to(card))


@pytest.mark.parametrize("w", [128, 197])
def test_warp_kernel_unaligned_base(card, w):
    """Inputs that start 4 bytes into their storage (contiguous views of
    a larger tensor, so not 16-byte aligned: the kernel goes pixel by
    pixel), and strided slices, which mc_warp makes contiguous."""
    b, h = 2, 24
    n = b * h * w
    g = torch.Generator().manual_seed(w)
    big_p = torch.randint(0, 1 << 24, (n + 1,), generator=g,
                          dtype=torch.int32).to(card)
    big_u = ((torch.rand(n + 1, generator=g) * 2 - 1) * 30).to(card)
    big_v = ((torch.rand(n + 1, generator=g) * 2 - 1) * 30).to(card)
    packed, u, v = (t[1:].view(b, h, w) for t in (big_p, big_u, big_v))
    assert packed.data_ptr() % 16 and u.data_ptr() % 16
    _warp_matches_plain(card, packed, u, v)
    wide = torch.stack([big_u[:n].view(b, h, w), big_v[:n].view(b, h, w)],
                       dim=1)
    out = tw.mc_warp(packed, wide[:, 0], wide[:, 1], "bounded")
    ref = tw.warp_packed(packed, wide[:, 0], wide[:, 1])
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


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


def _at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts ``offset`` floats into its
    storage."""
    big = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = big[offset:].view(t.shape)
    out.copy_(t)
    return out


def _vclamped_flow(g, flows, b, h, w):
    if flows == "zero":
        return torch.zeros((b, 2, h, w))
    if flows == "random":
        return ((torch.rand((b, 2, h, w), generator=g) * 2 - 1)
                * torch.tensor([50.0, 30.0]).view(1, 2, 1, 1))
    # Past every border horizontally, and vertically both past the +-15
    # clamp and (near the top and bottom rows) past the frame.
    vals = torch.tensor([-1e4, 1e4, -(w + 3.0), w + 3.0, -15.5, 15.5, -15.0,
                         15.0, -14.75, 14.75, -0.25, 0.25, 0.0])
    return vals[torch.randint(0, len(vals), (b, 2, h, w), generator=g)]


@pytest.mark.parametrize("shape, offset, flows", [
    ((1, 3, 64, 128), 0, "random"), ((2, 5, 72, 256), 0, "random"),
    ((1, 3, 100, 128), 0, "random"),     # H not a multiple of the 8-row tile
    ((3, 3, 64, 128), 0, "random"),      # B = 3
    ((1, 1, 48, 256), 0, "random"), ((2, 3, 40, 384), 0, "random"),
    ((1, 5, 24, 128), 0, "random"),      # C = 1, 3, 5
    ((1, 3, 40, 128), 1, "random"), ((2, 5, 40, 256), 1, "random"),
    ((1, 3, 40, 128), 4, "random"), ((2, 5, 40, 256), 4, "random"),
    ((2, 3, 48, 128), 0, "borders"), ((1, 5, 104, 256), 0, "borders"),
    ((1, 3, 64, 128), 0, "zero"), ((2, 5, 16, 256), 0, "zero")])
def test_warp_vclamped_kernel_bit_identical(card, shape, offset, flows):
    """K5 through its wrapper, and through its launcher into an output
    that starts ``offset`` floats into its storage, bit-identical to
    warp_vclamped.  x and flow start ``offset`` floats in too: bases that
    are 16-byte aligned (0, 4) and bases that are not (1); the kernel
    reads and writes 4 bytes a thread, so it needs no alignment."""
    g = torch.Generator().manual_seed(shape[3])
    b, c, h, w = shape
    x = torch.randn(shape, generator=g)
    flow = _vclamped_flow(g, flows, b, h, w)
    if flows == "borders":
        sx = torch.arange(w).view(1, 1, w) + flow[:, 0]
        sy = torch.arange(h).view(1, h, 1) + flow[:, 1].clamp(-15, 15)
        assert (sx < 0).any() and (sx > w - 1).any()
        assert (sy < 0).any() and (sy > h - 1).any()
        assert (flow[:, 1].abs() > 15).any()
    x, flow = _at_offset(x.to(card), offset), _at_offset(flow.to(card),
                                                         offset)
    assert (flow.data_ptr() % 16 == 0) == (offset % 4 == 0)
    ref = tw.warp_vclamped(x, flow)
    before = kernels.LAUNCHES["warp_vclamped"]
    out = tw.warp_vclamped_cuda(x, flow)
    assert kernels.LAUNCHES["warp_vclamped"] == before + 1
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    raw = _at_offset(torch.zeros_like(ref), offset)
    kernels.check("warp_vclamped", kernels.lib().aivc_warp_vclamped(
        x.data_ptr(), flow.data_ptr(), b, c, h, w, tw.V_RADIUS - 1,
        raw.data_ptr(), kernels.stream_ptr()))
    assert torch.equal(raw.view(torch.int32), ref.view(torch.int32))
    if flows == "zero":
        assert torch.equal(out, x)


@pytest.mark.parametrize("b, h, fits", [
    (65535, 8, True), (65536, 8, False),           # images: grid z
    (1, 65535 * 8, True), (1, 65536 * 8, False)])  # 8-row tiles: grid y
def test_warp_vclamped_grid_limits(card, b, h, fits):
    """K5's launcher refuses a grid of more than 65,535 row tiles or
    images (cudaErrorInvalidValue), and the wrapper raises on it without
    counting a launch; at the limit it runs (zero flow: x itself)."""
    x = torch.arange(b * h * 128, dtype=torch.float32,
                     device=card).view(b, 1, h, 128)
    flow = torch.zeros((b, 2, h, 128), device=card)
    before = kernels.LAUNCHES["warp_vclamped"]
    if fits:
        assert torch.equal(tw.warp_vclamped_cuda(x, flow), x)
        assert kernels.LAUNCHES["warp_vclamped"] == before + 1
    else:
        with pytest.raises(RuntimeError, match="CUDA error 1$"):
            tw.warp_vclamped_cuda(x, flow)
        assert kernels.LAUNCHES["warp_vclamped"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 32, 48), (2, 256, 10, 30)])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_bit_identical(card, dtype, shape, inverse):
    """f32: bit-identical to the plain version.  bf16: the tensor cores
    sum in their own order (as JAX's MXU product does), so within
    smoke.GDN_PLAIN_ULPS = 2 bf16 ulps of it (printed: the measured
    maximum in ulps and relative, and the share of outputs that
    differ)."""
    from aivc_tpu_torch import smoke

    g = torch.Generator().manual_seed(shape[1] + shape[3])
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2).to(dtype).to(card)
    beta_r = (torch.rand(c, generator=g) + 0.5).sqrt().to(card)
    gamma_r = (torch.rand((c, c), generator=g) * 0.05).sqrt().to(card)
    beta, gamma = tg.reparam(beta_r, gamma_r)
    out = tg.gdn_fused_cuda(x, beta, gamma, inverse)
    ref = tg.gdn_fused_plain(x, beta, gamma, inverse)
    assert out.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        ulps = smoke.bf16_ulps(out, ref)
        rel = ((out.float() - ref.float()).abs()
               / ref.float().abs().clamp_min(1e-30)).max()
        print(f"K4 bf16 {shape} inverse={inverse}: {float(ulps.max())} "
              f"ulps, {float(rel):.4e} relative, "
              f"{float((ulps != 0).float().mean()):.3e} differ")
        assert float(ulps.max()) <= smoke.GDN_PLAIN_ULPS
        assert float((ulps != 0).float().mean()) <= smoke.GDN_DIFFERING_SHARE


@pytest.mark.parametrize("shape", [(1, 128, 384, 640), (4, 128, 8, 64),
                                   (1, 384, 24, 40), (3, 128, 7, 9)])
def test_gdn_bf16_kernel_within_two_ulps(card, shape):
    """The tensor-core path at the timed shape, several images, C = 384
    (gamma reloaded per input chunk) and a ragged, unaligned HW."""
    from aivc_tpu_torch import smoke

    g = torch.Generator().manual_seed(shape[0] * 1000 + shape[3])
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2).to(torch.bfloat16).to(card)
    beta_r = (torch.rand(c, generator=g) + 0.5).sqrt().to(card)
    gamma_r = (torch.rand((c, c), generator=g) * 0.05).sqrt().to(card)
    beta, gamma = tg.reparam(beta_r, gamma_r)
    for inverse in (False, True):
        out = tg.gdn_fused_cuda(x, beta, gamma, inverse)
        ref = tg.gdn_fused_plain(x, beta, gamma, inverse)
        ulps = smoke.bf16_ulps(out, ref)
        print(f"K4 bf16 {shape} inverse={inverse}: {float(ulps.max())} "
              f"ulps, {float((ulps != 0).float().mean()):.3e} differ")
        assert float(ulps.max()) <= smoke.GDN_PLAIN_ULPS, (inverse,
                                                           float(ulps.max()))
        assert float((ulps != 0).float().mean()) <= smoke.GDN_DIFFERING_SHARE


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
    check, each (bf16) output within 2 bf16 ulps of its plain version."""
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
    assert rec["max_ulps"] <= smoke.GDN_PLAIN_ULPS


@pytest.mark.parametrize("k,steps,segs", [
    (8, 6000, (1000, 3000, 200, 1800)), (16, 4100, (100, 4000))])
def test_rans_kernels_at_rate_priority_shape(card, k, steps, segs):
    """``--rate_priority`` sends K1 and K2 few lanes (K from 8) and chains
    of thousands of dependent steps (up to 65,536): K1's ring and
    placement and K2's word ring across many refills, bit-identical to
    the plain versions; K2 decodes the chunk in two stages."""
    cdf = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=64)
    _encode_matches_plain(card, cdf, k, steps, 2, segs, seed=k)
    rng = np.random.default_rng(k)
    t = vrans.make_table(cdf, card)
    n = steps * k
    rows = rng.integers(0, cdf.shape[0], size=(2, n)).astype(np.int32)
    sym = torch.from_numpy(_symbols(rng, cdf, rows)).to(card)
    rows_t = torch.from_numpy(rows).to(card)
    buf, st, seg_g = vrans.encode_cuda(sym, rows_t, t, k, segs)
    words = torch.zeros((2, n), dtype=torch.uint16, device=card)
    for i in range(2):
        s = int(seg_g[i, 0])
        words[i, :n - s] = buf[i, s:]
    n1 = segs[0] * k
    launches = kernels.LAUNCHES["rans_decode"]
    a = vrans.decode_cuda(words, st, rows_t[:, :n1].contiguous(), t, k)
    b = vrans.decode_cuda(words, a[1], rows_t[:, n1:].contiguous(), t, k,
                          a[2])
    assert kernels.LAUNCHES["rans_decode"] == launches + 2
    pa = vrans.decode_plain(words, st, rows_t[:, :n1].contiguous(), t, k)
    pb = vrans.decode_plain(words, pa[1], rows_t[:, n1:].contiguous(), t, k,
                            pa[2])
    for x, y in zip(a + b, pa + pb):
        assert torch.equal(x, y)
    assert torch.equal(torch.cat([a[0], b[0]], dim=1), sym)


def _r5_codec(card, h, w, **kw):
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(ROOT / "models_ckpt" / "bf16-r5",
                                 device=card)
    return FrameCodec(cfg, model, h, w, device=card, **kw)


def test_host_backend_on_card_launches_no_rans(card):
    """The host entropy backend on the card: K3 warps the P/B frames, K1
    and K2 never launch, and the stream decodes bit-exactly with either
    codec."""
    from aivc_tpu_torch.config import CodingConfig
    from aivc_tpu_torch.pipeline import video

    frames = video.synthetic_frames(5, 128, 192)
    coding = CodingConfig(coding_config="RA", gop_size=4, intra_period=4)
    codec = _r5_codec(card, 128, 192, entropy_backend="host")
    kernels.reset_launches()
    enc = video.encode_video(codec, frames, coding, wave_batch=2)
    dec = video.decode_video(codec, enc.bitstream)
    assert kernels.LAUNCHES["rans_encode"] == 0
    assert kernels.LAUNCHES["rans_decode"] == 0
    assert kernels.LAUNCHES["warp_packed"] > 0
    other = video.decode_video(_r5_codec(card, 128, 192), enc.bitstream)
    for d in (dec, other):
        for i in range(5):
            for c in ("y", "u", "v"):
                assert np.array_equal(d[i][c], enc.decoded_frames[i][c])


def test_separate_process_decode_on_card(card, tmp_path):
    """``--mode encode`` here, ``--mode decode`` in a second process: the
    md5 manifest reads "identical" and every latent digest matches."""
    import contextlib
    import io
    import os
    import subprocess
    import sys

    from aivc_tpu_torch import cli
    from aivc_tpu_torch.io.yuv import YuvWriter
    from aivc_tpu_torch.pipeline import video

    clip = tmp_path / "clip_192x128_30_420.yuv"
    with YuvWriter(clip) as w:
        for f in video.synthetic_frames(9, 128, 192):
            w.write_frame(f)
    args = ["-i", str(clip), "-o", str(tmp_path / "dec.yuv"),
            "--bitstream_out", str(tmp_path / "clip.bin"),
            "--coding_config", "RA", "--gop_size", "8", "--intra_period",
            "8", "--model", str(ROOT / "models_ckpt" / "bf16-r5"),
            "--wave_batch", "8", "--bitstream_debug"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(args + ["--mode", "encode"]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "aivc_tpu_torch", *args, "--mode", "decode"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert "enc/dec drift check  : identical" in proc.stdout


# ---------------------------------------------------------------------------
# Training path on the card: no kernel lies on it; the card's autograd
# against the host's.
# ---------------------------------------------------------------------------

def test_lower_bound_on_card_equals_host(card):
    x = torch.tensor([-1.0, 1e-3, 2 ** -18, 0.5, 1.0, -0.2])
    g = torch.tensor([1.0, -1.0, 2.0, -0.5, 0.25, -3.0])
    grads = []
    for dev in (card, torch.device("cpu")):
        xt = x.to(dev).requires_grad_()
        tg.lower_bound(xt, 2 ** -18).backward(g.to(dev))
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_warp_gradients_on_card_match_host(card):
    """warp_plain's gradients with respect to x and to the flow, flows past
    every border: within 1e-6 relative L2 of the host's (the gradient
    with respect to x is a scatter sum in another order)."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 3, 24, 40, generator=g)
    flow = torch.randn(2, 2, 24, 40, generator=g) * 30.0
    w = torch.randn(2, 3, 24, 40, generator=g)
    out = {}
    for dev in (card, torch.device("cpu")):
        xt = x.to(dev).requires_grad_()
        ft = flow.to(dev).requires_grad_()
        (tw.warp_plain(xt, ft) * w.to(dev)).sum().backward()
        out[dev.type] = (xt.grad.cpu(), ft.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).norm() / b.norm()) <= 1e-6


def test_mixture_rate_on_card_matches_host(card):
    from aivc_tpu_torch.ops import entropy_models as tem

    g = torch.Generator().manual_seed(4)
    h = torch.randn(2, 11 * 6, 5, 4, generator=g) * 3.0
    y = torch.round(torch.randn(2, 6, 5, 4, generator=g) * 4.0)
    bits = []
    for dev in (card, torch.device("cpu")):
        comps = tem.pdf_parameterize_mixture(h.to(dev), 6, "three_gamma")
        p = tem.mixture_bin_prob(y.to(dev), comps, "laplace")
        bits.append(tem.rate_bits(p).cpu())
    assert torch.allclose(bits[0], bits[1], rtol=1e-5, atol=1e-6)


def test_vclamped_kernel_refuses_gradients(card):
    x = torch.rand(1, 3, 16, 128, device=card)
    flow = torch.zeros(1, 2, 16, 128, device=card)
    with pytest.raises(ValueError, match="forward-only"):
        tw.warp_vclamped_cuda(x.clone().requires_grad_(), flow)
    with pytest.raises(ValueError, match="forward-only"):
        tw.warp_vclamped_cuda(x, flow.clone().requires_grad_())
    saved = tw._USE_PALLAS
    tw._USE_PALLAS = True
    try:
        with pytest.raises(ValueError, match="cannot be differentiated"):
            tw.warp(x, flow.clone().requires_grad_())
    finally:
        tw._USE_PALLAS = saved


# Each gradient leaf of the tiny-toy step, card against host: measured
# 3.6e-3 relative L2 at worst (mofnet.gain_P.enc_gain; a GDN beta
# 3.5e-3), cosine 0.999994 at worst, NVIDIA H100 80GB HBM3, 700.00 W.
TINY_LEAF_MAX_REL_L2 = 2e-2
TINY_LEAF_MIN_COSINE = 0.9998


def test_tiny_train_step_on_card_matches_host(card):
    """One make_train_step step of tiny-toy (f32; the step itself turns
    TF32 off, as the codec does for a float32 model), accum 2, with the
    same frames and noise on the card and on the host: the logs within
    1e-4 relative, the grad norm within 5e-3, the update's gradient
    within 1e-2 relative L2 (measured 1.6e-3, NVIDIA H100 80GB HBM3; the
    float32 gradient itself moves by 1.7e-3 relative L2, 5.6e-4 on the
    norm, between float32 and float64 on the host: its rate terms
    amplify roundings) and each leaf within TINY_LEAF_*, Adam's counts
    equal."""
    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.smoke import HostNoise, leaf_distances
    from aivc_tpu_torch.train.data import make_batch
    from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    gop = generate_gop_struct("1_GOP_2")
    frames = torch.from_numpy(make_batch(np.random.default_rng(1), len(gop),
                                         4, 64)).permute(0, 1, 4, 2, 3)
    res = {}
    for dev in (card, torch.device("cpu")):
        cfg, model = load_checkpoint(ROOT / "models_ckpt" / "tiny-toy",
                                     device=dev)
        params = [p for _, p in model.named_parameters()]
        opt = make_optimizer(params, 1e-4)
        step = make_train_step(model, cfg, gop, opt, dist_loss="ms_ssim",
                               accum=2)
        logs = step(frames.contiguous().to(dev), 1, HostNoise(7))
        leaves = {n: p.grad.cpu() for n, p in model.named_parameters()}
        res[dev.type] = (logs, leaves, opt.count)
    (lc, gc, cc), (lh, gh, ch) = res["cuda"], res["cpu"]
    assert cc == ch == 1 and lc["step_skipped"] == lh["step_skipped"] == 0
    for k in lh:
        rtol = 5e-3 if k == "grad_norm" else 1e-4
        assert abs(lc[k] - lh[k]) <= rtol * abs(lh[k]) + 1e-7, (k, lc, lh)
    a = torch.cat([g.reshape(-1) for g in gc.values()])
    b = torch.cat([g.reshape(-1) for g in gh.values()])
    assert float((a - b).norm() / b.norm()) <= 1e-2
    rows = leaf_distances(gc, gh)
    assert max(r[1] for r in rows) <= TINY_LEAF_MAX_REL_L2, rows
    assert min(r[2] for r in rows) >= TINY_LEAF_MIN_COSINE, rows


def _dense_v1_wave(codec, frame_type, batch, rng):
    """Symbols and rows of a dense (v1) wave in the codec's segment plan
    (FrameCodec._fused_n at the K that _pick_k gives the dense total):
    z segments on their channels' rows, y segments on random sigma
    rows, each padded to a multiple of K."""
    cfg, off = codec.cfg, codec._row_off
    k = codec._pick_k(frame_type, codec._fused_n(frame_type, 8)[0])
    _, plan = codec._fused_n(frame_type, k)
    parts = [("z_m", cfg.mofnet.nb_ft_z), ("y", 0),
             ("z_c", cfg.codecnet.nb_ft_z), ("y", 0)]
    if frame_type == 0:
        parts = parts[2:]
    rows = []
    for (fam, c), n_pad in zip(parts, plan):
        if fam == "y":
            r = off["y"] + rng.integers(0, 48, size=(batch, n_pad))
        else:
            r = np.tile(np.arange(c) + off[fam], (batch, -(-n_pad // c)))
            r = r[:, :n_pad]
        rows.append(r.astype(np.int32))
    rows = np.concatenate(rows, axis=1)
    sym = _symbols(rng, codec.fused_rows, rows)
    dev = codec.device
    return (torch.from_numpy(sym).to(dev), torch.from_numpy(rows).to(dev),
            k, tuple(n // k for n in plan))


@pytest.mark.parametrize("size", [(128, 192), (1080, 1920)])
@pytest.mark.parametrize("frame_type", [0, 2])
def test_rans_kernels_on_dense_v1_segment_plans(card, size, frame_type):
    """K1 on a whole dense v1 wave (4 frames) and K2 segment by segment
    with the carry, as the codec decodes it, against their plain
    versions."""
    codec = _r5_codec(card, *size)
    rng = np.random.default_rng(size[0] + frame_type)
    sym, rows, k, segs = _dense_v1_wave(codec, frame_type, 4, rng)
    t = codec.table
    out = vrans.encode_batch(sym, rows, t, k, segs)
    ref = vrans.encode_plain(sym, rows, t, k, segs)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
    buf, st, seg_g = out
    n_pad = sym.shape[1]
    for i in range(4):
        s = int(seg_g[i, 0])
        assert torch.equal(buf[i, s:], ref[0][i, s:])
    words = torch.zeros((4, vrans.bucket(n_pad, 1 << 30)),
                        dtype=torch.uint16, device=card)
    for i in range(4):
        s = int(seg_g[i, 0])
        words[i, :n_pad - s] = buf[i, s:]
    g = torch.zeros(4, dtype=torch.int32, device=card)
    gp, stp, pos = g.clone(), st, 0
    for n in segs:
        r = rows[:, pos:pos + n * k].contiguous()
        got = vrans.decode_batch(words, st, r, t, k, g)
        exp = vrans.decode_plain(words, stp, r, t, k, gp)
        assert all(torch.equal(a, b) for a, b in zip(got, exp))
        assert torch.equal(got[0], sym[:, pos:pos + n * k])
        _, st, g = got
        _, stp, gp = exp
        pos += n * k


@pytest.mark.parametrize("switches", [{"AIVC_VRANS_ELIDE": "0"},
                                      {"AIVC_GDN_LOWP": "0",
                                       "AIVC_DC_OFFSET": "0"}])
def test_stream_formats_closed_loop_on_card(card, switches, monkeypatch):
    """The dense v1 stream and schedule 0x0d on the card: encode ->
    decode bit-exact, K1 and K2 launched."""
    from aivc_tpu_torch.config import CodingConfig
    from aivc_tpu_torch.pipeline import video

    for name, value in switches.items():
        monkeypatch.setenv(name, value)
    codec = _r5_codec(card, 128, 192)
    assert codec.elide == ("AIVC_VRANS_ELIDE" not in switches)
    assert codec.sched_bits == (0x0D if "AIVC_GDN_LOWP" in switches
                                else 0x1F)
    frames = video.synthetic_frames(5, 128, 192)
    kernels.reset_launches()
    enc = video.encode_video(codec, frames, CodingConfig(
        coding_config="RA", gop_size=4, intra_period=4), wave_batch=2)
    dec = video.decode_video(codec, enc.bitstream)
    for i in range(5):
        for c in ("y", "u", "v"):
            assert np.array_equal(dec[i][c], enc.decoded_frames[i][c])
    assert kernels.LAUNCHES["rans_encode"] > 0
    assert kernels.LAUNCHES["rans_decode"] > 0
