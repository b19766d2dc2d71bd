"""K1's two-pass encode (csrc/kernels.cu: rans_encode_lanes_kernel, then
rans_encode_count_kernel and rans_encode_place_kernel) emulated in PyTorch
on the host, index arithmetic and all, and held bit for bit against
``encode_plain`` and against JAX's ``encode_pallas_batch`` in interpret
mode.  No host run can reach the kernel itself, so this is where the CPU
suite sees its placement rule:

* pass A: one thread per lane g = b K + lane walks its chain with no
  cross-lane traffic, writes each step's pre-renormalisation word to a
  scratch [B, n_pad] and its emit flag through one ballot mask per warp
  of 32 threads into a bitmap over the chunk's elements (bit e = element
  e = t K + lane); below K = 32 a lane group's lead thread gathers 32 / K
  steps in a register and stores the word at its lowest step;
* pass B: emits per tile of TILE_WORDS bitmap words; a tile's base is
  n_pad - E + the emits of the tiles before it; an emitted element goes
  to base + (popcounts of the tile's earlier words) + (set bits below it
  in its word); seg_g[i] is that position for element seg_start[i] K.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aivc_tpu.coding import vrans as jv
from aivc_tpu_torch import kernels
from aivc_tpu_torch.coding import vrans as tv
from aivc_tpu_torch.coding.cdf import build_laplace_table

MASK32 = 0xFFFFFFFF


def _kernel_constant(name: str) -> int:
    """A constant of csrc/kernels.cu, so the emulation follows it."""
    src = kernels.SRC.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


TILE_WORDS = _kernel_constant("kEncTileWords")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _popc(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 value (held in int64)."""
    return ((v[..., None] >> torch.arange(32)) & 1).sum(dim=-1)


def pass_a(sym, rows, cdf64, k):
    """Pass A: (words [B, n_pad], flags [B, ceil(n_pad / 32)] u32 in
    int64, states [B, k])."""
    B, n_pad = sym.shape
    steps = n_pad // k
    n_words = -(-n_pad // 32)
    lanes = B * k
    n_thr = -(-lanes // 32) * 32           # whole warps, as launched
    g = torch.arange(n_thr)
    active = g < lanes
    b = torch.where(active, g // k, 0)
    lane = g % k
    grp = min(k, 32)
    gmask = (1 << grp) - 1
    gshift = (g & 31) & ~(grp - 1)
    lead = active & ((lane & (grp - 1)) == 0)
    s_all = sym.to(torch.int64)
    r_all = rows.to(torch.int64)
    x = torch.full((n_thr,), tv.RANS_L, dtype=torch.int64)
    acc = torch.zeros(n_thr, dtype=torch.int64)
    words = torch.zeros((B, n_pad), dtype=torch.int64)
    flags = torch.full((B, n_words), -1, dtype=torch.int64)  # unwritten
    bit = torch.arange(32)
    for t in range(steps - 1, -1, -1):
        e = t * k + lane
        idx = torch.where(active, e, 0)
        s = s_all[b, idx]
        r = r_all[b, idx]
        start = cdf64[r, s]
        freq = cdf64[r, s + 1] - start
        hi = x >> 16
        emit = (hi >= freq) & active
        word = x & 0xFFFF
        xs = torch.where(hi >= freq, hi, x)
        q = xs // freq
        x = (q * (tv.PROB_SCALE - freq) + xs + start) & MASK32
        words[b[active], e[active]] = word[active]
        # __ballot_sync over each warp of 32 threads
        m = (emit.view(-1, 32).to(torch.int64) << bit).sum(dim=1)
        bits = (m[g // 32] >> gshift) & gmask
        acc = torch.where(lead, acc | (bits << (e & 31)), acc)
        store = lead & ((e & 31) == 0)
        flags[b[store], e[store] >> 5] = acc[store]
        acc = torch.where(store, 0, acc)
    assert (flags >= 0).all(), "a bitmap word was never written"
    return words, flags, x[:lanes].view(B, k)


def pass_b(words, flags, k, starts):
    """Pass B: (buf [B, n_pad] with zeros before the words, seg_g
    [B, len(starts)])."""
    B, n_pad = words.shape
    n_words = flags.shape[1]
    n_tiles = -(-n_words // TILE_WORDS)
    pad = n_tiles * TILE_WORDS - n_words
    fw = torch.cat([flags, torch.zeros((B, pad), dtype=torch.int64)],
                   dim=1).view(B, n_tiles, TILE_WORDS)
    pc = _popc(fw)                                    # [B, tiles, TW]
    tile_tot = pc.sum(dim=2)                          # count kernel
    base = (n_pad - tile_tot.sum(dim=1, keepdim=True)
            + torch.cumsum(tile_tot, dim=1) - tile_tot)   # [B, tiles]
    pre = torch.cumsum(pc, dim=2) - pc               # within the tile
    word_pos = (base[..., None] + pre).view(B, -1)[:, :n_words]
    fl = fw.view(B, -1)[:, :n_words]
    bits = (fl[..., None] >> torch.arange(32)) & 1   # [B, n_words, 32]
    rank = torch.cumsum(bits, dim=2) - bits
    pos = word_pos[..., None] + rank
    buf = torch.zeros((B, n_pad), dtype=torch.int64)
    bi, wi, li = bits.nonzero(as_tuple=True)
    buf[bi, pos[bi, wi, li]] = words[bi, wi * 32 + li]
    seg_g = torch.empty((B, len(starts)), dtype=torch.int64)
    for i, st in enumerate(starts):
        e = st * k
        low = fl[:, e >> 5] & ((1 << (e & 31)) - 1)
        seg_g[:, i] = word_pos[:, e >> 5] + _popc(low)
    return buf, seg_g


def encode_split(sym, rows, table, k, segment_steps=()):
    """The two passes end to end: encode_plain's contract."""
    steps = sym.shape[1] // k
    starts = tv._segment_starts(segment_steps, steps)
    words, flags, states = pass_a(sym, rows, table.cdf64, k)
    buf, seg_g = pass_b(words, flags, k, starts)
    return (buf.to(torch.uint16), states.to(torch.uint32),
            seg_g.to(torch.int32)), flags


def _inputs(cdf, k, steps, b, seed, sym_range=None):
    rng = np.random.default_rng(seed)
    n = steps * k
    rows = rng.integers(0, cdf.shape[0], size=(b, n)).astype(np.int32)
    if sym_range is None:
        slots = rng.integers(0, tv.PROB_SCALE, size=(b, n))
        sym = np.empty((b, n), np.int32)
        for r in np.unique(rows):
            sel = rows == r
            sym[sel] = np.searchsorted(cdf[r], slots[sel], side="right") - 1
    else:
        sym = rng.integers(*sym_range, size=(b, n)).astype(np.int32)
    return torch.from_numpy(sym), torch.from_numpy(rows)


def _same_as_plain(sym, rows, table, k, segs):
    (buf, st, seg_g), flags = encode_split(sym, rows, table, k, segs)
    pbuf, pst, pseg = tv.encode_plain(sym, rows, table, k, segs)
    assert torch.equal(st, pst)
    assert torch.equal(seg_g, pseg)
    for i in range(sym.shape[0]):
        s = int(seg_g[i, 0])
        assert torch.equal(buf[i, s:], pbuf[i, s:])
    return seg_g, flags


@pytest.mark.parametrize("k,steps,segs", [
    (1, 70, (30, 1, 39)),
    (8, 21, (1, 20)),
    (16, 5, (2, 2, 1)),
    (32, 9, (9,)),
    (64, 7, (1, 1, 1, 4)),
    (1024, 20, (6, 1, 13)),       # three tiles, the last one partial
    (2048, 5, (1, 4)),
])
def test_split_equals_encode_plain(k, steps, segs):
    cdf = build_laplace_table(scale=tv.PROB_SCALE, ac_max=64)
    table = tv.make_table(cdf, "cpu")
    sym, rows = _inputs(cdf, k, steps, 3, seed=k + steps)
    _same_as_plain(sym, rows, table, k, segs)


@pytest.mark.parametrize("k", [8, 64, 1024])
def test_split_every_lane_emits(k):
    """Symbols of frequency 1 emit at every step: the bitmap is all ones
    and the chunk holds n_pad words."""
    cdf = np.concatenate([[0], np.cumsum([1] * 127 + [tv.PROB_SCALE - 127])
                          ])[None].astype(np.int64)
    table = tv.make_table(cdf, "cpu")
    sym, rows = _inputs(cdf, k, 9, 2, seed=k, sym_range=(0, 127))
    seg_g, flags = _same_as_plain(sym, rows, table, k, (4, 5))
    n_pad = 9 * k
    assert (seg_g[:, 0] == 0).all() and (seg_g[:, 1] == 4 * k).all()
    assert int(_popc(flags).sum()) == 2 * n_pad


@pytest.mark.parametrize("k", [8, 2048])
def test_split_no_lane_emits(k):
    """A symbol that holds all but one slot never emits: an empty bitmap,
    every cursor at n_pad."""
    cdf = np.array([[0, tv.PROB_SCALE - 1, tv.PROB_SCALE]], np.int64)
    table = tv.make_table(cdf, "cpu")
    sym, rows = _inputs(cdf, k, 6, 2, seed=k, sym_range=(0, 1))
    seg_g, flags = _same_as_plain(sym, rows, table, k, (1, 2, 3))
    assert (seg_g == 6 * k).all() and not flags.any()


@pytest.mark.parametrize("segs", [(3,), (1, 2), (1, 1, 1)])
def test_split_equals_pallas_interpret(segs):
    """Words, states and cursors equal JAX's encode_pallas_batch
    (interpret mode) at K = 1024, across two placement tiles."""
    k = 1024
    steps = sum(segs)
    cdf = build_laplace_table(scale=jv.PROB_SCALE, ac_max=64)
    dec = jv.make_dec_tables(cdf)
    table = tv.make_table(cdf, "cpu")
    sym, rows = _inputs(cdf, k, steps, 2, seed=len(segs))
    n = steps * k
    jbuf, jst, jseg, g0 = jv.encode_pallas_batch(
        jnp.asarray(sym.numpy()), jnp.asarray(rows.numpy()),
        dec.cdf512_f32, n=n, k=k, pad_sym=0, segment_steps=segs,
        interpret=True)
    jbuf, jseg = np.asarray(jbuf), np.asarray(jseg)
    (buf, st, seg_g), _ = encode_split(sym, rows, table, k, segs)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(n - seg_g.numpy(), g0 - jseg)
    for i in range(2):
        np.testing.assert_array_equal(buf[i, int(seg_g[i, 0]):].numpy(),
                                      jbuf[i, jseg[i, 0]:g0])


def test_bitmap_is_the_emit_flags_in_element_order():
    """With K < 32 a warp spans several chunks and a bitmap word several
    steps; the words the lead threads store still read as one bit per
    element, e = t K + lane, equal to the plain version's emit flags."""
    k, steps, b = 8, 11, 5                   # 40 threads: a partial warp
    cdf = build_laplace_table(scale=tv.PROB_SCALE, ac_max=64)
    table = tv.make_table(cdf, "cpu")
    sym, rows = _inputs(cdf, k, steps, b, seed=3)
    _, flags, _ = pass_a(sym, rows, table.cdf64, k)
    # the emit flags, from the plain chain
    s = sym.to(torch.int64).view(b, steps, k)
    r = rows.to(torch.int64).view(b, steps, k)
    x = torch.full((b, k), tv.RANS_L, dtype=torch.int64)
    emit = torch.zeros((b, steps, k), dtype=torch.int64)
    for t in range(steps - 1, -1, -1):
        start = table.cdf64[r[:, t], s[:, t]]
        freq = table.cdf64[r[:, t], s[:, t] + 1] - start
        emit[:, t] = (x >= freq << 16).to(torch.int64)
        xs = torch.where(x >= freq << 16, x >> 16, x)
        q = xs // freq
        x = (q << 16) + xs - q * freq + start
    flat = emit.view(b, -1)
    n_pad = steps * k
    padded = torch.cat([flat, torch.zeros((b, flags.shape[1] * 32 - n_pad),
                                          dtype=torch.int64)], dim=1)
    want = (padded.view(b, -1, 32) << torch.arange(32)).sum(dim=2)
    assert torch.equal(flags, want)
