"""K2's slot -> symbol index (coding/vrans.py:slot_index) and table
layout (coding/vrans.py:decode_layout) on the host.

The kernel reads index[u], u the slot's bucket of 2^(16 - bits) slots:
where it is flagged the bucket is one symbol's, otherwise a binary search
of the row between index[u] and index[u + 1] finds the symbol; the
symbol's start and frequency come from start_freq (the wide layout) or
from two neighbouring cdf16 edges.  Here that lookup is emulated for
every one of the 2^16 slots of every row and must give decode_plain's
symbol (the count of inner edges <= slot) and its interval exactly, on
random CDF rows, the Laplace tables and the fused table of every
checkpoint, each of which must fit a block in the layout chosen."""

from pathlib import Path

import numpy as np
import pytest
import torch

from aivc_tpu_torch.coding import vrans
from aivc_tpu_torch.kernels import MAX_SMEM
from aivc_tpu_torch.coding.cdf import build_laplace_table

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINTS = sorted(p.name for p in (ROOT / "models_ckpt").iterdir()
                     if (p / "config.json").exists())
# Frequencies of the fused tables of bf16-r3 and bf16-r4m, for the card
# tests (test_torch_cuda.py), which run without those checkpoints.
FUSED_FREQS = ROOT / "tests" / "data" / "fused_freqs.npz"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_rows(rng, n_rows, n_sym):
    """CDF rows quantized to PROB_SCALE with every frequency >= 1, some
    peaked (most mass on a few symbols), some flat."""
    rows = []
    for r in range(n_rows):
        w = rng.gamma(0.05 if r % 2 else 2.0, size=n_sym)
        f = np.floor(w / w.sum() * (vrans.PROB_SCALE - n_sym)).astype(
            np.int64) + 1
        f[np.argmax(f)] += vrans.PROB_SCALE - f.sum()
        rows.append(np.concatenate([[0], np.cumsum(f)]))
    return np.stack(rows)


def _bits(table: vrans.RansTable) -> int:
    return (table.index.shape[1] - 1).bit_length() - 1


def _kernel_lookup(table: vrans.RansTable):
    """([R, 2^16] symbols, starts, frequencies) as K2 finds them: the
    index entry, a bounded binary search of the row between the two
    entries around the slot's bucket where it is not flagged, then the
    table of the layout decode_layout picks."""
    wide, bits = vrans.decode_layout(table.n_rows, table.n_symbols)
    assert bits == _bits(table)
    if wide:
        words = table.start_freq.to(torch.int64) & 0xFFFFFFFF
        starts = words & 0xFFFF
    else:
        starts = table.cdf16.to(torch.int64)
    _, _, flag = vrans.index_format(table.n_symbols)
    idx = table.index.to(torch.int64) & 0xFFFF
    slot = torch.arange(vrans.PROB_SCALE, dtype=torch.int64)
    u = slot >> (vrans.PROB_BITS - bits)
    e = idx[:, u]
    single = (e & flag) != 0
    lo = e & ~flag
    hi = torch.where(single, lo, idx[:, u + 1] & ~flag)
    while bool((lo < hi).any()):
        go = lo < hi
        mid = (lo + hi + 1) >> 1
        le = torch.gather(starts, 1, mid) <= slot
        lo = torch.where(go & le, mid, lo)
        hi = torch.where(go & ~le, mid - 1, hi)
    start = torch.gather(starts, 1, lo)
    if wide:
        freq = (torch.gather(words, 1, lo) >> 16) + 1
    else:
        nxt = torch.cat([starts[:, 1:], torch.full_like(starts[:, :1],
                                                        vrans.PROB_SCALE)],
                        dim=1)
        freq = torch.gather(nxt, 1, lo) - start
    return lo, start, freq


def _check_lookup(table: vrans.RansTable) -> None:
    sym = _plain_symbols(table)
    found, start, freq = _kernel_lookup(table)
    assert torch.equal(found, sym)
    assert torch.equal(start, torch.gather(table.cdf64, 1, sym))
    assert torch.equal(freq, torch.gather(torch.diff(table.cdf64, dim=1), 1,
                                          sym))


def _plain_symbols(table: vrans.RansTable) -> torch.Tensor:
    """The symbol owning each slot, as decode_plain reads it (the count
    of inner edges <= slot): symbol s repeated over its frequency."""
    n_sym = table.n_symbols
    freq = torch.diff(table.cdf64, dim=1)
    return torch.stack([
        torch.repeat_interleave(torch.arange(n_sym), f) for f in freq])


def _tables():
    rng = np.random.default_rng(7)
    yield "random-129", _random_rows(rng, 24, 129)
    yield "random-513", _random_rows(rng, 8, 513)
    yield "random-3", _random_rows(rng, 4, 3)
    for ac in (64, 256):
        yield f"laplace-{ac}", build_laplace_table(
            scale=vrans.PROB_SCALE, ac_max=ac)


@pytest.mark.parametrize("name,cdf", list(_tables()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_index_lookup_matches_plain(name, cdf):
    table = vrans.make_table(cdf, "cpu")
    top, dtype, _ = vrans.index_format(table.n_symbols)
    assert top == (9 if table.n_symbols <= 128 else 8)
    assert vrans.decode_layout(table.n_rows, table.n_symbols) == (True, top)
    assert table.index.dtype == dtype
    assert table.index.shape == (cdf.shape[0], (1 << top) + 1)
    _check_lookup(table)
    w = table.start_freq.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(w & 0xFFFF, table.cdf64[:, :-1])
    assert torch.equal((w >> 16) + 1, torch.diff(table.cdf64, dim=1))


def test_index_lookup_bf16_r5_fused_table():
    """The fused z_m / z_c / y table the 1080p clip codes with."""
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(ROOT / "models_ckpt" / "bf16-r5",
                                 device="cpu")
    table = FrameCodec(cfg, model, 64, 64, device="cpu").table
    _check_lookup(table)
    # The wide layout with u8 entries over 512 buckets, and most slots
    # end at the index: their bucket is one symbol's.
    bits, dtype, flag = vrans.index_format(table.n_symbols)
    assert vrans.decode_layout(table.n_rows, table.n_symbols) == (True, 9)
    assert dtype == torch.uint8
    idx = table.index.to(torch.int64)
    u = torch.arange(vrans.PROB_SCALE) >> (vrans.PROB_BITS - bits)
    assert float(((idx[:, u] & flag) != 0).float().mean()) > 0.9


def test_index_bounds_every_slot():
    """index[u] <= symbol(slot) <= index[u + 1] for every slot of bucket
    u (flags masked), the flag set exactly where the bucket is one
    symbol's, and the last entry is the last symbol."""
    for _, cdf in _tables():
        table = vrans.make_table(cdf, "cpu")
        sym = _plain_symbols(table)
        _, _, flag = vrans.index_format(table.n_symbols)
        bits = _bits(table)
        raw = table.index.to(torch.int64) & 0xFFFF
        idx = raw & ~flag
        u = torch.arange(vrans.PROB_SCALE) >> (vrans.PROB_BITS - bits)
        assert bool((idx[:, u] <= sym).all())
        assert bool((sym <= idx[:, u + 1]).all())
        assert bool((raw[:, -1] == table.n_symbols - 1).all())
        per_bucket = sym.view(sym.shape[0], 1 << bits, -1)
        one = (per_bucket.amin(-1) == per_bucket.amax(-1)).to(torch.int64)
        assert torch.equal((raw[:, :-1] & flag) != 0, one.bool())


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_every_checkpoint_table_fits_and_looks_up(name):
    """Every checkpoint's fused table fits a K2 block at K_MAX in the
    layout decode_layout picks, and its lookup gives decode_plain's
    symbols (ac 64: start_freq and 2^9 buckets; ac 128: cdf16 and 2^8;
    ac 256: cdf16 and 2^5)."""
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(ROOT / "models_ckpt" / name, device="cpu")
    codec = FrameCodec(cfg, model, 64, 64, device="cpu")
    table = codec.table
    wide, bits = vrans.decode_layout(table.n_rows, table.n_symbols)
    assert vrans.decode_smem_bytes(table.n_rows, table.n_symbols,
                                   vrans.K_MAX, wide, bits) <= MAX_SMEM
    expect = {64: (True, 9), 128: (False, 8), 256: (False, 5)}
    if table.n_rows == 176:
        assert (wide, bits) == expect[codec.ac_max]
    _check_lookup(table)
    freqs = np.load(FUSED_FREQS)
    key = name.replace("-", "_")
    if key in freqs:
        assert np.array_equal(freqs[key],
                              np.diff(codec.fused_rows.astype(np.int64),
                                      axis=1))


def test_decode_layout_prefers_wide_then_the_finest_index():
    """start_freq while it fits with the finest index, then cdf16 with
    the most bits that fit, down to 0 (a search of the whole row); the
    byte count is csrc/kernels.cu:rans_decode_smem's."""
    assert vrans.decode_smem_bytes(176, 128, 2048, True, 9) == 213424
    assert vrans.decode_smem_bytes(176, 512, 8, False, 5) == (
        256 + 8 * 8 * 2 + 176 * 512 * 2 + 176 * 33 * 2)
    for n_sym in (3, 128, 129, 256, 512):
        last = (True, vrans.index_format(n_sym)[0])
        for n_rows in range(1, 1200, 7):
            wide, bits = vrans.decode_layout(n_rows, n_sym)
            fits = vrans.decode_smem_bytes(n_rows, n_sym, vrans.K_MAX, wide,
                                           bits) <= MAX_SMEM
            if wide:
                assert fits and bits == vrans.index_format(n_sym)[0]
            elif bits > 0:
                assert fits
                assert vrans.decode_smem_bytes(
                    n_rows, n_sym, vrans.K_MAX, False, bits + 1) > MAX_SMEM \
                    or bits == vrans.index_format(n_sym)[0]
            # more rows never move to a wider table or a finer index
            assert (wide, bits) <= last
            last = (wide, bits)
