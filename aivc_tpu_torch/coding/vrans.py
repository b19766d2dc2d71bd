"""Interleaved K-stream rANS on the card (counterpart of
aivc_tpu/coding/vrans.py).

Symbol i of a chunk belongs to (step i // K, lane i % K).  32-bit states
in [2^16, 2^32), 16-bit renormalisation words, PROB_BITS = 16.  Encoding
walks the steps in reverse; the words are laid out in decode order (step
ascending, then lane ascending), so only the K final states and the word
count travel with them.  The chunk bytes are identical to the JAX
package's for the same symbols, rows and tables.

Buffer layout of the batched encoder (kernel K1 and its plain version):
``buf`` is [B, n_pad] u16 and chunk b's words are ``buf[b, seg_g[b, 0]:
n_pad]``; segment i's words are ``buf[b, seg_g[b, i]:seg_g[b, i + 1]]``
with ``seg_g[b, NSEG] == n_pad`` (a descending write cursor, as in
encode_pallas_batch).

``encode_batch`` and ``decode_batch`` take the plain PyTorch versions
(``encode_plain``, ``decode_plain``) for host tensors and launch kernels
K1 / K2 (csrc/kernels.cu) for tensors on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aivc_tpu_torch import kernels

PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
K_MIN = 8
K_MAX = 2048
_MASK32 = 0xFFFFFFFF
# K2's slot -> symbol index of each CDF row: u8 entries over at most 2^9
# buckets for rows of at most SMALL_ALPHABET symbols, u16 over at most
# 2^8 otherwise; the top bit of an entry flags a bucket that holds one
# symbol.
SMALL_ALPHABET = 128
# Chunks of max(K, 8) words in K2's shared-memory word ring
# (csrc/kernels.cu:kRing).
RING_CHUNKS = 8


def index_format(n_sym: int):
    """(most bucket bits, torch dtype, single flag) of a table's slot
    index."""
    if n_sym <= SMALL_ALPHABET:
        return 9, torch.uint8, 1 << 7
    return 8, torch.int16, 1 << 15


def decode_smem_bytes(n_rows: int, n_sym: int, k: int, wide: bool,
                      bits: int) -> int:
    """Shared memory of a K2 block (csrc/kernels.cu:rans_decode_smem):
    warp totals, the word ring, the table (start_freq if ``wide``, else
    cdf16) and the index of 2^bits + 1 entries per row."""
    chunk = max(k, 8)
    chunk = 1 << (chunk - 1).bit_length()
    ix_bytes = torch.empty((), dtype=index_format(n_sym)[1]).element_size()
    return (64 * 4 + RING_CHUNKS * chunk * 2
            + n_rows * n_sym * (4 if wide else 2)
            + n_rows * ((1 << bits) + 1) * ix_bytes)


def decode_layout(n_rows: int, n_sym: int) -> Tuple[bool, int]:
    """(wide, index bits) of K2's table: the first that fits a block at
    K_MAX of start_freq with the finest index, else cdf16 with the
    finest index that fits (0 bits: a binary search of the whole row).
    Where even that does not fit, decode_cuda raises."""
    top = index_format(n_sym)[0]
    if decode_smem_bytes(n_rows, n_sym, K_MAX, True, top) <= kernels.MAX_SMEM:
        return True, top
    bits = top
    while bits > 0 and decode_smem_bytes(n_rows, n_sym, K_MAX, False,
                                         bits) > kernels.MAX_SMEM:
        bits -= 1
    return False, bits


def pick_k(n: int) -> int:
    """Stream count for an n-symbol chunk: the largest power of two with
    ~512+ symbols per stream, in [K_MIN, K_MAX]."""
    if n <= 0:
        return K_MIN
    k = K_MIN
    while k < K_MAX and (n >> 1) // k >= 256:
        k *= 2
    return k


def plan(n: int, k: int) -> Tuple[int, int]:
    """(S, n_pad) for an n-symbol chunk over k streams."""
    s = max(1, -(-n // k))
    return s, s * k


def bucket(total: int, n_pad: int) -> int:
    """Round a word count up to a power-of-two bucket (min 4096), capped
    at n_pad."""
    m = 4096
    while m < total:
        m *= 2
    return min(m, n_pad)


class RansTable(NamedTuple):
    """One fused CDF row family on one device.

    cdf64: int64 [R, N_SYM + 1] (the plain versions);
    cdf16: uint16 [R, N_SYM] = cdf[:, :N_SYM] (the kernels; the last edge
    is PROB_SCALE implicitly, so every stored value fits 16 bits);
    start_freq: int32 [R, N_SYM], start | (freq - 1) << 16 of each symbol
    (K2's wide layout: one 32-bit word per lookup; the bits read as u32);
    index: ``slot_index(cdf64, bits)``, [R, 2^bits + 1] of
    ``index_format``'s type at ``decode_layout``'s bits (K2's slot ->
    symbol lookup)."""

    cdf64: torch.Tensor
    cdf16: torch.Tensor
    start_freq: torch.Tensor
    index: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.cdf64.shape[0]

    @property
    def n_symbols(self) -> int:
        return self.cdf64.shape[1] - 1


def slot_index(cdf64: torch.Tensor, bits: int) -> torch.Tensor:
    """[R, 2^bits + 1] of ``index_format(n_sym)``'s type, read unsigned:
    entry u < 2^bits is the symbol whose interval holds the first slot
    of bucket u (slots u * 2^(16 - bits) on), plus the single flag where
    that symbol also holds the bucket's last slot (the bucket is one
    symbol's); the last entry is the symbol of slot PROB_SCALE - 1.
    Without the flag, the symbol of any slot in bucket u lies in
    [index[u], index[u + 1]] (flags masked off)."""
    n_rows, n_edges = cdf64.shape
    _, dtype, single = index_format(n_edges - 1)
    width = 1 << (PROB_BITS - bits)
    first = torch.arange((1 << bits) + 1, dtype=torch.int64,
                         device=cdf64.device) * width
    first = first.clamp_max(PROB_SCALE - 1).expand(n_rows, -1)
    edges = cdf64[:, 1:n_edges - 1].contiguous()
    # The symbol of slot v is the count of inner edges cdf[1:n_sym] <= v.
    sym = torch.searchsorted(edges, first.contiguous(), right=True)
    last = torch.searchsorted(edges, (first[:, :-1] + width - 1)
                              .contiguous(), right=True)
    entry = sym.clone()
    entry[:, :-1] += (last == sym[:, :-1]).to(torch.int64) * single
    if dtype == torch.int16:      # the u16 bits in an int16
        entry = entry - (entry >= 1 << 15).to(torch.int64) * (1 << 16)
    return entry.to(dtype)


def start_freq(cdf64: torch.Tensor) -> torch.Tensor:
    """int32 [R, N_SYM]: start | (freq - 1) << 16 per symbol, the u32
    bits stored in an int32."""
    start = cdf64[:, :-1]
    word = start + ((cdf64[:, 1:] - start - 1) << 16)
    return (word - (word >= 1 << 31).to(torch.int64) * (1 << 32)).to(
        torch.int32)


def make_table(cdf_rows: np.ndarray, device) -> RansTable:
    """cdf_rows: [R, N_SYM + 1] integer CDF rows quantized to PROB_SCALE."""
    cdf = np.asarray(cdf_rows, dtype=np.int64)
    if cdf[:, -1].min() != PROB_SCALE or cdf[:, -1].max() != PROB_SCALE:
        raise ValueError(f"CDF rows must be quantized to {PROB_SCALE}")
    if cdf[:, 0].any():
        raise ValueError("CDF rows must start at 0")
    if np.diff(cdf, axis=1).min() < 1:
        raise ValueError("zero-frequency symbol in CDF row")
    cdf64 = torch.from_numpy(cdf).to(device)
    _, bits = decode_layout(*cdf[:, 1:].shape)
    return RansTable(
        cdf64=cdf64,
        cdf16=torch.from_numpy(cdf[:, :-1].astype(np.uint16)).to(device),
        start_freq=start_freq(cdf64),
        index=slot_index(cdf64, bits))


def _segment_starts(segment_steps: Sequence[int], steps: int) -> list:
    segs = tuple(segment_steps) if segment_steps else (steps,)
    if sum(segs) != steps:
        raise ValueError("segment_steps must sum to the step count")
    if len(segs) > 4:
        raise ValueError("at most 4 segments")
    return [int(v) for v in np.cumsum((0,) + segs)[:-1]]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (int64 arithmetic, masked to u32 where JAX wraps)
# ---------------------------------------------------------------------------

def encode_plain(sym: torch.Tensor, rows: torch.Tensor, table: RansTable,
                 k: int, segment_steps: Sequence[int] = ()):
    """sym, rows: i32 [B, n_pad] with n_pad a multiple of k.  Returns
    (buf u16 [B, n_pad], states u32 [B, k], seg_g i32 [B, NSEG])."""
    B, n_pad = sym.shape
    if n_pad % k:
        raise ValueError("n_pad must be a multiple of k")
    steps = n_pad // k
    starts = _segment_starts(segment_steps, steps)
    dev = sym.device
    s = sym.to(torch.int64)
    r = rows.to(torch.int64)
    cdf = table.cdf64
    start_all = cdf[r, s].view(B, steps, k)
    freq_all = (cdf[r, s + 1] - cdf[r, s]).view(B, steps, k)
    x = torch.full((B, k), RANS_L, dtype=torch.int64, device=dev)
    buf = torch.zeros((B, n_pad), dtype=torch.int64, device=dev)
    g = torch.full((B,), n_pad, dtype=torch.int64, device=dev)
    seg_g = torch.zeros((B, len(starts)), dtype=torch.int64, device=dev)
    for t in range(steps - 1, -1, -1):
        freq = freq_all[:, t]
        emit = x >= (freq << 16)
        word = x & 0xFFFF
        x = torch.where(emit, x >> 16, x)
        q = torch.div(x, freq, rounding_mode="floor")
        x = (q << 16) + (x - q * freq) + start_all[:, t]
        e = emit.to(torch.int64)
        rank = torch.cumsum(e, dim=1) - e
        g = g - e.sum(dim=1)
        bi, li = emit.nonzero(as_tuple=True)
        buf[bi, g[bi] + rank[bi, li]] = word[bi, li]
        for i, st in enumerate(starts):
            if t == st:
                seg_g[:, i] = g
    return (buf.to(torch.uint16), x.to(torch.uint32),
            seg_g.to(torch.int32))


def decode_plain(words: torch.Tensor, states: torch.Tensor,
                 rows: torch.Tensor, table: RansTable, k: int,
                 g0: Optional[torch.Tensor] = None):
    """words u16 [B, W]; states u32 [B, k]; rows i32 [B, n_pad]; g0 i32
    [B] (word offset of this stage).  Returns (syms i32 [B, n_pad],
    states u32 [B, k], g i32 [B]).  Words past W read as 0."""
    B, n_pad = rows.shape
    if n_pad % k:
        raise ValueError("n_pad must be a multiple of k")
    steps = n_pad // k
    dev = rows.device
    cdf = table.cdf64
    n_sym = table.n_symbols
    w = words.to(torch.int64)
    w_cap = w.shape[1]
    w = torch.cat([w, torch.zeros((B, 1), dtype=torch.int64, device=dev)],
                  dim=1)
    x = states.to(torch.int64)
    g = (torch.zeros(B, dtype=torch.int64, device=dev) if g0 is None
         else g0.to(torch.int64))
    r_all = rows.to(torch.int64).view(B, steps, k)
    out = torch.empty((B, steps, k), dtype=torch.int64, device=dev)
    for t in range(steps):
        row = cdf[r_all[:, t]]                             # [B, k, n_sym+1]
        slot = x & (PROB_SCALE - 1)
        s = (row[..., 1:n_sym] <= slot[..., None]).sum(dim=-1)
        start = torch.gather(row, 2, s[..., None])[..., 0]
        freq = torch.gather(row, 2, (s + 1)[..., None])[..., 0] - start
        x = (freq * (x >> 16) + slot - start) & _MASK32
        need = x < RANS_L
        n_i = need.to(torch.int64)
        pos = g[:, None] + torch.cumsum(n_i, dim=1) - n_i
        pos = torch.where((pos >= 0) & (pos < w_cap), pos, w_cap)
        wv = torch.gather(w, 1, pos)
        x = torch.where(need, ((x << 16) | wv) & _MASK32, x)
        g = g + n_i.sum(dim=1)
        out[:, t] = s
    return (out.view(B, n_pad).to(torch.int32), x.to(torch.uint32),
            g.to(torch.int32))


# ---------------------------------------------------------------------------
# Kernel wrappers (K1, K2)
# ---------------------------------------------------------------------------

def _check_smem(smem: int) -> None:
    """Raise unless a kernel's ``smem`` bytes for a table fit a block."""
    if smem > kernels.MAX_SMEM:
        raise ValueError(f"CDF table needs {smem} B of shared memory, "
                         f"more than the card's {kernels.MAX_SMEM}")


def _check_k(k: int) -> None:
    if k < 1 or k & (k - 1) or k > K_MAX:
        raise ValueError(f"K must be a power of two <= {K_MAX}, got {k}")


@functools.lru_cache(maxsize=256)
def _encode_scratch_bytes(n_rows: int, n_sym: int, batch: int,
                          n_pad: int) -> int:
    """Bytes of K1's scratch (each step's pre-renormalisation words, the
    emit bitmap and the emits per placement tile, csrc/kernels.cu K1) for
    ``batch`` chunks of ``n_pad``; raises unless the table fits a block.
    One round trip to the library per shape."""
    lib = kernels.lib()
    _check_smem(lib.aivc_rans_encode_smem_bytes(n_rows, n_sym))
    return lib.aivc_rans_encode_scratch_bytes(batch, n_pad)


def encode_cuda(sym: torch.Tensor, rows: torch.Tensor, table: RansTable,
                k: int, segment_steps: Sequence[int] = ()):
    """Kernel K1: same contract as ``encode_plain``."""
    B, n_pad = sym.shape
    _check_k(k)
    if n_pad % k:
        raise ValueError("n_pad must be a multiple of k")
    kernels.require(sym, "sym", torch.int32, (B, n_pad))
    kernels.require(rows, "rows", torch.int32, (B, n_pad))
    kernels.require(table.cdf16, "cdf16", torch.uint16,
                    (table.n_rows, table.n_symbols))
    scratch_bytes = _encode_scratch_bytes(table.n_rows, table.n_symbols, B,
                                          n_pad)
    starts = _segment_starts(segment_steps, n_pad // k)
    seg4 = starts + [-1] * (4 - len(starts))
    dev = sym.device
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    buf = torch.empty((B, n_pad), dtype=torch.uint16, device=dev)
    states = torch.empty((B, k), dtype=torch.uint32, device=dev)
    seg_g = torch.empty((B, len(starts)), dtype=torch.int32, device=dev)
    rc = kernels.lib().aivc_rans_encode(
        sym.data_ptr(), rows.data_ptr(), table.cdf16.data_ptr(),
        table.n_rows, table.n_symbols, B, n_pad, k, *seg4, len(starts),
        scratch.data_ptr(), buf.data_ptr(), states.data_ptr(),
        seg_g.data_ptr(), kernels.stream_ptr())
    kernels.check("rans_encode", rc)
    kernels.LAUNCHES["rans_encode"] += 1
    kernels.STEPS["rans_encode"] += n_pad // k
    return buf, states, seg_g


def decode_cuda(words: torch.Tensor, states: torch.Tensor,
                rows: torch.Tensor, table: RansTable, k: int,
                g0: Optional[torch.Tensor] = None):
    """Kernel K2: same contract as ``decode_plain``."""
    B, n_pad = rows.shape
    _check_k(k)
    if n_pad % k:
        raise ValueError("n_pad must be a multiple of k")
    dev = rows.device
    if g0 is None:
        g0 = torch.zeros(B, dtype=torch.int32, device=dev)
    kernels.require(words, "words", torch.uint16, (B, words.shape[1]))
    kernels.require(states, "states", torch.uint32, (B, k))
    kernels.require(rows, "rows", torch.int32, (B, n_pad))
    kernels.require(g0, "g0", torch.int32, (B,))
    wide, bits = decode_layout(table.n_rows, table.n_symbols)
    ix_bytes = table.index.element_size()
    _check_smem(kernels.lib().aivc_rans_decode_smem_bytes(
        table.n_rows, table.n_symbols, k, ix_bytes, bits, int(wide)))
    tab = table.start_freq if wide else table.cdf16
    kernels.require(tab, "start_freq" if wide else "cdf16",
                    torch.int32 if wide else torch.uint16,
                    (table.n_rows, table.n_symbols))
    kernels.require(table.index, "index", index_format(table.n_symbols)[1],
                    (table.n_rows, (1 << bits) + 1))
    syms = torch.empty((B, n_pad), dtype=torch.int32, device=dev)
    st_out = torch.empty((B, k), dtype=torch.uint32, device=dev)
    g_out = torch.empty((B,), dtype=torch.int32, device=dev)
    rc = kernels.lib().aivc_rans_decode(
        words.data_ptr(), words.shape[1], states.data_ptr(),
        rows.data_ptr(), g0.data_ptr(), tab.data_ptr(), int(wide),
        table.index.data_ptr(), ix_bytes, bits, table.n_rows,
        table.n_symbols, B, n_pad, k, syms.data_ptr(), st_out.data_ptr(),
        g_out.data_ptr(), kernels.stream_ptr())
    kernels.check("rans_decode", rc)
    kernels.LAUNCHES["rans_decode"] += 1
    kernels.STEPS["rans_decode"] += n_pad // k
    return syms, st_out, g_out


def encode_batch(sym, rows, table: RansTable, k: int,
                 segment_steps: Sequence[int] = ()):
    """K1 on the card, the plain version on the host."""
    if sym.device.type == "cuda":
        return encode_cuda(sym, rows, table, k, segment_steps)
    return encode_plain(sym, rows, table, k, segment_steps)


def decode_batch(words, states, rows, table: RansTable, k: int, g0=None):
    """K2 on the card, the plain version on the host."""
    if rows.device.type == "cuda":
        return decode_cuda(words, states, rows, table, k, g0)
    return decode_plain(words, states, rows, table, k, g0)


# ---------------------------------------------------------------------------
# Chunk wire format (byte-identical to aivc_tpu/coding/vrans.py)
# ---------------------------------------------------------------------------

CHUNK_V2 = 0x80


def serialize_chunk(k: int, states: np.ndarray, words: np.ndarray) -> bytes:
    """v1 (dense) chunk: [1B log2 K][4B BE word count][K*4B BE states]
    [words BE]."""
    out = bytearray()
    out.append(int(k).bit_length() - 1)
    out.extend(int(words.size).to_bytes(4, "big"))
    out.extend(np.asarray(states).astype(">u4").tobytes())
    out.extend(np.asarray(words).astype(">u2").tobytes())
    return bytes(out)


def serialize_chunk_v2(k: int, states: np.ndarray, words: np.ndarray,
                       bitmaps) -> bytes:
    """[1B log2 K | 0x80][1B n_bitmaps]([1B len][bitmap])* then the v1
    tail: [4B BE word count][K*4B BE states][words BE]."""
    out = bytearray()
    out.append((int(k).bit_length() - 1) | CHUNK_V2)
    out.append(len(bitmaps))
    for bm in bitmaps:
        out.append(len(bm))
        out.extend(bm)
    out.extend(int(words.size).to_bytes(4, "big"))
    out.extend(np.asarray(states).astype(">u4").tobytes())
    out.extend(np.asarray(words).astype(">u2").tobytes())
    return bytes(out)


def parse_chunk(payload: bytes):
    """v1 chunk bytes -> (words u16, states u32, k)."""
    if payload[0] & CHUNK_V2:
        words, states, k, _ = parse_chunk_v2(payload)
        return words, states, k
    k = 1 << payload[0]
    total = int.from_bytes(payload[1:5], "big")
    pos = 5
    states = np.frombuffer(payload, dtype=">u4", count=k, offset=pos)
    pos += 4 * k
    words = np.frombuffer(payload, dtype=">u2", count=total, offset=pos)
    if pos + 2 * total != len(payload):
        raise ValueError("vrans chunk size mismatch")
    return words.astype(np.uint16), states.astype(np.uint32), k


def parse_chunk_v2(payload: bytes):
    """Chunk bytes -> (words, states, k, bitmaps | None for a v1 chunk)."""
    first = payload[0]
    if not first & CHUNK_V2:
        w, s, k = parse_chunk(payload)
        return w, s, k, None
    k = 1 << (first & 0x7F)
    nbm = payload[1]
    pos = 2
    bitmaps = []
    for _ in range(nbm):
        ln = payload[pos]
        pos += 1
        bitmaps.append(payload[pos:pos + ln])
        pos += ln
    total = int.from_bytes(payload[pos:pos + 4], "big")
    pos += 4
    states = np.frombuffer(payload, dtype=">u4", count=k, offset=pos)
    pos += 4 * k
    words = np.frombuffer(payload, dtype=">u2", count=total, offset=pos)
    if pos + 2 * total != len(payload):
        raise ValueError("vrans v2 chunk size mismatch")
    return words.astype(np.uint16), states.astype(np.uint32), k, bitmaps


def chan_bitmap(mask: np.ndarray) -> bytes:
    """bool [C] -> little-endian-bit channel bitmap bytes."""
    return np.packbits(np.asarray(mask, bool), bitorder="little").tobytes()


def bitmap_channels(bm: bytes, c: int) -> np.ndarray:
    """bitmap bytes -> int32 indices of set channels (sorted)."""
    bits = np.unpackbits(np.frombuffer(bm, np.uint8), count=c,
                         bitorder="little")
    return np.nonzero(bits)[0].astype(np.int32)


def elide_bucket(c_max: int, c_total: int) -> int:
    """Wave-shared gather width: the smallest level in
    {0, C/8, C/4, C/2, C} covering the wave's largest kept-channel count
    (part of the format)."""
    for lvl in sorted({0, -(-c_total // 8), -(-c_total // 4),
                       -(-c_total // 2), c_total}):
        if lvl >= c_max:
            return lvl
    return c_total
