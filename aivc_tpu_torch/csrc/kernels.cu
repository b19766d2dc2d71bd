// Hand-written Hopper (sm_90a) kernels of the aivc_tpu_torch main path.
//
// One translation unit with a plain C interface: no PyTorch header, so one
// nvcc call builds it in seconds (aivc_tpu_torch/kernels.py loads it with
// ctypes).  Every launch function takes raw device pointers, sizes and a
// cudaStream_t, launches on that stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().
//
// K1 rans_encode  replaces aivc_tpu/coding/vrans.py:_encode_pallas_kernel
//                 (through encode_pallas_batch).
// K2 rans_decode  replaces aivc_tpu/coding/vrans.py:_decode_pallas_kernel
//                 (through decode_pallas_batch).
// K3 warp_packed  replaces aivc_tpu/ops/warp_pallas.py:_warp_bounded_kernel
//                 (through warp_bounded_pallas).
// K4 gdn_fused    replaces aivc_tpu/ops/gdn.py:_gdn_kernel
//                 (through gdn_pallas): bf16 on the tensor cores, f32 on
//                 CUDA cores; and, at gdn_apply's rounding points, the bf16
//                 GDN layers of the nets (gdn_layer_tc_kernel).
// K5 warp_vclamped replaces aivc_tpu/ops/warp_pallas.py:_warp_plane_kernel
//                 (through warp_pallas).
// K6 pad_stage    replaces no TPU kernel: the input of each replicate-padded
//                 bf16 convolution of the nets, padded, cast and laid out
//                 channels-last in one pass (ops/layers.py:pad_stage).
// K7 conv1x1      replaces no TPU kernel: ELIC's 1x1 convolutions, channels-
//                 last on the tensor cores, with the bias, ReLU, residual
//                 add or sigmoid gate folded in (ops/conv1x1.py).
//
// Each kernel is bit-identical to its plain PyTorch version beside its
// wrapper (coding/vrans.py, ops/warp.py, ops/gdn.py, ops/layers.py,
// ops/conv1x1.py), except K4's bf16 paths and K7, whose tensor cores sum
// in their own order: within 2 bf16 ulps (K4), within one bf16 ulp of the
// first rounding and what follows from it (K7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr uint32_t kProbScale = 1u << 16;   // PROB_BITS = 16
constexpr uint32_t kRansL = 1u << 16;       // state lower bound, 16-bit words

__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// K1: batched interleaved K-stream rANS encode, in two passes.
//
// What bounds it on the H100: the chain of S = n_pad / K dependent steps
// of each lane (a state needs the one of the step above it), not bytes or
// operations: a 1080p B-wave of 4 chunks moves ~60 MB, which the card
// reads in ~20 us.  Unlike the decode, the lanes of the encode do not
// depend on each other: lane l's state at step t is a function of its own
// state at t + 1 and its own (symbol, row).  What crosses lanes is only
// where each emitted word lands: in decode order (step ascending, then
// lane ascending), word (t, l) goes to n_pad - E + (emits before element
// t K + l), E being the chunk's emits.  So the design splits the two:
//
// * pass A, rans_encode_lanes_kernel: one thread per lane, no barrier and
//   no cross-lane traffic on the chain.  The thread walks its lane from
//   step S - 1 to 0 with the state in a register.  The (symbol, row) of
//   the next kEncAhead steps are in flight into a shared-memory ring by
//   4-byte cp.async, each thread copying and reading only its own lane,
//   and the table lookup of step t - kEncLook is done during step t, so
//   only the compare, shift, u32 division and multiply-add sit on the
//   chain.  The step body has no branch (stores and the flag word are
//   predicated), so the compiler overlaps a step's lookups with the
//   chain; with ~2 warps per SM (8,192 lanes of a 1080p wave) nothing
//   else hides a stall.  The CDF table is in shared memory (one cp.async
//   fill per block).  Each step writes its pre-renormalisation word into
//   a scratch [B, n_pad] (coalesced) and its emit flags as one
//   __ballot_sync mask per warp into a bitmap over the chunk's elements
//   (bit e = element e = t K + l).  Blocks are small, so that the B K
//   lanes spread over every SM.
// * pass B, placement: a stream compaction of the scratch words by the
//   bitmap, chunk by chunk.  rans_encode_count_kernel counts the emits of
//   each tile of kEncTileWords bitmap words; rans_encode_place_kernel
//   takes a tile's base (n_pad - E + the tiles before it), scans the
//   popcounts of its words and lets one warp per word write each emitted
//   word to base + prefix + __popc of the lower bits, and writes the
//   cursor of each segment's first step (seg_g).
//
// The division is exact integer u32 `/` (the TPU's f32 long division was
// a workaround); the three launches follow each other on one stream.
// Ring depth and lookahead: the fastest of a sweep of ring depths 8-32
// and lookaheads 1-2 on the H100.
// ---------------------------------------------------------------------------
constexpr int kEncAhead = 16;         // ring of (symbol, row) steps
constexpr int kEncLook = 1;           // table lookups done this many steps ahead
constexpr int kEncLanesMax = 256;     // most threads of a pass-A block
constexpr int kEncTileWords = 256;    // bitmap words (of 32 elements) a tile
constexpr int kEncPlaceThreads = 256;
static_assert(kEncTileWords == kEncPlaceThreads,
              "the placement scans one bitmap word per thread");
static_assert((kEncAhead & (kEncAhead - 1)) == 0 && kEncLook < kEncAhead,
              "the ring is a power of two deeper than the lookahead");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__global__ void __launch_bounds__(kEncLanesMax)
    rans_encode_lanes_kernel(const int* __restrict__ sym,
                             const int* __restrict__ rows,
                             const uint16_t* __restrict__ cdf_g, int vec,
                             int n_rows, int n_sym, int B, int n_pad,
                             int kshift, int flag_words,
                             uint16_t* __restrict__ words,
                             uint32_t* __restrict__ flags,
                             uint32_t* __restrict__ states) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [kEncAhead slots][blockDim][symbol, row]: each thread's own lane, so a
  // thread reads only what its own cp.async wrote (no barrier).
  int* ring = reinterpret_cast<int*>(smem);
  const int bd = blockDim.x;
  uint16_t* cdf = reinterpret_cast<uint16_t*>(ring + 2 * kEncAhead * bd);
  const int K = 1 << kshift;
  const int steps = n_pad >> kshift;
  const int g = blockIdx.x * bd + threadIdx.x;   // b K + lane
  const bool active = g < B * K;
  const int b = active ? g >> kshift : 0;
  const int lane = g & (K - 1);
  const int* sp = sym + (size_t)b * n_pad + lane;
  const int* rp = rows + (size_t)b * n_pad + lane;
  int* my = ring + 2 * threadIdx.x;
  // Step t's pair sits in slot t % kEncAhead; one commit group per step.
  // Every thread always copies, so the copy takes no branch: an inactive
  // lane, or a step below 0, copies some element of the chunk into a slot
  // that no live step reads.
  auto fill = [&](int* slot, const int* s_src, const int* r_src) {
    cp_async4(slot, s_src);
    cp_async4(slot + 1, r_src);
    cp_async_commit();
  };
  auto slot_of = [&](int t) { return my + 2 * (t & (kEncAhead - 1)) * bd; };
  for (int d = 0; d < kEncAhead; ++d) {
    const int t = steps - 1 - d;
    const size_t off = t >= 0 ? (size_t)t << kshift : 0;
    fill(slot_of(t), sp + off, rp + off);
  }
  // The table; symbols and rows outside it are a caller bug, which
  // clamping keeps inside shared memory.
  const int count = n_rows * n_sym;
  const int n16 = vec ? count >> 3 : 0;
  for (int i = threadIdx.x; i < n16; i += bd)
    cp_async16(cdf + 8 * i, cdf_g + 8 * i);
  cp_async_commit();
  for (int i = 8 * n16 + threadIdx.x; i < count; i += bd) cdf[i] = cdf_g[i];
  cp_async_wait<0>();
  __syncthreads();

  // A lane group of the warp: the whole warp, or a chunk when K < 32.
  const int grp = K < 32 ? K : 32;
  const unsigned gmask = grp == 32 ? 0xffffffffu : (1u << grp) - 1u;
  const int gshift = threadIdx.x & 31 & ~(grp - 1);
  const bool lead = active && (lane & (grp - 1)) == 0;
  uint32_t* fq = flags + (size_t)b * flag_words;
  // The store of step t, and the copy sources of step t - kEncAhead, move
  // down K elements a step.
  const ptrdiff_t top = (ptrdiff_t)(steps - 1) << kshift;
  uint16_t* wq = words + (size_t)b * n_pad + lane + top;
  const ptrdiff_t ahead = (ptrdiff_t)kEncAhead << kshift;
  const int* sq = sp + top - ahead;
  const int* rq = rp + top - ahead;
  int e = (int)top + lane;                 // element t K + lane
  // Slot of step t0 - d: the same for every group of kEncAhead steps.
  const int s0 = steps - 1;

  // Start and frequency of the step whose pair is in `slot` (clamped
  // nonsense for a step below 0).
  auto lookup = [&](const int* slot, uint32_t& start, uint32_t& freq) {
    const int2 sr = *reinterpret_cast<const int2*>(slot);
    const int s = clamp_index(sr.x, n_sym);
    const uint16_t* row = cdf + clamp_index(sr.y, n_rows) * n_sym;
    start = row[s];
    freq = (s + 1 < n_sym ? (uint32_t)row[s + 1] : kProbScale) - start;
  };
  uint32_t la_start[kEncLook], la_freq[kEncLook];   // steps t .. t - L + 1
#pragma unroll
  for (int l = 0; l < kEncLook; ++l)
    lookup(slot_of(s0 - l), la_start[l], la_freq[l]);
  uint32_t x = kRansL, acc = 0;
  // The step body has no branch, so the compiler can overlap the lookups
  // ahead with this step's chain; steps past 0 in the last group of
  // kEncAhead change nothing (`live`).
  for (int t0 = steps - 1; t0 >= 0; t0 -= kEncAhead) {
#pragma unroll
    for (int d = 0; d < kEncAhead; ++d) {
      const int t = t0 - d;
      const bool live = t >= 0;
      // Off the chain: step t - kEncAhead's pair into the slot step t
      // left (read kEncLook steps ago), then the lookup of step t - L,
      // whose copy is complete once at most kEncAhead - L groups pend.
      const bool real = t >= kEncAhead;
      fill(slot_of(s0 - d), real ? sq : sym, real ? rq : rows);
      sq -= K;
      rq -= K;
      cp_async_wait<kEncAhead - kEncLook>();
      uint32_t start_n, freq_n;
      lookup(slot_of(s0 - d - kEncLook), start_n, freq_n);
      const uint32_t start = la_start[0], freq = la_freq[0];
#pragma unroll
      for (int l = 0; l + 1 < kEncLook; ++l) {
        la_start[l] = la_start[l + 1];
        la_freq[l] = la_freq[l + 1];
      }
      la_start[kEncLook - 1] = start_n;
      la_freq[kEncLook - 1] = freq_n;
      // The chain: x >= freq << 16 as (x >> 16) >= freq (no overflow at
      // freq = 2^16), then x' = (q << 16) + (xs - q freq) + start written
      // as q (2^16 - freq) + xs + start (mod 2^32, exact: x' < 2^32).
      const uint32_t hi = x >> 16;
      const bool emit = hi >= freq;
      const uint16_t word = (uint16_t)(x & 0xFFFFu);
      const uint32_t xs = emit ? hi : x;
      const uint32_t q = xs / freq;
      const uint32_t xn = q * (kProbScale - freq) + xs + start;
      x = live ? xn : x;
      if (active && live) *wq = word;
      wq -= K;
      const unsigned m = __ballot_sync(0xffffffffu, emit && active && live);
      // Bit e of the chunk's bitmap is element e = t K + lane: with K >= 32
      // a lead's mask is one whole word; below, a word gathers 32 / K
      // steps, stored at its lowest step.
      const int sh = e & 31;
      acc |= ((m >> gshift) & gmask) << sh;
      if (lead && live && sh == 0) fq[e >> 5] = acc;
      acc = sh == 0 ? 0u : acc;
      e -= K;
    }
  }
  cp_async_wait<0>();
  if (active) states[g] = x;
}

// Emits per tile of kEncTileWords bitmap words: tile_tot[b, j].
__global__ void __launch_bounds__(kEncPlaceThreads)
    rans_encode_count_kernel(const uint32_t* __restrict__ flags,
                             int flag_words, int n_tiles,
                             int* __restrict__ tile_tot) {
  __shared__ int warp_sum[kEncPlaceThreads / 32];
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int w = j * kEncTileWords + threadIdx.x;
  int c = 0;
  for (int i = w; i < (j + 1) * kEncTileWords && i < flag_words;
       i += blockDim.x)
    c += __popc(flags[(size_t)b * flag_words + i]);
  c = (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_sum[i];
    tile_tot[b * n_tiles + j] = s;
  }
}

// Pass B's placement of one tile of one chunk (see K1 above).
__global__ void __launch_bounds__(kEncPlaceThreads)
    rans_encode_place_kernel(const uint16_t* __restrict__ words,
                             const uint32_t* __restrict__ flags,
                             const int* __restrict__ tile_tot, int n_pad,
                             int K, int flag_words, int n_tiles,
                             int4 seg_start, int n_seg,
                             uint16_t* __restrict__ buf,
                             int* __restrict__ seg_g) {
  constexpr int kWarps = kEncPlaceThreads / 32;
  __shared__ uint32_t fw[kEncTileWords];
  __shared__ int pre[kEncTileWords];
  __shared__ int warp_sum[kWarps];
  __shared__ int base_s;
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int w0 = j * kEncTileWords;
  const int nw = min(kEncTileWords, flag_words - w0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;

  // The tile's base: n_pad - E + the emits of the tiles before it.
  if (wid == 0) {
    unsigned all = 0, before = 0;
    for (int i = lane; i < n_tiles; i += 32) {
      const unsigned v = (unsigned)tile_tot[b * n_tiles + i];
      all += v;
      before += i < j ? v : 0u;
    }
    all = __reduce_add_sync(0xffffffffu, all);
    before = __reduce_add_sync(0xffffffffu, before);
    if (lane == 0) base_s = n_pad - (int)all + (int)before;
  }
  // Exclusive prefix of the words' popcounts within the tile (one word
  // per thread: kEncTileWords == kEncPlaceThreads).
  const uint32_t f =
      tid < nw ? flags[(size_t)b * flag_words + w0 + tid] : 0u;
  const int c = __popc(f);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[wid] = incl;
  fw[tid] = f;
  __syncthreads();
  int wbase = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) wbase += i < wid ? warp_sum[i] : 0;
  pre[tid] = wbase + incl - c;
  __syncthreads();
  const int base = base_s;

  // Segment cursors: the position of each segment's first element.
  if (tid < n_seg) {
    const int st[4] = {seg_start.x, seg_start.y, seg_start.z, seg_start.w};
    const int e = st[tid] * K;
    const int w = (e >> 5) - w0;
    if (w >= 0 && w < nw) {
      seg_g[b * n_seg + tid] =
          base + pre[w] + __popc(fw[w] & ((1u << (e & 31)) - 1u));
    }
  }

  // One warp per bitmap word, one lane per element: the emitted words of
  // a bitmap word land side by side.
  const uint16_t* wb = words + (size_t)b * n_pad + (size_t)w0 * 32;
  uint16_t* ob = buf + (size_t)b * n_pad;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll 4
  for (int w = wid; w < nw; w += kWarps) {
    const uint32_t m = fw[w];
    if ((m >> lane) & 1u) ob[base + pre[w] + __popc(m & lt)] = wb[w * 32 + lane];
  }
}

// ---------------------------------------------------------------------------
// K2: batched K-stream rANS decode with a resumable (states, g) carry.
//
// Bound, as K1: the serial step chain (a step needs the previous step's
// states and word cursor g).  Design: one block per chunk, each thread
// owning L adjacent lanes, and only the lookup, the rank and the word read
// on the chain:
// * the rows of step t + 2 are loaded into registers during step t;
// * the word stream sits in a shared-memory ring of kRing chunks of
//   max(K, 8) words: the reads of a step lie in [g, g + K) and g grows by
//   at most K per step, so each chunk is refilled by cp.async at least
//   kRing - 2 steps before it is read (words past w_cap are written as 0,
//   like the zero-padded buffer of the JAX decoder);
// * slot -> symbol through a per-row index of the symbol holding each
//   bucket's first slot, flagged where the bucket holds that symbol alone
//   (RansTable.index): most lookups end there, the others search only
//   between two neighbouring entries (the TPU's one-hot MXU lookups were
//   a workaround);
// * the table in one of two layouts, the first that fits a block
//   (coding/vrans.py:decode_layout): kWide, each symbol's start and
//   frequency in one 32-bit word (RansTable.start_freq), so the common
//   lookup is two shared-memory loads; else the u16 CDF (cdf16), start
//   and next edge in two loads, for the larger alphabets (ac 128 and 256),
//   with as many index bits as still fit;
// * one barrier per step: lanes are ranked within a warp by __ballot_sync
//   and __popc, across warps through double-buffered warp totals.
// ---------------------------------------------------------------------------
constexpr int kRing = 8;            // ring chunks of max(K, 8) words
// The slot index (RansTable.index; coding/vrans.py:index_format picks
// the entry type): 2^bits + 1 entries per row, u8 (rows of at most 128
// symbols, bits <= 9) or u16 (bits <= 8); the top bit flags a bucket
// that holds one symbol.
template <typename IndexT>
struct SlotIndex {
  static constexpr uint32_t kSingle = sizeof(IndexT) == 1 ? 0x80u : 0x8000u;
};

// Issues the copy of words [c W, c W + W), W = 2^cshift, of one chunk's
// stream into its ring slot: 16-byte cp.async where the words are
// aligned and inside [0, w_cap), plain copies (0 outside) elsewhere.
__device__ __forceinline__ void ring_fill(uint16_t* ring, int ring_mask,
                                          const uint16_t* wb, int w_cap,
                                          bool vec, int c, int cshift) {
  const int segs = 1 << (cshift - 3);
  for (int i = threadIdx.x; i < segs; i += blockDim.x) {
    const int p = (c << cshift) + (i << 3);
    uint16_t* dst = ring + (p & ring_mask);
    if (vec && p >= 0 && p + 8 <= w_cap) {
      cp_async16(dst, wb + p);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int q = p + e;
        dst[e] = (q >= 0 && q < w_cap) ? wb[q] : (uint16_t)0;
      }
    }
  }
}

// A thread's L (1 or 2) adjacent ints at p: one 8-byte access where
// every thread owns two lanes (kAll; the launcher checks alignment), else
// one by one where the lanes exist.
template <int L, bool kAll>
__device__ __forceinline__ void load_lanes(int (&r)[L], const int* p,
                                           bool active) {
  if (kAll && L == 2) {
    const int2 v = active ? __ldg(reinterpret_cast<const int2*>(p))
                          : make_int2(0, 0);
    r[0] = v.x;
    r[1 % L] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) r[j] = active ? p[j] : 0;
  }
}

template <int L, bool kAll>
__device__ __forceinline__ void store_lanes(int* p, const int (&v)[L],
                                            bool active) {
  if (!active) return;
  if (kAll && L == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1 % L]);
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) p[j] = v[j];
  }
}

template <int L, bool kAll, typename IndexT, bool kWide>
__global__ void __launch_bounds__(1024)
    rans_decode_kernel(const uint16_t* __restrict__ words, int w_cap,
                       int vec, const uint32_t* __restrict__ states_in,
                       const int* __restrict__ rows,
                       const int* __restrict__ g0,
                       const void* __restrict__ tab_g,
                       const IndexT* __restrict__ index_g, int ix_bits,
                       int n_rows, int n_sym, int n_pad, int K, int cshift,
                       int* __restrict__ syms,
                       uint32_t* __restrict__ states_out,
                       int* __restrict__ g_out) {
  // kWide: start | (freq - 1) << 16 of each symbol; else the u16 CDF.
  using TabT = typename std::conditional<kWide, uint32_t, uint16_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int* warp_tot = reinterpret_cast<int*>(smem);              // [2][32]
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + 64 * sizeof(int));
  TabT* tab = reinterpret_cast<TabT*>(ring + (kRing << cshift));
  constexpr uint32_t kSingle = SlotIndex<IndexT>::kSingle;
  const int ix_shift = 16 - ix_bits;
  const int ix_stride = (1 << ix_bits) + 1;
  IndexT* sidx = reinterpret_cast<IndexT*>(tab + n_rows * n_sym);
  const TabT* tg = static_cast<const TabT*>(tab_g);
  for (int i = threadIdx.x; i < n_rows * n_sym; i += blockDim.x)
    tab[i] = tg[i];
  for (int i = threadIdx.x; i < n_rows * ix_stride; i += blockDim.x)
    sidx[i] = index_g[i];

  const int b = blockIdx.x;
  const uint16_t* wb = words + (size_t)b * w_cap;
  const int* rb = rows + (size_t)b * n_pad;
  int* ob = syms + (size_t)b * n_pad;
  const int steps = n_pad / K;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int lane0 = threadIdx.x * L;
  const bool active = kAll || lane0 < K;
  const int ring_mask = (kRing << cshift) - 1;

  uint32_t x[L];
#pragma unroll
  for (int j = 0; j < L; ++j)
    x[j] = active ? states_in[(size_t)b * K + lane0 + j] : 0u;
  int g = g0[b];
  int issued = g >> cshift;            // floor: the chunk holding g
  for (int c = issued; c < issued + kRing; ++c)
    ring_fill(ring, ring_mask, wb, w_cap, vec != 0, c, cshift);
  issued += kRing;
  cp_async_commit();
  cp_async_wait<0>();

  // Rows of step t + 2 at rq, symbols of step t at oq.
  const int* rq = rb + lane0;
  int* oq = ob + lane0;
  int r0[L], r1[L];
  load_lanes<L, kAll>(r0, rq, active && steps > 0);
  load_lanes<L, kAll>(r1, rq + K, active && steps > 1);
  rq += 2 * K;
  __syncthreads();

  for (int t = 0; t < steps; ++t, rq += K, oq += K) {
    int rc[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      rc[j] = r0[j];
      r0[j] = r1[j];
    }
    load_lanes<L, kAll>(r1, rq, active && t + 2 < steps);

    // The L lookups side by side: index entries, then the rare bounded
    // searches, then the start / frequency words.
    bool need[L];
    int sy[L];
    uint32_t e[L], slot[L];
    const TabT* row[L];
    const IndexT* ix[L];
    bool search = false;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int r = active ? clamp_index(rc[j], n_rows) : 0;
      row[j] = tab + r * n_sym;
      ix[j] = sidx + r * ix_stride;
      slot[j] = x[j] & (kProbScale - 1);
      e[j] = ix[j][slot[j] >> ix_shift];
      sy[j] = (int)(e[j] & ~kSingle);
      search |= !(e[j] & kSingle);
    }
    if (search) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (e[j] & kSingle) continue;
        // start(lo) <= slot < start(hi + 1)
        int lo = sy[j];
        int hi = (int)(ix[j][(slot[j] >> ix_shift) + 1] & ~kSingle);
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if ((row[j][mid] & 0xFFFFu) <= slot[j]) lo = mid; else hi = mid - 1;
        }
        sy[j] = lo;
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint32_t start, freq;
      if constexpr (kWide) {
        const uint32_t w = row[j][sy[j]];
        start = w & 0xFFFFu;
        freq = (w >> 16) + 1;
      } else {
        start = row[j][sy[j]];
        freq = (sy[j] + 1 < n_sym ? (uint32_t)row[j][sy[j] + 1] : kProbScale)
               - start;
      }
      const uint32_t xs = freq * (x[j] >> 16) + slot[j] - start;
      need[j] = active && xs < kRansL;
      if (active) x[j] = xs;
    }
    store_lanes<L, kAll>(oq, sy, active);
    // Rank in lane order: the lanes of lower threads of the warp, then
    // this thread's lower lanes.
    int rank = 0, warp_cnt = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, need[j]);
      rank += __popc(m & lt_mask);
      warp_cnt += __popc(m);
    }
    int* tot = warp_tot + (t & 1) * 32;
    if (lane == 0) tot[wid] = warp_cnt;
    cp_async_wait<kRing - 3>();   // chunks issued kRing - 2 steps ago
    __syncthreads();
    const unsigned v = lane < n_warps ? (unsigned)tot[lane] : 0u;
    const int base = (int)__reduce_add_sync(0xffffffffu, lane < wid ? v : 0u);
    const int total = (int)__reduce_add_sync(0xffffffffu, v);

    // Every read of step t - 1 is behind the barrier, so the slot of the
    // chunk before g's may be refilled.
    const int c_cur = g >> cshift;
    while (issued < c_cur + kRing) {
      ring_fill(ring, ring_mask, wb, w_cap, vec != 0, issued, cshift);
      ++issued;
    }
    cp_async_commit();

    int p = g + base + rank;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (need[j]) {
        x[j] = (x[j] << 16) | ring[p & ring_mask];
        ++p;
      }
    }
    g += total;
  }
  cp_async_wait<0>();
  if (active) {
#pragma unroll
    for (int j = 0; j < L; ++j) states_out[(size_t)b * K + lane0 + j] = x[j];
  }
  if (threadIdx.x == 0) g_out[b] = g;
}

// ---------------------------------------------------------------------------
// K3: bilinear backward warp of a byte-packed YUV frame, border clamp.
//
// What bounds it on the H100: bytes.  Per output pixel it reads the two
// flow planes (8 B) and writes three f32 planes (12 B), and gathers four
// packed corners (4 B of source per pixel once each): ~24 B/pixel, ~50 MB
// per 4 frames of 1088x1920, ~60 us at the card's 3.35 TB/s.  Design: a
// 3-D grid (x-tile, row tile, frame), so no thread divides to find its
// pixel; a block of 16 x 16 threads covers 64 pixels x 16 rows, each
// thread 4 adjacent pixels of one row, with one 16-byte load of u and of
// v and one 16-byte store per output plane (kVec: W % 4 == 0 and u, v and
// out 16-byte aligned, which the launcher checks; otherwise pixel by
// pixel, for a ragged width or an unaligned base).  The corners are read
// through the read-only path (__ldg): |flow| <= 38 keeps a block's
// corners within a band of its 16 rows + 2 x 38 + 1, which L1 and L2
// serve; the square-ish tile keeps that band small for incoherent flows.
// The TPU's windowed select-accumulate was a workaround for its missing
// 2-D gather.  The arithmetic keeps warp_packed's operation order with
// explicit round-to-nearest intrinsics (no FMA contraction), so it is
// bit-identical to the plain PyTorch version run op by op on the card.
// A row window (row0, h) warps a band of a frame split over 'spatial':
// the band's flows and outputs, the whole frame's source rows; output
// row y samples row (row0 + y) + v, clamped to the frame, as the whole
// frame's row row0 + y does.
// ---------------------------------------------------------------------------
constexpr int kWarpTx = 16;   // threads along x, 4 pixels each
constexpr int kWarpTy = 16;   // rows

// The bilinear taps of one output pixel (x, y) of a backward warp by
// (u, v), border-clamped: plane offsets of the corners (rows y0 and
// min(y0 + 1, H - 1), columns x0 and min(x0 + 1, W - 1)) and the weights.
// Shared by K3 and K5, whose plain versions sample alike.
struct Taps {
  int i00, i01, i10, i11;
  float wx, wy;
};

__device__ __forceinline__ Taps bilinear_taps(int x, int y, float u,
                                              float v, int H, int W) {
  const float sx = fminf(fmaxf(__fadd_rn((float)x, u), 0.0f),
                         (float)(W - 1));
  const float sy = fminf(fmaxf(__fadd_rn((float)y, v), 0.0f),
                         (float)(H - 1));
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const int x0 = (int)x0f;
  const int x1 = min(x0 + 1, W - 1);
  const int r0 = (int)y0f * W;
  const int r1 = min((int)y0f + 1, H - 1) * W;
  return {r0 + x0, r0 + x1, r1 + x0, r1 + x1, __fsub_rn(sx, x0f),
          __fsub_rn(sy, y0f)};
}

__device__ __forceinline__ void warp_pixel(const int* __restrict__ src,
                                           int x, int y, float u, float v,
                                           int H, int W, float (&r)[3]) {
  const float inv255 = __int_as_float(0x3b808081);  // float32(1 / 255)
  const Taps t = bilinear_taps(x, y, u, v, H, W);
  const uint32_t c00 = (uint32_t)__ldg(src + t.i00);
  const uint32_t c01 = (uint32_t)__ldg(src + t.i01);
  const uint32_t c10 = (uint32_t)__ldg(src + t.i10);
  const uint32_t c11 = (uint32_t)__ldg(src + t.i11);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int sh = 8 * ch;
    const float v00 = __fmul_rn((float)((c00 >> sh) & 0xFFu), inv255);
    const float v01 = __fmul_rn((float)((c01 >> sh) & 0xFFu), inv255);
    const float v10 = __fmul_rn((float)((c10 >> sh) & 0xFFu), inv255);
    const float v11 = __fmul_rn((float)((c11 >> sh) & 0xFFu), inv255);
    const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), t.wx));
    const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), t.wx));
    r[ch] = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), t.wy));
  }
}

// kBand: a row window (row0, h) of the frame; the whole frame (row0 = 0,
// h = H) takes the instance without it, which keeps 32 registers (the
// window's indexing takes 39, a quarter less occupancy).
template <bool kVec, bool kBand>
__global__ void __launch_bounds__(kWarpTx * kWarpTy)
    warp_packed_kernel(const int* __restrict__ packed,
                       const float* __restrict__ u,
                       const float* __restrict__ v, int H, int W, int row0,
                       int h, float* __restrict__ out) {
  const int b = blockIdx.z;
  const int y = blockIdx.y * kWarpTy + threadIdx.y;
  const int x0 = (blockIdx.x * kWarpTx + threadIdx.x) * 4;
  const int rows = kBand ? h : H;
  if (y >= rows || x0 >= W) return;
  const size_t hw = (size_t)rows * W;
  const size_t row = (size_t)b * hw + (size_t)y * W + x0;
  const int* src = packed + (kBand ? (size_t)b * H * W : (size_t)b * hw);
  float* o0 = out + (size_t)b * 3 * hw + (size_t)y * W + x0;
  const int sy = kBand ? row0 + y : y;
  if (kVec) {
    const float4 uq = __ldg(reinterpret_cast<const float4*>(u + row));
    const float4 vq = __ldg(reinterpret_cast<const float4*>(v + row));
    const float uu[4] = {uq.x, uq.y, uq.z, uq.w};
    const float vv[4] = {vq.x, vq.y, vq.z, vq.w};
    float r[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) warp_pixel(src, x0 + j, sy, uu[j], vv[j], H, W, r[j]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      *reinterpret_cast<float4*>(o0 + ch * hw) =
          make_float4(r[0][ch], r[1][ch], r[2][ch], r[3][ch]);
    }
  } else {
    for (int j = 0; j < 4 && x0 + j < W; ++j) {
      float r[3];
      warp_pixel(src, x0 + j, sy, __ldg(u + row + j), __ldg(v + row + j), H,
                 W, r);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o0[ch * hw + j] = r[ch];
    }
  }
}

// ---------------------------------------------------------------------------
// K4: fused (I)GDN, NCHW.
//
// out[b, o, p] = x / n (x * n for the inverse), n = to_xtype(sqrt(
// sum_j x2[b, j, p] * gamma[o, j] + beta[o])), x2 = to_xtype(x * x).
//
// bf16 (every bf16 checkpoint): gdn_fused_tc_kernel.  What bounds it on
// the H100: bytes.  2 C flops per element against 4 bytes moved (C = 128:
// 64 flop/byte) is far under the tensor cores' ~295 flop/byte balance.
// The sum is the product D = gamma [128 out x C in] . x2 [C x pixels] on
// the tensor cores (mma.sync m16n8k16, f32 accumulation), as JAX's
// _gdn_kernel is an MXU product.  gamma (f32) enters as two bf16 terms,
// hi = bf16(gamma) and lo = bf16(gamma - hi), split by the wrapper: two
// products per tile keep ~16 bits of gamma; x2 = bf16(x * x) is an exact
// bf16 operand, squared in the B fragments.  Design: persistent blocks,
// two per SM, each for one image and one block of 128 output channels;
// gamma's hi / lo tile (64 KB) stays in shared memory for the block's
// life when C == 128 (reloaded per input chunk otherwise); x streams in
// [128 channels x 64 pixels] tiles through a 2-stage cp.async ring, the
// next tile in flight while this one is multiplied; 8 warps of 32 out x
// 32 pixels take their fragments by ldmatrix (.trans for x, pixel-major
// as NCHW lays it out) from XOR-swizzled tiles (no bank conflicts); the
// epilogue adds beta, takes the root, rounds to bf16 and divides
// (multiplies) x re-read from the staged tile, writes the result over
// it, and the tile leaves in 16-byte stores along pixels.  The tensor
// cores sum in their own order, so the result is not bit-identical to
// ops/gdn.py:gdn_fused_plain: the normaliser is within ~2^-16 relative
// of its ordered f32 sum before the rounding to bf16, so each output is
// within 2 bf16 ulps of the plain version.
//
// f32: gdn_fused_f32_kernel, on CUDA cores, bit-identical to
// gdn_fused_plain run op by op: the sum over j in order, each product and
// sum rounded (no FMA).  What bounds it: operations (2 C flops per
// element against 8 bytes, above the card's ~20 flop/byte f32 balance).
// Persistent blocks walk tiles of 64 pixels for 128 output channels;
// gamma^T chunks [128 j x 128 o] (64 KB, resident when C == 128) and the
// squared inputs (32 KB) sit in shared memory; 256 threads: 64 pixels
// (coalesced) x 4 groups of 32 output channels, a warp sharing its
// channels so gamma reads broadcast.
// ---------------------------------------------------------------------------
constexpr int kGdnPix = 64;
constexpr int kGdnOut = 128;
constexpr int kGdnChunk = 128;
constexpr int kGdnGroups = 4;   // output-channel groups of 32 per block
constexpr int kGdnPerThread = kGdnOut / kGdnGroups;
constexpr size_t kGdnSmem =
    (size_t)(kGdnChunk * kGdnOut + kGdnChunk * kGdnPix) * sizeof(float);

__global__ void __launch_bounds__(kGdnPix * kGdnGroups)
    gdn_fused_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ gamma_t,
                         const float* __restrict__ beta, int C, int HW,
                         int inverse, float* __restrict__ out) {
  extern __shared__ float gdn_smem[];
  float* gs = gdn_smem;                        // [kGdnChunk][kGdnOut]
  float* xs = gdn_smem + kGdnChunk * kGdnOut;  // [kGdnChunk][kGdnPix]
  const int tx = threadIdx.x % kGdnPix;
  const int ty = threadIdx.x / kGdnPix;
  const int o0 = blockIdx.y * kGdnOut;
  const size_t img = (size_t)blockIdx.z * C * HW;
  const int n_tiles = (HW + kGdnPix - 1) / kGdnPix;
  // With one chunk of input channels (C == 128) gammaT stays resident
  // across the block's pixel tiles; otherwise each chunk is reloaded.
  const bool resident = C == kGdnChunk;
  const float4* grow = reinterpret_cast<const float4*>(gs) +
                       ty * (kGdnPerThread / 4);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * kGdnPix;
    const int p = p0 + tx;
    float acc[kGdnPerThread];
#pragma unroll
    for (int k = 0; k < kGdnPerThread; ++k) acc[k] = 0.0f;

    for (int j0 = 0; j0 < C; j0 += kGdnChunk) {
      if (!resident || tile == (int)blockIdx.x) {
        for (int i = threadIdx.x; i < kGdnChunk * kGdnOut; i += blockDim.x) {
          const int jj = i / kGdnOut;
          const int oo = i - jj * kGdnOut;
          gs[i] = gamma_t[(size_t)(j0 + jj) * C + o0 + oo];
        }
      }
      for (int i = threadIdx.x; i < kGdnChunk * kGdnPix; i += blockDim.x) {
        const int jj = i / kGdnPix;
        const int pp = i - jj * kGdnPix;
        float v = 0.0f;
        if (p0 + pp < HW) {
          const float xv = x[img + (size_t)(j0 + jj) * HW + p0 + pp];
          v = __fmul_rn(xv, xv);
        }
        xs[i] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kGdnChunk; ++jj) {
        const float xv = xs[jj * kGdnPix + tx];
#pragma unroll
        for (int k4 = 0; k4 < kGdnPerThread / 4; ++k4) {
          const float4 g = grow[jj * (kGdnOut / 4) + k4];
          acc[4 * k4 + 0] = __fadd_rn(acc[4 * k4 + 0], __fmul_rn(xv, g.x));
          acc[4 * k4 + 1] = __fadd_rn(acc[4 * k4 + 1], __fmul_rn(xv, g.y));
          acc[4 * k4 + 2] = __fadd_rn(acc[4 * k4 + 2], __fmul_rn(xv, g.z));
          acc[4 * k4 + 3] = __fadd_rn(acc[4 * k4 + 3], __fmul_rn(xv, g.w));
        }
      }
      __syncthreads();
    }

    if (p < HW) {
#pragma unroll
      for (int k = 0; k < kGdnPerThread; ++k) {
        const int o = o0 + ty * kGdnPerThread + k;
        const float n = __fsqrt_rn(__fadd_rn(acc[k], beta[o]));
        const size_t i = img + (size_t)o * HW + p;
        const float xv = x[i];
        out[i] = inverse ? __fmul_rn(xv, n) : __fdiv_rn(xv, n);
      }
    }
  }
}

constexpr int kTcPix = 64;      // pixels per tile
constexpr int kTcCh = 128;      // output channels per block, input per chunk
constexpr int kTcThreads = 256;
constexpr int kTcGammaBytes = kTcCh * kTcCh * 2;   // one bf16 term
constexpr int kTcStageBytes = kTcCh * kTcPix * 2;
constexpr size_t kTcSmem = 2 * kTcGammaBytes + 2 * kTcStageBytes;  // 96 KB

// Byte offset of element (row, col) of a [rows][width] bf16 tile whose
// 16-byte chunks are XOR-swizzled by the row's low three bits, so the
// eight rows an ldmatrix reads at one column hit eight different banks.
__device__ __forceinline__ int swz(int row, int col, int width) {
  return row * width * 2 + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values squared, each rounded to bf16 once (x2 = to_bf16(x * x)).
__device__ __forceinline__ unsigned square_bf16x2(unsigned v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  h = __hmul2(h, h);
  memcpy(&v, &h, 4);
  return v;
}

// Issues the copy of x's [Rows channels from j0] x [Pix pixels from p0]
// tile into a stage: 16-byte cp.async where aligned and inside the
// image, plain copies (0 past HW) elsewhere.
template <int Rows = kTcCh, int Threads = kTcThreads, int Pix = kTcPix>
__device__ __forceinline__ void gdn_stage_fill(unsigned char* stage,
                                               const __nv_bfloat16* xi,
                                               int j0, int p0, int HW,
                                               bool vec) {
  for (int seg = threadIdx.x; seg < Rows * (Pix / 8); seg += Threads) {
    const int row = seg / (Pix / 8);
    const int col = (seg % (Pix / 8)) * 8;
    const int p = p0 + col;
    const __nv_bfloat16* src = xi + (size_t)(j0 + row) * HW + p;
    unsigned char* dst = stage + swz(row, col, Pix);
    if (vec && p + 8 <= HW) {
      cp_async16(dst, src);
    } else {
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = p + e < HW ? src[e] : __float2bfloat16_rn(0.0f);
    }
  }
}

// Loads gamma's hi and lo terms [128 out from o0] x [128 in from j0].
__device__ __forceinline__ void gdn_gamma_fill(unsigned char* a_hi,
                                               unsigned char* a_lo,
                                               const __nv_bfloat16* g_hi,
                                               const __nv_bfloat16* g_lo,
                                               int C, int o0, int j0) {
  for (int seg = threadIdx.x; seg < kTcCh * (kTcCh / 8); seg += kTcThreads) {
    const int row = seg >> 4;
    const int col = (seg & 15) << 3;
    const size_t src = (size_t)(o0 + row) * C + j0 + col;
    *reinterpret_cast<uint4*>(a_hi + swz(row, col, kTcCh)) =
        *reinterpret_cast<const uint4*>(g_hi + src);
    *reinterpret_cast<uint4*>(a_lo + swz(row, col, kTcCh)) =
        *reinterpret_cast<const uint4*>(g_lo + src);
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
    gdn_fused_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g_hi,
                        const __nv_bfloat16* __restrict__ g_lo,
                        const float* __restrict__ beta, int C, int HW,
                        int inverse, int vec,
                        __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* a_hi = tc_smem;
  unsigned char* a_lo = tc_smem + kTcGammaBytes;
  unsigned char* stages = tc_smem + 2 * kTcGammaBytes;
  const unsigned a_hi_s = (unsigned)__cvta_generic_to_shared(a_hi);
  const unsigned a_lo_s = (unsigned)__cvta_generic_to_shared(a_lo);
  const unsigned stages_s = (unsigned)__cvta_generic_to_shared(stages);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wo = warp & 3;            // 32 output channels
  const int wp = warp >> 2;           // 32 pixels
  const int o0 = blockIdx.y * kTcCh;
  const int n_ch = C / kTcCh;
  const size_t img = (size_t)blockIdx.z * C * HW;
  const __nv_bfloat16* xi = x + img;
  const int n_tiles = (HW + kTcPix - 1) / kTcPix;
  const int my_tiles =
      (int)blockIdx.x < n_tiles
          ? (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int items = my_tiles * n_ch;
  // Input chunks run from the one after the block's own, so the last
  // chunk staged is x's [o0, o0 + 128), which the epilogue divides.
  const int chunk0 = blockIdx.y + 1;

  // This thread's accumulator rows: 2 m-tiles x 2 halves.
  float bta[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bta[mi][h] = beta[o0 + wo * 32 + mi * 16 + (lane >> 2) + h * 8];

  if (items > 0) {
    gdn_stage_fill(stages, xi, (chunk0 % n_ch) * kTcCh,
                   blockIdx.x * kTcPix, HW, vec != 0);
  }
  cp_async_commit();
  if (n_ch == 1) gdn_gamma_fill(a_hi, a_lo, g_hi, g_lo, C, o0, 0);

  float acc[2][4][4];
  for (int it = 0; it < items; ++it) {
    const int ci = it % n_ch;
    const int tile = blockIdx.x + (it / n_ch) * gridDim.x;
    const int p0 = tile * kTcPix;
    unsigned char* stage = stages + (it & 1) * kTcStageBytes;
    const unsigned stage_s = stages_s + (it & 1) * kTcStageBytes;

    cp_async_wait<0>();
    __syncthreads();     // this item's tile is in; item it - 1 is done
    if (it + 1 < items) {
      const int ci1 = (it + 1) % n_ch;
      const int tile1 = blockIdx.x + ((it + 1) / n_ch) * gridDim.x;
      gdn_stage_fill(stages + ((it + 1) & 1) * kTcStageBytes, xi,
                     ((chunk0 + ci1) % n_ch) * kTcCh, tile1 * kTcPix, HW,
                     vec != 0);
    }
    cp_async_commit();
    if (n_ch > 1) {
      gdn_gamma_fill(a_hi, a_lo, g_hi, g_lo, C, o0,
                     ((chunk0 + ci) % n_ch) * kTcCh);
      __syncthreads();
    }

    if (ci == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int lcol = (lane >> 4) * 8;
#pragma unroll
    for (int k0 = 0; k0 < kTcCh; k0 += 16) {
      unsigned b[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        ldsm_x4_t(stage_s + swz(k0 + lrow, wp * 32 + nb * 16 + lcol, kTcPix),
                  b[nb]);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[nb][e] = square_bf16x2(b[nb][e]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int off = swz(wo * 32 + mi * 16 + lrow, k0 + lcol, kTcCh);
        unsigned ah[4], al[4];
        ldsm_x4(a_hi_s + off, ah);
        ldsm_x4(a_lo_s + off, al);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const unsigned b0 = b[ni >> 1][(ni & 1) * 2];
          const unsigned b1 = b[ni >> 1][(ni & 1) * 2 + 1];
          mma_bf16(acc[mi][ni], ah, b0, b1);
          mma_bf16(acc[mi][ni], al, b0, b1);
        }
      }
    }
    if (ci != n_ch - 1) continue;

    // Epilogue: rows o = wo*32 + mi*16 + lane/4 (+8), pixel pairs
    // wp*32 + ni*8 + 2*(lane%4).
    unsigned res[2][4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = wo * 32 + mi * 16 + (lane >> 2) + h * 8;
          const int p = wp * 32 + ni * 8 + (lane & 3) * 2;
          __nv_bfloat162 xv;
          memcpy(&xv, stage + swz(o, p, kTcPix), 4);
          float r[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float n = __bfloat162float(__float2bfloat16_rn(
                __fsqrt_rn(__fadd_rn(acc[mi][ni][h * 2 + e], bta[mi][h]))));
            const float xe = __bfloat162float(e ? xv.y : xv.x);
            r[e] = inverse ? __fmul_rn(xe, n) : __fdiv_rn(xe, n);
          }
          const __nv_bfloat162 rv = __floats2bfloat162_rn(r[0], r[1]);
          memcpy(&res[mi][ni][h], &rv, 4);
        }
    __syncthreads();     // every warp's fragments of this tile are read
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = wo * 32 + mi * 16 + (lane >> 2) + h * 8;
          const int p = wp * 32 + ni * 8 + (lane & 3) * 2;
          memcpy(stage + swz(o, p, kTcPix), &res[mi][ni][h], 4);
        }
    __syncthreads();
    __nv_bfloat16* oi = out + img;
    for (int seg = threadIdx.x; seg < kTcCh * (kTcPix / 8);
         seg += kTcThreads) {
      const int row = seg >> 3;
      const int col = (seg & 7) << 3;
      const int p = p0 + col;
      const unsigned char* src = stage + swz(row, col, kTcPix);
      __nv_bfloat16* dst = oi + (size_t)(o0 + row) * HW + p;
      if (vec && p + 8 <= HW) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(src);
        for (int e = 0; e < 8 && p + e < HW; ++e) dst[e] = s[e];
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K4 in the GDN layers (ops/gdn.py:GDN through gdn_layer_cuda): the
// product of gdn_fused_tc_kernel at the rounding points of
// ops/gdn.py:gdn_apply instead of gdn_pallas's, for C = 96 (MOFNet) and
// C = 128 (CodecNet).  JAX's layers run gdn_apply through XLA, which fuses
// its elementwise passes; without this kernel PyTorch runs them as up to
// seven passes over the tensor around a cuDNN 1x1 convolution.
//
//   s = to_bf16(sum_j x2[b, j, p] * gamma[o, j])  (f32, tensor cores)
//   lowp:  n = to_bf16(sqrt(to_bf16(s + to_bf16(beta[o]))));
//          out = to_bf16(x / n) (x * n for the inverse), bf16
//   else:  n = sqrt(s + beta[o]); out = x / n (x * n), f32
//
// gamma enters as hi + lo (~16 bits) as in gdn_fused_tc_kernel, and with
// lowp as hi alone, bf16(gamma), which is what gdn_apply casts it to.  So
// only the sum's order departs from gdn_apply (and, without lowp, gamma's
// ~16 bits against cuDNN's f32 or TF32); every rounding after the sum is
// gdn_apply's.  What bounds it: bytes (x read once, the output written
// once: 4 B an element with lowp, 6 without).  Design: gdn_fused_tc_kernel's
// with all C channels in one block: C / 32 x 2 warps of 32 output channels
// x kWarpPix pixels on [C x kPix pixel] tiles (GdnLayer); gamma resident
// for the block's life in rows of 128 bf16 (the swizzle's span, so that
// C = 96 stays inside its row); a cp.async ring of x tiles; the output
// stored straight from the fragments (store_row), a warp store covering
// whole 32-byte sectors of 8 rows.  A tile's arithmetic does
// not depend on the block that runs it, so an image's output does not
// depend on the batch or the grid.
//
// Channels-last x (kNhwc; the nets' layout between their convolutions,
// ops/layers.py) is read into [pixel x channel] tiles, rows of 128 bf16
// as gamma's, and its B fragments come from ldmatrix without .trans: the
// registers hold the same values as from an NCHW tile, so each output is
// bit-identical to the NCHW launch's.  The output is channels-last too.
// f32 (without lowp) is stored from the fragments a value at a time: a
// warp store covers 8 consecutive channels of 4 pixels, whole 32-byte
// sectors.  bf16 (lowp) would fill half sectors so: each output is
// written over its own x in the stage once every warp's products are
// done, and the tile goes out in 16-byte rows of pixels (two barriers
// more a tile).
// ---------------------------------------------------------------------------
constexpr int kLayerGammaW = 128;   // bf16 a gamma row in shared memory

template <int C, bool kLowp, bool kNhwc>
struct GdnLayer {
  static_assert(C % 32 == 0 && C <= kLayerGammaW, "C: 32 to 128 by 32");
  // Tiles of 128 pixels (64 a warp) in a 2-stage ring with lowp, of 64
  // (32 a warp) in a 3-stage ring without: each the fastest of five such
  // shapes at [8, C, 544, 960] (H100), both keeping two blocks an SM
  // (one block an SM took 2-3x as long), 128-pixel tiles halving the
  // fixed cost a tile where gamma's one term leaves the room.
  static constexpr int kPix = kLowp ? 128 : 64;       // pixels a tile
  static constexpr int kWarpPix = kLowp ? 64 : 32;    // pixels a warp
  static constexpr int kNi = kWarpPix / 8;
  static constexpr int kWarpsO = C / 32;
  static constexpr int kThreads = kWarpsO * (kPix / kWarpPix) * 32;
  static constexpr int kGammaBytes = C * kLayerGammaW * 2;   // one term
  // [C x kPix] of NCHW x; [kPix x kLayerGammaW] of channels-last x.
  static constexpr int kStageBytes =
      kNhwc ? kPix * kLayerGammaW * 2 : C * kPix * 2;
  static constexpr int kStages = kLowp ? 2 : 3;   // x tiles in the ring
  static constexpr size_t kSmem = (kLowp ? 1 : 2) * (size_t)kGammaBytes +
                                  kStages * (size_t)kStageBytes;
  using Out = typename std::conditional<kLowp, __nv_bfloat16, float>::type;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stores one row's 32 outputs of a quad of lanes (lane q = lane % 4 holds
// pixels 8 ni + 2 q, + 1 for ni = 0..3, r[ni]) at row[pw ..]: as f32 one
// 8-byte store a pair; as bf16 the quad first transposes its 4 x 4 words
// of pixel pairs (two shuffle rounds), so that lane q stores pixels 8 q ..
// 8 q + 7 in one 16-byte store and a warp store fills whole sectors.
// Pixels at or past HW are not stored.
__device__ __forceinline__ void store_row(float* row, int pw, int q,
                                          const float (&r)[4][2], int HW,
                                          bool vec) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int p = pw + ni * 8 + 2 * q;
    if (vec && p + 2 <= HW) {
      *reinterpret_cast<float2*>(row + p) = make_float2(r[ni][0], r[ni][1]);
    } else {
      if (p < HW) row[p] = r[ni][0];
      if (p + 1 < HW) row[p + 1] = r[ni][1];
    }
  }
}

__device__ __forceinline__ void store_row(__nv_bfloat16* row, int pw, int q,
                                          const float (&r)[4][2], int HW,
                                          bool vec) {
  unsigned v[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(r[ni][0], r[ni][1]);
    memcpy(&v[ni], &h, 4);
  }
  // Swap the off-diagonal 2 x 2 blocks (lanes q, q ^ 2), then transpose
  // each block (lanes q, q ^ 1): v[j] becomes lane j's v[q].
  const bool hi2 = q & 2, hi1 = q & 1;
  unsigned a = __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[2], 2);
  unsigned b = __shfl_xor_sync(0xffffffffu, hi2 ? v[1] : v[3], 2);
  if (hi2) { v[0] = a; v[1] = b; } else { v[2] = a; v[3] = b; }
  a = __shfl_xor_sync(0xffffffffu, hi1 ? v[0] : v[1], 1);
  b = __shfl_xor_sync(0xffffffffu, hi1 ? v[2] : v[3], 1);
  if (hi1) { v[0] = a; v[2] = b; } else { v[1] = a; v[3] = b; }
  const int p = pw + 8 * q;
  if (vec && p + 8 <= HW) {
    *reinterpret_cast<uint4*>(row + p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (p + i < HW) {
        row[p + i] = __ushort_as_bfloat16(
            (unsigned short)(v[i >> 1] >> ((i & 1) * 16)));
      }
    }
  }
}

// Stores a quad lane's 8 f32 outputs of one channel (pixels pw + 8 ni +
// 2 q, + 1, r[ni]) of channels-last output, channel 0 of pixel 0 at
// col[0] and pixels C apart; pixels at or past HW are not stored.
__device__ __forceinline__ void store_pixels(float* col, int C, int pw,
                                             int q, const float (&r)[4][2],
                                             int HW) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = pw + ni * 8 + 2 * q + e;
      if (p < HW) col[(size_t)p * C] = r[ni][e];
    }
}

// Copies a stage of channels-last bf16 outputs (rows of kLayerGammaW, as
// the x tiles) to pixels [p0, p0 + Pix) of out, 16 bytes a thread (one
// 16-byte store where aligned): a warp store covers 512 consecutive
// bytes.  Pixels at or past HW are not stored.
template <int C, int Threads, int Pix>
__device__ __forceinline__ void store_stage_nhwc(__nv_bfloat16* oi,
                                                 const unsigned char* stage,
                                                 int p0, int HW, bool vec) {
  for (int seg = threadIdx.x; seg < Pix * (C / 8); seg += Threads) {
    const int row = seg / (C / 8);
    const int col = (seg % (C / 8)) * 8;
    const int p = p0 + row;
    if (p >= HW) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(stage + swz(row, col, kLayerGammaW));
    __nv_bfloat16* dst = oi + (size_t)p * C + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      memcpy(dst, &v, 16);
    }
  }
}

// Issues the copy of channels-last x's pixels [p0, p0 + Pix) (all C
// channels) into a stage of rows of kLayerGammaW: 16-byte cp.async where
// aligned, plain copies elsewhere, 0 past HW.
template <int C, int Threads, int Pix>
__device__ __forceinline__ void gdn_stage_fill_nhwc(unsigned char* stage,
                                                    const __nv_bfloat16* xi,
                                                    int p0, int HW,
                                                    bool vec) {
  for (int seg = threadIdx.x; seg < Pix * (C / 8); seg += Threads) {
    const int row = seg / (C / 8);
    const int col = (seg % (C / 8)) * 8;
    const int p = p0 + row;
    unsigned char* dst = stage + swz(row, col, kLayerGammaW);
    if (p >= HW) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(dst, xi + (size_t)p * C + col);
    } else {
      const __nv_bfloat16* src = xi + (size_t)p * C + col;
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = src[e];
    }
  }
}

template <int C, bool kNhwc, int Threads, int Pix>
__device__ __forceinline__ void layer_fill(unsigned char* stage,
                                           const __nv_bfloat16* xi, int p0,
                                           int HW, bool vec) {
  if (kNhwc) {
    gdn_stage_fill_nhwc<C, Threads, Pix>(stage, xi, p0, HW, vec);
  } else {
    gdn_stage_fill<C, Threads, Pix>(stage, xi, 0, p0, HW, vec);
  }
}

template <int C, bool kLowp, bool kNhwc>
__global__ void __launch_bounds__(GdnLayer<C, kLowp, kNhwc>::kThreads)
    gdn_layer_tc_kernel(
        const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ g_hi,
        const __nv_bfloat16* __restrict__ g_lo,
        const float* __restrict__ beta, int HW, int inverse, int vec,
        typename GdnLayer<C, kLowp, kNhwc>::Out* __restrict__ out) {
  using L = GdnLayer<C, kLowp, kNhwc>;
  extern __shared__ __align__(128) unsigned char layer_smem[];
  unsigned char* a_hi = layer_smem;
  unsigned char* a_lo = layer_smem + L::kGammaBytes;   // without lowp
  unsigned char* stages = layer_smem + (kLowp ? 1 : 2) * L::kGammaBytes;
  const unsigned a_hi_s = (unsigned)__cvta_generic_to_shared(a_hi);
  const unsigned a_lo_s = (unsigned)__cvta_generic_to_shared(a_lo);
  const unsigned stages_s = (unsigned)__cvta_generic_to_shared(stages);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wo = warp % L::kWarpsO;   // 32 output channels
  const int wp = warp / L::kWarpsO;   // kWarpPix pixels
  const size_t img = (size_t)blockIdx.y * C * HW;
  const __nv_bfloat16* xi = x + img;
  const int n_tiles = (HW + L::kPix - 1) / L::kPix;
  const int my_tiles =
      (int)blockIdx.x < n_tiles
          ? (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;

  // This thread's accumulator rows: 2 m-tiles x 2 halves.
  float bta[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bta[mi][h] = beta[wo * 32 + mi * 16 + (lane >> 2) + h * 8];

  // The ring: tile t in stage t % kStages, kStages - 1 tiles ahead; one
  // commit group a tile (empty past the block's last).
#pragma unroll
  for (int t = 0; t < L::kStages - 1; ++t) {
    if (t < my_tiles) {
      layer_fill<C, kNhwc, L::kThreads, L::kPix>(
          stages + t * L::kStageBytes, xi,
          ((int)blockIdx.x + t * (int)gridDim.x) * L::kPix, HW, vec != 0);
    }
    cp_async_commit();
  }
  for (int seg = threadIdx.x; seg < C * (C / 8); seg += L::kThreads) {
    const int row = seg / (C / 8);
    const int col = (seg % (C / 8)) * 8;
    const size_t src = (size_t)row * C + col;
    *reinterpret_cast<uint4*>(a_hi + swz(row, col, kLayerGammaW)) =
        *reinterpret_cast<const uint4*>(g_hi + src);
    if (!kLowp) {
      *reinterpret_cast<uint4*>(a_lo + swz(row, col, kLayerGammaW)) =
          *reinterpret_cast<const uint4*>(g_lo + src);
    }
  }

  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  for (int it = 0; it < my_tiles; ++it) {
    const int p0 = ((int)blockIdx.x + it * (int)gridDim.x) * L::kPix;
    unsigned char* stage = stages + (it % L::kStages) * L::kStageBytes;
    const unsigned stage_s = stages_s + (it % L::kStages) * L::kStageBytes;

    cp_async_wait<L::kStages - 2>();
    __syncthreads();     // this tile (and gamma) is in; tile it - 1 is done
    const int ahead = it + L::kStages - 1;
    if (ahead < my_tiles) {
      layer_fill<C, kNhwc, L::kThreads, L::kPix>(
          stages + (ahead % L::kStages) * L::kStageBytes, xi,
          p0 + (L::kStages - 1) * (int)gridDim.x * L::kPix, HW, vec != 0);
    }
    cp_async_commit();

    float acc[2][L::kNi][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < L::kNi; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      unsigned b[L::kNi / 2][4];
#pragma unroll
      for (int nb = 0; nb < L::kNi / 2; ++nb) {
        const int pw = wp * L::kWarpPix + nb * 16;
        if (kNhwc) {
          // Matrix i = lane / 8: pixels + 8 (i / 2), channels + 8 (i % 2).
          ldsm_x4(stage_s + swz(pw + (lane & 7) + (lane >> 4) * 8,
                                k0 + ((lane >> 3) & 1) * 8, kLayerGammaW),
                  b[nb]);
        } else {
          ldsm_x4_t(stage_s + swz(k0 + lrow, pw + lcol, L::kPix), b[nb]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) b[nb][e] = square_bf16x2(b[nb][e]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int off =
            swz(wo * 32 + mi * 16 + lrow, k0 + lcol, kLayerGammaW);
        unsigned ah[4], al[4];
        ldsm_x4(a_hi_s + off, ah);
        if (!kLowp) ldsm_x4(a_lo_s + off, al);
#pragma unroll
        for (int ni = 0; ni < L::kNi; ++ni) {
          const unsigned b0 = b[ni >> 1][(ni & 1) * 2];
          const unsigned b1 = b[ni >> 1][(ni & 1) * 2 + 1];
          mma_bf16(acc[mi][ni], ah, b0, b1);
          if (!kLowp) mma_bf16(acc[mi][ni], al, b0, b1);
        }
      }
    }

    // Epilogue: rows o = wo*32 + mi*16 + lane/4 (+8), pixel pairs
    // wp*kWarpPix + ni*8 + 2*(lane%4), stored straight from the fragments
    // 32 pixels at a time (channels-last bf16: through the stage).
    typename L::Out* oi = out + img;
    if constexpr (kNhwc && kLowp) {
      __syncthreads();   // every warp's products have read this tile's x
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = wo * 32 + mi * 16 + (lane >> 2) + h * 8;
#pragma unroll
        for (int g4 = 0; g4 < L::kNi / 4; ++g4) {
          float r[4][2];
#pragma unroll
          for (int n4 = 0; n4 < 4; ++n4) {
            const int ni = g4 * 4 + n4;
            const int p = wp * L::kWarpPix + ni * 8 + (lane & 3) * 2;
            __nv_bfloat162 xv;
            if (kNhwc) {
              memcpy(&xv.x, stage + swz(p, o, kLayerGammaW), 2);
              memcpy(&xv.y, stage + swz(p + 1, o, kLayerGammaW), 2);
            } else {
              memcpy(&xv, stage + swz(o, p, L::kPix), 4);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s = round_bf16(acc[mi][ni][h * 2 + e]);
              const float n =
                  kLowp ? round_bf16(__fsqrt_rn(
                              round_bf16(__fadd_rn(s, bta[mi][h]))))
                        : __fsqrt_rn(__fadd_rn(s, bta[mi][h]));
              const float xe = __bfloat162float(e ? xv.y : xv.x);
              r[n4][e] = inverse ? __fmul_rn(xe, n) : __fdiv_rn(xe, n);
            }
          }
          const int pw = wp * L::kWarpPix + g4 * 32;
          if constexpr (kNhwc && kLowp) {
            // Over this thread's own x, which no warp reads again.
#pragma unroll
            for (int n4 = 0; n4 < 4; ++n4)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                *reinterpret_cast<__nv_bfloat16*>(
                    stage + swz(pw + n4 * 8 + (lane & 3) * 2 + e, o,
                                kLayerGammaW)) =
                    __float2bfloat16_rn(r[n4][e]);
              }
          } else if constexpr (kNhwc) {
            store_pixels(oi + o, C, p0 + pw, lane & 3, r, HW);
          } else {
            store_row(oi + (size_t)o * HW, p0 + pw, lane & 3, r, HW,
                      vec != 0);
          }
        }
      }
    if constexpr (kNhwc && kLowp) {
      __syncthreads();   // the tile's outputs are in the stage
      store_stage_nhwc<C, L::kThreads, L::kPix>(oi, stage, p0, HW, vec != 0);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K5: bilinear warp of float planes with the vertical flow clamped.
//
// Replaces aivc_tpu/ops/warp_pallas.py:warp_pallas (body
// _warp_plane_kernel).  out[b, c, y, x] = (1 - wy) * top + wy * bot, top /
// bot = h0 + (h1 - h0) * wx on rows y0 and min(y0 + 1, H - 1), where sx =
// clip(x + u, 0, W - 1) and sy = clip(y + clip(v, -vmax, vmax), 0, H - 1):
// the value that warp_pallas's select-accumulate over row offsets leaves,
// since it adds only exact zeros besides these two terms.  Explicit
// round-to-nearest intrinsics keep the plain version's operation order (no
// FMA), so it is bit-identical to ops/warp.py:warp_vclamped run op by op.
//
// What bounds it on the H100: bytes.  Per pixel it reads 8 B of flow and
// 4C B of source (each input once) and writes 4C B: 31.5 MB for 1 x 3 x
// 768 x 1280, 9.4 us at 3.35 TB/s; its ~10 float ops per channel are far
// below the FP32 rate.  Design: a 3-D grid (x-tile, row tile, image), so no
// thread divides to find its pixel.  A block of 32 x 8 threads, one warp
// per row, each thread 4 pixels of its row 32 apart: a warp covers 128
// pixels (W % 128 == 0, which the launcher checks, makes the x-tiles
// exact; rows past H are masked), and every warp access, flow loads,
// corner gathers and stores alike, covers 32 consecutive pixels, so on
// smooth flows each corner gather of a warp touches one or two 128-byte
// lines and the flow loads and stores are whole 128-byte lines.  Four
// adjacent pixels a thread with 16-byte flow loads and stores spread each
// gather of a warp over 128 pixels (4 lines), and a shared-memory
// transpose back to the interleaved order costs more than the wide
// accesses save: both were slower on the forward's flows (PERF.md).
// The block's 8 rows share their source rows: the bottom row that row r
// gathers is the top row of row r + 1 on smooth flows, and L1 serves it
// twice.  The taps are computed once per pixel; for C = 3 (every model)
// all 4 x 4 x 3 corner gathers of a thread go out through the read-only
// path (__ldg) before any arithmetic, so their latencies overlap (any
// other C: a channel at a time); at most 64 registers, so 4 blocks (32
// warps) fit an SM.  No shared-memory band: horizontal reach is unbounded
// (border clamp only), so a band could not hold every corner; the TPU
// staged its +-16-row window in VMEM because Mosaic has no 2-D gather.
// ---------------------------------------------------------------------------
constexpr int kVcTx = 32;   // threads along x: one warp
constexpr int kVcTy = 8;    // rows
constexpr int kVcPx = 4;    // pixels a thread, kVcTx apart

// vc_gather: the corners of a thread's pixels in one plane; vc_blend:
// their blends, stored.
__device__ __forceinline__ void vc_gather(const float* __restrict__ src,
                                          const Taps (&t)[kVcPx],
                                          float (&g)[kVcPx][4]) {
#pragma unroll
  for (int j = 0; j < kVcPx; ++j) {
    g[j][0] = __ldg(src + t[j].i00);
    g[j][1] = __ldg(src + t[j].i01);
    g[j][2] = __ldg(src + t[j].i10);
    g[j][3] = __ldg(src + t[j].i11);
  }
}

__device__ __forceinline__ void vc_blend(float* __restrict__ dst,
                                         const Taps (&t)[kVcPx],
                                         const float (&g)[kVcPx][4]) {
#pragma unroll
  for (int j = 0; j < kVcPx; ++j) {
    const float top = __fadd_rn(
        g[j][0], __fmul_rn(__fsub_rn(g[j][1], g[j][0]), t[j].wx));
    const float bot = __fadd_rn(
        g[j][2], __fmul_rn(__fsub_rn(g[j][3], g[j][2]), t[j].wx));
    dst[j * kVcTx] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, t[j].wy), top),
                               __fmul_rn(t[j].wy, bot));
  }
}

// kC > 0: C = kC known at compile time; kC == 0: C at run time.
template <int kC>
__global__ void __launch_bounds__(kVcTx * kVcTy, 4)
    warp_vclamped_kernel(const float* __restrict__ x,
                         const float* __restrict__ flow, int C, int H,
                         int W, float vmax, float* __restrict__ out) {
  const int y = blockIdx.y * kVcTy + threadIdx.y;
  if (y >= H) return;
  const int x0 = blockIdx.x * (kVcTx * kVcPx) + threadIdx.x;
  const int nc = kC > 0 ? kC : C;
  const size_t hw = (size_t)H * W;
  const int p = y * W + x0;
  const float* fu = flow + (size_t)blockIdx.z * 2 * hw + p;
  Taps t[kVcPx];
#pragma unroll
  for (int j = 0; j < kVcPx; ++j) {
    const float v = fminf(fmaxf(__ldg(fu + hw + j * kVcTx), -vmax), vmax);
    t[j] = bilinear_taps(x0 + j * kVcTx, y, __ldg(fu + j * kVcTx), v, H, W);
  }
  const size_t img = (size_t)blockIdx.z * nc * hw;
  const float* src = x + img;
  float* dst = out + img + p;
  if constexpr (kC > 0) {
    float g[kC][kVcPx][4];
#pragma unroll
    for (int c = 0; c < kC; ++c) vc_gather(src + c * hw, t, g[c]);
#pragma unroll
    for (int c = 0; c < kC; ++c) vc_blend(dst + c * hw, t, g[c]);
  } else {
    for (int c = 0; c < C; ++c) {
      float g[kVcPx][4];
      vc_gather(src + c * hw, t, g);
      vc_blend(dst + c * hw, t, g);
    }
  }
}

// ---------------------------------------------------------------------------
// K6: the conv stage, the input of a replicate-padded bf16 convolution of
// the nets (ops/layers.py:pad_stage_cuda; plain version pad_stage_plain).
//
//   out[b, y, x, c] = bf16(in[b, c, clamp(y - p, 0, H - 1),
//                                   clamp(x - p, 0, W - 1)])   for c < C,
//                   = 0                                         for c >= C
//
// out: bf16, channels-last [B, H + 2p, W + 2p, Co], Co >= C; in: f32 or
// bf16, NCHW (a transform's entry) or channels-last (between its
// convolutions).  Replication and the cast commute, so out is F.pad(in,
// mode="replicate").to(bf16) laid out channels-last, bit for bit, with
// Co - C zero channels after it.  The nets ask for Co = C rounded up to 8
// (the analyses' 3-, 6- and 9-channel entries; the conv's weight gets zero
// channels to match): cuDNN runs such a bf16 NHWC conv on the tensor
// cores, where with 6 channels it took a generic engine 2.6-3.5x as slow
// (H100, 1080p, a wave of 8).
//
// Replaces no TPU kernel.  On the TPU XLA folds the nets' edge padding and
// the cast to bf16 into the convolution's operand.  PyTorch ran them as
// passes of their own before each bf16 convolution: the replication pad
// in the activation's type (f32 behind every GDN layer without lowp), the
// cast, and cuDNN's NCHW -> NHWC transpose, with the output transposed
// back: about 18 bytes of traffic an f32 element before the conv read it.
// K6 is the one pass left, and the nets keep their activations
// channels-last between convolutions, so nothing is transposed back.
//
// What bounds it: bytes; it computes nothing.  Each input element is read
// once (the few border rows and columns again, from L2) and each output
// element written once: 6 bytes an f32 element, 4 a bf16 one.  Design:
// * channels-last in (pad_stage_nhwc_kernel): a thread stores 8 channels
//   of one output pixel in one 16-byte store, from one 16-byte (bf16) or
//   two (f32) loads of its source pixel; consecutive threads take
//   consecutive channels, then pixels, so every warp access is contiguous;
//   kStageVec such vectors a thread, their loads issued before the stores.
//   No shared memory.
// * NCHW in (pad_stage_nchw_kernel): a block takes a tile of an output
//   row, at most kStageTile elements of [channels x pixels]: it reads each
//   channel's row into shared memory (as bf16, rows padded by 2 elements
//   so that the transposed reads hit distinct banks), then writes the
//   tile along the output's channels-last row, the zero channels with the
//   last chunk.  Up to 256 pixels a tile where C is small (the 3 to 9
//   channels of the analysis's 1080p input).
// Both run one block a tile of an output row, over all rows of all
// images: a 1080p wave of 8 launches tens of thousands of blocks of 256
// threads, many for each of the 132 SMs.
// ---------------------------------------------------------------------------
constexpr int kStageThreads = 256;
constexpr int kStageVec = 2;        // 16-byte vectors a thread (NHWC in)
constexpr int kStageTile = 4096;    // elements of an NCHW tile
constexpr int kStageTileRows = 128;  // most channels in one NCHW tile

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
}

// 8 consecutive values from a 16-byte aligned src, as bf16 in one word.
__device__ __forceinline__ uint4 load8_bf16(const float* src) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  const __nv_bfloat162 h[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  uint4 r;
  memcpy(&r, h, 16);
  return r;
}
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* src) {
  return __ldg(reinterpret_cast<const uint4*>(src));
}

// kVec: 8 channels a step by 16-byte accesses (C % 8 == 0, both bases
// 16-byte aligned); else a channel a step.
// (kVec needs Co == C; else channels C .. Co - 1 are zeros.)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kStageThreads)
    pad_stage_nhwc_kernel(const T* __restrict__ in, int C, int H, int W,
                          int p, int rows, int Co,
                          __nv_bfloat16* __restrict__ out) {
  constexpr int kStep = kVec ? 8 : 1;
  const int Hp = H + 2 * p, Wp = W + 2 * p;
  const int per_px = Co / kStep;
  const int n = Wp * per_px;   // steps in an output row
  const int i0 = blockIdx.x * (kStageThreads * kStageVec) + threadIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = row / Hp;
    const int y = row - b * Hp;
    const T* src = in + ((size_t)b * H + clamp_index(y - p, H)) * W * C;
    __nv_bfloat16* dst = out + (size_t)row * Wp * Co;
    if constexpr (kVec) {
      uint4 v[kStageVec];
#pragma unroll
      for (int u = 0; u < kStageVec; ++u) {
        const int i = i0 + u * kStageThreads;
        if (i < n) {
          const int x = i / per_px;
          v[u] = load8_bf16(src + (size_t)clamp_index(x - p, W) * C +
                            (i - x * per_px) * 8);
        }
      }
#pragma unroll
      for (int u = 0; u < kStageVec; ++u) {
        const int i = i0 + u * kStageThreads;
        if (i < n) *reinterpret_cast<uint4*>(dst + (size_t)i * 8) = v[u];
      }
    } else {
#pragma unroll
      for (int u = 0; u < kStageVec; ++u) {
        const int i = i0 + u * kStageThreads;
        if (i < n) {
          const int x = i / Co;
          const int c = i - x * Co;
          dst[i] = c < C ? to_bf16(src[(size_t)clamp_index(x - p, W) * C + c])
                         : __float2bfloat16_rn(0.0f);
        }
      }
    }
  }
}

// A tile: 2^tx_shift pixels of an output row from x0, cc channels at a
// time (cc <= kStageTileRows, cc << tx_shift <= kStageTile); the last
// chunk also writes the zero channels C .. Co - 1.
template <typename T>
__global__ void __launch_bounds__(kStageThreads)
    pad_stage_nchw_kernel(const T* __restrict__ in, int C, int H, int W,
                          int p, int rows, int tx_shift, int cc, int Co,
                          __nv_bfloat16* __restrict__ out) {
  __shared__ __nv_bfloat16 tile[kStageTile + 2 * kStageTileRows];
  const int tx = 1 << tx_shift;
  const int ld = tx + 2;
  const int Hp = H + 2 * p, Wp = W + 2 * p;
  const int x0 = blockIdx.x * tx;
  const int npx = Wp - x0 < tx ? Wp - x0 : tx;
  const size_t plane = (size_t)H * W;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = row / Hp;
    const int y = row - b * Hp;
    const T* src = in + (size_t)b * C * plane +
                   (size_t)clamp_index(y - p, H) * W;
    __nv_bfloat16* dst = out + ((size_t)row * Wp + x0) * Co;
    for (int c0 = 0; c0 < C; c0 += cc) {
      const int nc = C - c0 < cc ? C - c0 : cc;
      const int nw = c0 + nc == C ? Co - c0 : nc;   // channels written
      for (int e = threadIdx.x; e < (nc << tx_shift); e += kStageThreads) {
        const int c = e >> tx_shift;
        const int px = e & (tx - 1);
        if (px < npx) {
          tile[c * ld + px] = to_bf16(
              src[(size_t)(c0 + c) * plane + clamp_index(x0 + px - p, W)]);
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < npx * nw; e += kStageThreads) {
        const int px = e / nw;
        const int c = e - px * nw;
        dst[(size_t)px * Co + c0 + c] =
            c < nc ? tile[c * ld + px] : __float2bfloat16_rn(0.0f);
      }
      __syncthreads();   // the tile is read before the next chunk lands
    }
  }
}

// ---------------------------------------------------------------------------
// K7: a channels-last bf16 1x1 convolution on the tensor cores, with the
// bias, the activation and the residual folded into the same pass: ELIC's
// bottlenecks and attention gates (models/elic.py through
// ops/conv1x1.py:conv1x1_cuda).
//
// Replaces no TPU kernel.  On the TPU XLA fuses a 1x1 convolution's bias
// and the elementwise work around it into the convolution.  PyTorch ran
// each as a pass of its own around cuDNN: the bias add after every conv,
// the ReLUs, the residual add, the sigmoid, the gate's product and sum,
// with cuDNN's NCHW <-> NHWC transposes around every bf16 conv.  A
// channels-last 1x1 convolution is a plain product [P pixels x K in] .
// [K x N out], so one kernel reads its input once, writes its output once,
// and does the elementwise work on the way in and out.
//
// Three epilogues, at the unfused path's rounding points (cuDNN rounds
// the conv to bf16, then PyTorch's bias add, ReLU, sigmoid, product and
// sum each round once), acc the f32 product:
//   relu      out = relu(bf16(bf16(acc) + b))                 (conv a)
//   residual  the A operand is relu(bf16(r + b_in)), r the raw output of
//             the 3x3 conv before it (run without its bias b_in);
//             out = bf16(x + bf16(bf16(acc) + b))             (conv c)
//   gate      out = bf16(x + bf16(t * bf16(sigmoid(bf16(bf16(acc) + b)))))
//             with sigmoid as PyTorch's CUDA op: 1 / (1 + expf(-v))
// So only the order of the f32 K-sum departs from cuDNN's.
//
// What bounds it on the H100: bytes.  At ELIC's widths a pixel costs 2 K N
// operations against 2 (K + N) bytes and more (the residual, the trunk):
// 64 operations a byte for 192 -> 96, against the card's 295.  Design:
// * the block's weights [NT x K] (NT of the N outputs: N <= 192 in one
//   block column, else two or three, c1_ntile) stay in shared memory for
//   the block's life, rows padded by 16 bytes so that the eight rows an
//   ldmatrix reads land in eight bank groups (2 K + 16 bytes a row, an
//   odd multiple of 16); the biases of a thread's outputs in registers;
// * tiles of kC1Pix pixels x K stream through a ring of S stages by
//   16-byte cp.async along C, S the most that leaves room for two blocks
//   an SM (c1_stages: two blocks of 2 stages ran 192 -> 96 1.6x as fast
//   as one block of 4);
// * 2 x NT / 32 warps, each 32 pixels x 32 outputs, on mma.sync
//   m16n8k16 (bf16 in, f32 sum), both operands by ldmatrix;
// * the epilogue on the accumulator fragments, the residual and trunk
//   rows of the tile brought into shared memory by cp.async while the
//   products run; the outputs staged in shared memory and written out 16
//   bytes a thread along C;
// * a persistent grid, blocks over (pixel tiles, output columns), enough
//   to fill every SM slot; the ragged pixel tail is zero-filled and not
//   stored.
// Measured (H100, PERF.md): 72.7% of the byte bound at [8, 192 -> 96, 544,
// 960] (relu), 72.3% at [8, 96 -> 192, 544, 960] (residual), 50.6% for the
// gate at [8, 192, 272, 480]; bits equal to cuDNN's on those inputs.
// A pixel's output depends only on its own row, the weights and the
// fixed order of the k-steps: the tile shape is chosen by (K, N) alone,
// nothing splits K, so an image gives the same bits alone and in a wave.
// ---------------------------------------------------------------------------
constexpr int kC1Pix = 64;                 // pixels a tile (2 warp rows)
constexpr int kC1KMax = 320;               // widest input
constexpr int kC1NMax = 320;               // widest output
constexpr int kC1NTile = 192;              // most outputs a block column
constexpr int kC1MaxThreads = kC1Pix * kC1NTile / 32;   // 384
constexpr int kC1Segs = 4;   // 16-byte output vectors a thread a tile

enum { kC1Relu = 0, kC1Residual = 1, kC1Gate = 2 };

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  unsigned u;
  memcpy(&u, &h, 4);
  return u;
}

// ReLU as PyTorch's (clamp_min(v, 0): NaN kept).
__device__ __forceinline__ float c1_relu(float v) { return v < 0.0f ? 0.0f : v; }

// One output element from its rounded sum s, bias b, residual x, trunk t.
template <int EPI>
__device__ __forceinline__ float c1_out(float s, float b, float x, float t) {
  const float v = round_bf16(__fadd_rn(s, b));
  if constexpr (EPI == kC1Relu) {
    return c1_relu(v);
  } else if constexpr (EPI == kC1Residual) {
    return __fadd_rn(x, v);
  } else {
    const float sg =
        round_bf16(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v))));
    return __fadd_rn(x, round_bf16(__fmul_rn(t, sg)));
  }
}

// Issues the copy of pixels [p0, p0 + kC1Pix) of a [P x K] into a stage
// (rows of lda): 16-byte cp.async, zeros past P.  The residual epilogue's
// c1_relu_bias walks the same chunks in the same order.
__device__ __forceinline__ void c1_fill(__nv_bfloat16* stage,
                                        const __nv_bfloat16* a, int p0, int P,
                                        int K, int lda) {
  const int kc = K >> 3;
  for (int seg = threadIdx.x; seg < kC1Pix * kc; seg += blockDim.x) {
    const int row = seg / kc;
    const int col = (seg - row * kc) << 3;
    __nv_bfloat16* dst = stage + row * lda + col;
    if (p0 + row < P) {
      cp_async16(dst, a + (size_t)(p0 + row) * K + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The residual epilogue's A operand: relu(bf16(r + b_in)) over the chunks
// this thread copied (its own cp.async writes are visible to it once
// waited for; the barrier after makes them everyone's).
__device__ __forceinline__ void c1_relu_bias(__nv_bfloat16* stage,
                                             const __nv_bfloat16* b_in,
                                             int K, int lda) {
  const int kc = K >> 3;
  for (int seg = threadIdx.x; seg < kC1Pix * kc; seg += blockDim.x) {
    const int row = seg / kc;
    const int col = (seg - row * kc) << 3;
    uint4* v = reinterpret_cast<uint4*>(stage + row * lda + col);
    const uint4 b = *reinterpret_cast<const uint4*>(b_in + col);
    uint4 r = *v;
    unsigned* rv = &r.x;
    const unsigned* bv = &b.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rv[i] = bf16x2_rn(
          c1_relu(round_bf16(__fadd_rn(bf16_lo(rv[i]), bf16_lo(bv[i])))),
          c1_relu(round_bf16(__fadd_rn(bf16_hi(rv[i]), bf16_hi(bv[i])))));
    }
    *v = r;
  }
}

// Issues the copy of the epilogue's operand rows [p0, p0 + kC1Pix) x
// outputs [n0, n0 + nv) of a [P x N] tensor into a tile of rows of ldo
// (16-byte cp.async; rows past P and columns past nv are left as they
// are: nothing reads them into a stored output).
__device__ __forceinline__ void c1_fill_out(__nv_bfloat16* tile,
                                            const __nv_bfloat16* src, int p0,
                                            int P, int N, int n0, int nv,
                                            int NT, int ldo) {
  const int segs_row = NT >> 3;
  for (int seg = threadIdx.x; seg < kC1Pix * segs_row; seg += blockDim.x) {
    const int row = seg / segs_row;
    const int col = (seg - row * segs_row) << 3;
    if (p0 + row < P && col < nv) {
      cp_async16(tile + row * ldo + col,
                 src + (size_t)(p0 + row) * N + n0 + col);
    }
  }
}

// All but the newest n commit groups done (n in 0 .. 4).
__device__ __forceinline__ void c1_wait(int n) {
  switch (n) {
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// a [P x K], w [N x K], bias [N], b_in [K] (residual), res and trunk
// [P x N] (residual: res; gate: both), out [P x N]; all bf16, rows
// contiguous.  Block (x, y): output columns [y NT, y NT + NT) of every
// gridDim.x-th pixel tile from x; 2 NT / 32 warps.
//
// Commit groups: the A tiles of the ring, and for the residual and the
// gate one more a tile, its res / trunk rows, issued after the top
// barrier into a single tile (ot, tt) and waited for before the
// epilogue; the prologue commits an empty group after each A tile so
// that the top of every iteration waits for the same count.  The
// epilogue runs on the fragments: each thread's rounded sums, its 8
// biases (in registers), res / trunk pairs from shared memory, the
// result written over res (or into ot for relu), then the tile goes
// out 16 bytes a thread along C.
template <int EPI>
__global__ void __launch_bounds__(kC1MaxThreads)
    conv1x1_tc_kernel(const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ b_in,
                      const __nv_bfloat16* __restrict__ res,
                      const __nv_bfloat16* __restrict__ trunk, int P, int K,
                      int N, int NT, int S,
                      __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char c1_smem[];
  constexpr bool kOperands = EPI != kC1Relu;
  const int lda = K + 8;    // A and weight rows: 2 K + 16 bytes
  const int ldo = NT + 8;   // output rows: 2 NT + 16 bytes
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(c1_smem);
  __nv_bfloat16* as = ws + NT * lda;
  __nv_bfloat16* ot = as + S * kC1Pix * lda;   // res, then the output
  __nv_bfloat16* tt = ot + kC1Pix * ldo;       // trunk (gate)
  __nv_bfloat16* bis = tt + (EPI == kC1Gate ? kC1Pix * ldo : 0);
  const unsigned ws_s = (unsigned)__cvta_generic_to_shared(ws);
  const unsigned as_s = (unsigned)__cvta_generic_to_shared(as);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wp = warp % (kC1Pix / 32);   // 32 pixels
  const int wn = warp / (kC1Pix / 32);   // 32 outputs
  const int n0 = blockIdx.y * NT;
  const int nv = N - n0 < NT ? N - n0 : NT;   // outputs of this column
  const int n_tiles = (P + kC1Pix - 1) / kC1Pix;
  const int my_tiles =
      (int)blockIdx.x < n_tiles
          ? (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int kc = K >> 3;

  // The column's weights (zero rows past N), with tile 0's commit group;
  // b_in by plain stores; this thread's biases in registers.
  for (int seg = threadIdx.x; seg < NT * kc; seg += blockDim.x) {
    const int row = seg / kc;
    const int col = (seg - row * kc) << 3;
    __nv_bfloat16* dst = ws + row * lda + col;
    if (row < nv) {
      cp_async16(dst, w + (size_t)(n0 + row) * K + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if constexpr (EPI == kC1Residual) {
    for (int i = threadIdx.x; i < K; i += blockDim.x) bis[i] = b_in[i];
  }
  float bv[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * 32 + ni * 8 + (lane & 3) * 2 + e;
      bv[ni][e] = col < nv ? __bfloat162float(bias[n0 + col]) : 0.0f;
    }
  // The ring: tile t in stage t % S, S - 1 tiles ahead.
  for (int t = 0; t < S - 1; ++t) {
    if (t < my_tiles) {
      c1_fill(as + t * kC1Pix * lda, a,
              ((int)blockIdx.x + t * (int)gridDim.x) * kC1Pix, P, K, lda);
    }
    cp_async_commit();
    if constexpr (kOperands) cp_async_commit();
  }
  __syncthreads();   // b_in is in

  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;   // A: pixels
  const int lcol = (lane >> 4) * 8;                      //    k
  const int brow = (lane & 7) + (lane >> 4) * 8;         // B: outputs
  const int bcol = ((lane >> 3) & 1) * 8;                //    k
  const int segs_row = NT >> 3;
  for (int it = 0; it < my_tiles; ++it) {
    const int p0 = ((int)blockIdx.x + it * (int)gridDim.x) * kC1Pix;
    const int slot = it % S;
    c1_wait(kOperands ? 2 * (S - 2) : S - 2);   // tile it is in
    if constexpr (EPI == kC1Residual) {
      c1_relu_bias(as + slot * kC1Pix * lda, bis, K, lda);
    }
    __syncthreads();   // tile it is everyone's; tile it - 1 is out
    if constexpr (kOperands) {
      c1_fill_out(ot, res, p0, P, N, n0, nv, NT, ldo);
      if constexpr (EPI == kC1Gate) {
        c1_fill_out(tt, trunk, p0, P, N, n0, nv, NT, ldo);
      }
      cp_async_commit();
    }
    const int ahead = it + S - 1;
    if (ahead < my_tiles) {
      c1_fill(as + (ahead % S) * kC1Pix * lda, a,
              p0 + (S - 1) * (int)gridDim.x * kC1Pix, P, K, lda);
    }
    cp_async_commit();

    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    const unsigned st_s = as_s + slot * kC1Pix * lda * 2;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_x4(st_s + ((wp * 32 + mi * 16 + lrow) * lda + k0 + lcol) * 2,
                af[mi]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        ldsm_x4(ws_s + ((wn * 32 + nb * 16 + brow) * lda + k0 + bcol) * 2,
                bf[nb]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
    if constexpr (kOperands) {
      cp_async_wait<1>();   // this tile's res / trunk (not the A ahead)
      __syncthreads();
    }

    // Epilogue on the fragments: rows (pixels) wp*32 + mi*16 + lane/4
    // (+8), columns (outputs) wn*32 + ni*8 + 2*(lane%4) (+1).
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wp * 32 + mi * 16 + (lane >> 2) + h * 8;
          const int col = wn * 32 + ni * 8 + (lane & 3) * 2;
          unsigned* o = reinterpret_cast<unsigned*>(ot + row * ldo + col);
          unsigned xv = 0u, tv = 0u;
          if constexpr (kOperands) xv = *o;
          if constexpr (EPI == kC1Gate) {
            tv = *reinterpret_cast<const unsigned*>(tt + row * ldo + col);
          }
          *o = bf16x2_rn(
              c1_out<EPI>(round_bf16(acc[mi][ni][h * 2]), bv[ni][0],
                          bf16_lo(xv), bf16_lo(tv)),
              c1_out<EPI>(round_bf16(acc[mi][ni][h * 2 + 1]), bv[ni][1],
                          bf16_hi(xv), bf16_hi(tv)));
        }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kC1Segs; ++j) {
      const int seg = threadIdx.x + j * blockDim.x;
      const int row = seg / segs_row;
      const int col = (seg - row * segs_row) << 3;
      if (p0 + row < P && col < nv) {
        *reinterpret_cast<uint4*>(out + (size_t)(p0 + row) * N + n0 + col) =
            *reinterpret_cast<const uint4*>(ot + row * ldo + col);
      }
    }
  }
  cp_async_wait<0>();
}

// A K2 block: min(K, kDecodeThreads) threads, at least one warp.
// kDecodeThreads (1024) was K2's fastest of 1024, 512 and 256 threads at
// K = 2048 on the H100 (PERF.md).
constexpr int kDecodeThreads = 1024;

int rans_threads(int K) {
  int t = K < kDecodeThreads ? K : kDecodeThreads;
  return t < 32 ? 32 : t;
}


template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
  return cudaSuccess;
}

// Pass A of K1: the (symbol, row) ring of a block of `threads`, then the
// table.
constexpr size_t kEncRingBytesPerThread = 2 * kEncAhead * sizeof(int);

size_t rans_encode_smem(int n_rows, int n_sym, int threads) {
  return kEncRingBytesPerThread * threads +
         (size_t)n_rows * n_sym * sizeof(uint16_t);
}

// K1's launch state of one device, set up at its first call there: the SM
// count, and pass A's shared-memory limit raised once to the card's most
// (so a call makes no attribute query or set).
struct EncodeDevice {
  int sms;        // 0: not set up yet
  int smem_max;
};

cudaError_t encode_device(EncodeDevice* out) {
  constexpr int kMaxDevices = 64;
  static EncodeDevice cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  EncodeDevice& d = cache[dev];
  if (d.sms == 0) {
    int sms = 0, smem_max = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(rans_encode_lanes_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_max);
    }
    if (err != cudaSuccess) return err;
    d.smem_max = smem_max;
    d.sms = sms;
  }
  *out = d;
  return cudaSuccess;
}

// K1's scratch, one allocation: the words u16 [B, n_pad], the emit bitmap
// u32 [B, flag words] and the emits per placement tile i32 [B, tiles],
// each part 16-byte aligned.
int rans_encode_flag_words(int n_pad) { return (n_pad + 31) / 32; }

int rans_encode_tiles(int n_pad) {
  return (rans_encode_flag_words(n_pad) + kEncTileWords - 1) / kEncTileWords;
}

size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

size_t rans_encode_words_bytes(int B, int n_pad) {
  return align16((size_t)B * n_pad * sizeof(uint16_t));
}

size_t rans_encode_flags_bytes(int B, int n_pad) {
  return align16((size_t)B * rans_encode_flag_words(n_pad) * sizeof(uint32_t));
}

// log2 of K2's ring chunk: max(K, 8) words, so a chunk fills by 16-byte
// copies.
int ring_chunk_shift(int K) {
  int s = 3;
  while ((1 << s) < K) ++s;
  return s;
}

// Mirrored by coding/vrans.py:decode_smem_bytes, which picks the layout.
size_t rans_decode_smem(int n_rows, int n_sym, int K, int index_bytes,
                        int ix_bits, bool wide) {
  return 64 * sizeof(int) +
         ((size_t)kRing << ring_chunk_shift(K)) * sizeof(uint16_t) +
         (size_t)n_rows * n_sym * (wide ? sizeof(uint32_t) : sizeof(uint16_t)) +
         (size_t)n_rows * ((1 << ix_bits) + 1) * index_bytes;
}

template <int L, bool kAll, typename IndexT, bool kWide>
cudaError_t launch_decode(int threads, const uint16_t* words, int w_cap,
                          const uint32_t* states_in, const int* rows,
                          const int* g0, const void* tab, const void* index,
                          int ix_bits, int n_rows, int n_sym, int B,
                          int n_pad, int K, int* syms, uint32_t* states_out,
                          int* g_out, cudaStream_t stream) {
  const size_t smem =
      rans_decode_smem(n_rows, n_sym, K, sizeof(IndexT), ix_bits, kWide);
  cudaError_t err = set_smem(rans_decode_kernel<L, kAll, IndexT, kWide>, smem);
  if (err != cudaSuccess) return err;
  const int vec = (w_cap % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(words) % 16 == 0);
  rans_decode_kernel<L, kAll, IndexT, kWide><<<B, threads, smem, stream>>>(
      words, w_cap, vec, states_in, rows, g0, tab,
      static_cast<const IndexT*>(index), ix_bits, n_rows, n_sym, n_pad, K,
      ring_chunk_shift(K), syms, states_out, g_out);
  return cudaGetLastError();
}

// Blocks for a persistent K4 launch: enough to fill every SM slot once
// over all images and blocks of 128 output channels, at most one per tile.
template <typename Kern>
cudaError_t gdn_grid(Kern kern, int threads, size_t smem, int B, int C,
                     int n_tiles, dim3* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) err = set_smem(kern, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return err;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long groups = (long)B * (C / kGdnOut);
  const long per_image = (slots + groups - 1) / groups;
  *grid = dim3((unsigned)(per_image < n_tiles ? per_image : n_tiles),
               (unsigned)(C / kGdnOut), (unsigned)B);
  return cudaSuccess;
}

// A persistent launch of gdn_layer_tc_kernel<C, kLowp, kNhwc>: enough
// blocks to fill every SM slot once over the images, at most one per tile.
// The slots are found at the first launch on each device and kept, since
// the layers launch it many times a frame.
template <int C, bool kLowp, bool kNhwc>
cudaError_t gdn_layer_launch(const void* x, const void* g_hi,
                             const void* g_lo, const float* beta, int B,
                             int HW, int inverse, void* out,
                             cudaStream_t stream) {
  using L = GdnLayer<C, kLowp, kNhwc>;
  static long slots[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = set_smem(gdn_layer_tc_kernel<C, kLowp, kNhwc>, L::kSmem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gdn_layer_tc_kernel<C, kLowp, kNhwc>, L::kThreads,
          L::kSmem);
    }
    if (err != cudaSuccess) return err;
    slots[dev] = (long)sms * (per_sm > 0 ? per_sm : 1);
  }
  const long n_tiles = (HW + L::kPix - 1) / L::kPix;
  const long per_image = (slots[dev] + B - 1) / B;
  const dim3 grid((unsigned)(per_image < n_tiles ? per_image : n_tiles),
                  (unsigned)B);
  // 16-byte copies: every row of the tiles starts 16-byte aligned (a
  // channels-last pixel holds C * 2 bytes, a multiple of 16).
  const int vec = (kNhwc || HW % 8 == 0) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gdn_layer_tc_kernel<C, kLowp, kNhwc>
      <<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g_hi),
      static_cast<const __nv_bfloat16*>(g_lo), beta, HW, inverse, vec,
      static_cast<typename L::Out*>(out));
  return cudaGetLastError();
}

size_t c1_smem_bytes(int epi, int K, int NT, int S) {
  return 2 * ((size_t)NT * (K + 8) + (size_t)S * kC1Pix * (K + 8) +
              (size_t)(epi == kC1Gate ? 2 : 1) * kC1Pix * (NT + 8) + K);
}

// Shared memory of one H100 SM, of which each resident block also takes
// 1 KB for the system, and the most one block may have (227 KB).
constexpr size_t kSmemPerSm = 233472;
constexpr int kMaxSmemBlock = 232448;

// K7's ring: the most stages (4 to 2) that leave room for two blocks an
// SM, else the most that fit one.  A function of (EPI, K, NT).
int c1_stages(int epi, int K, int NT) {
  for (int blocks = 2; blocks >= 1; --blocks) {
    for (int s = 4; s >= 2; --s) {
      const size_t b = c1_smem_bytes(epi, K, NT, s);
      if (b <= (size_t)kMaxSmemBlock && blocks * (b + 1024) <= kSmemPerSm) {
        return s;
      }
    }
  }
  return 0;
}

// K7's block column: the fewest columns of at most kC1NTile outputs (a
// multiple of 32) whose block fits shared memory (N <= 192 in one column,
// 320 in two, the gate at K 320 in three).  A function of (EPI, K, N).
int c1_ntile(int epi, int K, int N) {
  for (int cols = (N + kC1NTile - 1) / kC1NTile; cols <= N / 32 + 1;
       ++cols) {
    const int per = (N + cols - 1) / cols;
    const int nt = (per + 31) / 32 * 32;
    if (c1_stages(epi, K, nt) > 0) return nt;
  }
  return 0;
}

// A persistent launch of conv1x1_tc_kernel<EPI>: enough blocks to fill
// every SM slot once over the output columns, at most one per pixel tile.
// The slots of each (K, NT) are found at its first launch on each device
// and kept, since the nets launch K7 about a hundred times a wave.
template <int EPI>
cudaError_t conv1x1_launch(const void* a, const void* w, const void* bias,
                           const void* b_in, const void* res,
                           const void* trunk, int P, int K, int N,
                           void* out, cudaStream_t stream) {
  static long slots[64][kC1KMax / 16 + 1][kC1NTile / 32 + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const int NT = c1_ntile(EPI, K, N);
  if (NT == 0) return cudaErrorInvalidValue;
  const int S = c1_stages(EPI, K, NT);
  const size_t smem = c1_smem_bytes(EPI, K, NT, S);
  const int threads = kC1Pix * NT / 32;
  long& sl = slots[dev][K / 16][NT / 32];
  if (sl == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = set_smem(conv1x1_tc_kernel<EPI>, kMaxSmemBlock);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv1x1_tc_kernel<EPI>, threads, smem);
    }
    if (err != cudaSuccess) return err;
    sl = (long)sms * (per_sm > 0 ? per_sm : 1);
  }
  const long cols = (N + NT - 1) / NT;
  const long n_tiles = (P + kC1Pix - 1) / kC1Pix;
  const long per_col = (sl + cols - 1) / cols;
  const dim3 grid((unsigned)(per_col < n_tiles ? per_col : n_tiles),
                  (unsigned)cols);
  conv1x1_tc_kernel<EPI><<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(b_in),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<const __nv_bfloat16*>(trunk), P, K, N, NT, S,
      static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes K1 needs for a table of n_rows x n_sym: pass A at
// its smallest block (one warp), to which the launcher shrinks a block
// whose ring and table would not fit.
size_t aivc_rans_encode_smem_bytes(int n_rows, int n_sym) {
  return rans_encode_smem(n_rows, n_sym, 32);
}

// Bytes of K1's scratch for B chunks of n_pad symbols.
size_t aivc_rans_encode_scratch_bytes(int B, int n_pad) {
  return rans_encode_words_bytes(B, n_pad) +
         rans_encode_flags_bytes(B, n_pad) +
         (size_t)B * rans_encode_tiles(n_pad) * sizeof(int);
}

// Shared-memory bytes K2 needs at K for that table in its layout (wide:
// start_freq, else cdf16) and its slot index of 2^ix_bits + 1 entries of
// index_bytes per row.
size_t aivc_rans_decode_smem_bytes(int n_rows, int n_sym, int K,
                                   int index_bytes, int ix_bits, int wide) {
  return rans_decode_smem(n_rows, n_sym, K, index_bytes, ix_bits, wide != 0);
}

// K1.  sym, rows: i32 [B, n_pad]; cdf: u16 [n_rows, n_sym]; K a power of
// two that divides n_pad; seg_start: the first step of each of n_seg <= 4
// segments; scratch: aivc_rans_encode_scratch_bytes(B, n_pad) bytes.  Out:
// buf u16 [B, n_pad] (chunk b's words are buf[b, seg_g[b, 0]:n_pad]),
// states u32 [B, K], seg_g i32 [B, n_seg].  Three launches: pass A, the
// tile counts, the placement.
int aivc_rans_encode(const int* sym, const int* rows, const uint16_t* cdf,
                     int n_rows, int n_sym, int B, int n_pad, int K,
                     int s0, int s1, int s2, int s3, int n_seg,
                     void* scratch, uint16_t* buf, uint32_t* states,
                     int* seg_g, cudaStream_t stream) {
  if (K < 1 || (K & (K - 1)) || n_pad % K || n_seg < 1 || n_seg > 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  int kshift = 0;
  while ((1 << kshift) < K) ++kshift;
  const int flag_words = rans_encode_flag_words(n_pad);
  const int n_tiles = rans_encode_tiles(n_pad);
  char* sc = static_cast<char*>(scratch);
  uint16_t* words = reinterpret_cast<uint16_t*>(sc);
  uint32_t* flags =
      reinterpret_cast<uint32_t*>(sc + rans_encode_words_bytes(B, n_pad));
  int* tile_tot = reinterpret_cast<int*>(
      sc + rans_encode_words_bytes(B, n_pad) +
      rans_encode_flags_bytes(B, n_pad));
  EncodeDevice d;
  cudaError_t err = encode_device(&d);
  if (err != cudaSuccess) return (int)err;
  // Pass A: the fewest warps a block that still spread the lanes over
  // every SM, and no more than the ring beside the table leaves room for.
  const size_t table = (size_t)n_rows * n_sym * sizeof(uint16_t);
  const long fit = table > (size_t)d.smem_max
                       ? 0
                       : (long)((d.smem_max - table) /
                                kEncRingBytesPerThread) / 32 * 32;
  const long lanes = (long)B * K;
  long per = (lanes + d.sms - 1) / d.sms;
  per = (per + 31) / 32 * 32;
  per = per < 32 ? 32 : (per > kEncLanesMax ? kEncLanesMax : per);
  if (fit < 32) return (int)cudaErrorInvalidValue;
  const int threads = (int)(per < fit ? per : fit);
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  const size_t smem = rans_encode_smem(n_rows, n_sym, threads);
  const int vec = (reinterpret_cast<uintptr_t>(cdf) & 15) == 0;
  rans_encode_lanes_kernel<<<blocks, threads, smem, stream>>>(
      sym, rows, cdf, vec, n_rows, n_sym, B, n_pad, kshift, flag_words,
      words, flags, states);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_tiles, (unsigned)B);
  rans_encode_count_kernel<<<grid, kEncPlaceThreads, 0, stream>>>(
      flags, flag_words, n_tiles, tile_tot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rans_encode_place_kernel<<<grid, kEncPlaceThreads, 0, stream>>>(
      words, flags, tile_tot, n_pad, K, flag_words, n_tiles,
      make_int4(s0, s1, s2, s3), n_seg, buf, seg_g);
  return (int)cudaGetLastError();
}

// K2.  words u16 [B, w_cap]; states_in u32 [B, K]; rows i32 [B, n_pad];
// g0 i32 [B]; tab u32 [n_rows, n_sym] (wide: RansTable.start_freq) or u16
// [n_rows, n_sym] (RansTable.cdf16); index u8 (index_bytes 1) or u16
// (index_bytes 2) [n_rows, 2^ix_bits + 1] (RansTable.index).
// Out: syms i32 [B, n_pad], states_out u32 [B, K], g_out [B].
int aivc_rans_decode(const uint16_t* words, int w_cap,
                     const uint32_t* states_in, const int* rows,
                     const int* g0, const void* tab, int wide,
                     const void* index, int index_bytes, int ix_bits,
                     int n_rows, int n_sym, int B, int n_pad, int K,
                     int* syms, uint32_t* states_out, int* g_out,
                     cudaStream_t stream) {
  if (K < 1 || K > 2 * kDecodeThreads || ix_bits < 0 ||
      ix_bits > (index_bytes == 1 ? 9 : 8) ||
      (index_bytes != 1 && index_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = rans_threads(K);
  const int L = K > threads ? K / threads : 1;
  if (L * threads < K) return (int)cudaErrorInvalidValue;
  // Every thread owns L lanes and the rows / symbols are 16-byte
  // aligned: vector accesses, no lane checks.
  const bool all = L * threads == K &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(syms) % 16 == 0;
  const bool small = index_bytes == 1;
#define AIVC_DECODE_W(LL, ALL, IX, WIDE)                                    \
  launch_decode<LL, ALL, IX, WIDE>(threads, words, w_cap, states_in, rows,  \
                                   g0, tab, index, ix_bits, n_rows, n_sym,  \
                                   B, n_pad, K, syms, states_out, g_out,    \
                                   stream)
#define AIVC_DECODE_IX(LL, ALL, IX)                                         \
  (wide ? AIVC_DECODE_W(LL, ALL, IX, true) : AIVC_DECODE_W(LL, ALL, IX, false))
#define AIVC_DECODE(LL, ALL)                                                \
  (small ? AIVC_DECODE_IX(LL, ALL, uint8_t)                                 \
         : AIVC_DECODE_IX(LL, ALL, uint16_t))
  const cudaError_t err =
      L == 1 ? (all ? AIVC_DECODE(1, true) : AIVC_DECODE(1, false))
             : (all ? AIVC_DECODE(2, true) : AIVC_DECODE(2, false));
#undef AIVC_DECODE
#undef AIVC_DECODE_IX
#undef AIVC_DECODE_W
  return (int)err;
}

// K3.  packed i32 [B, H, W] (pack_yuv_u32); u, v f32 [B, h, W] flow
// planes of the output rows row0 .. row0 + h - 1 (a band of a frame split
// over a mesh's 'spatial' axis; row0 = 0, h = H for the whole frame).
// Out: f32 [B, 3, h, W].
int aivc_warp_packed(const int* packed, const float* u, const float* v,
                     int B, int H, int W, int row0, int h, float* out,
                     cudaStream_t stream) {
  if (row0 < 0 || h < 0 || row0 + h > H) return (int)cudaErrorInvalidValue;
  if (B == 0 || h == 0 || W == 0) return (int)cudaGetLastError();
  const dim3 block(kWarpTx, kWarpTy);
  const long gx = ((W + 3) / 4 + kWarpTx - 1) / kWarpTx;
  const long gy = (h + kWarpTy - 1) / kWarpTy;
  if (B > 65535 || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)B);
  // 16-byte flow loads and plane stores: every row starts 16-byte aligned.
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(u) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool band = row0 != 0 || h != H;
  if (vec && band) {
    warp_packed_kernel<true, true><<<grid, block, 0, stream>>>(
        packed, u, v, H, W, row0, h, out);
  } else if (vec) {
    warp_packed_kernel<true, false><<<grid, block, 0, stream>>>(
        packed, u, v, H, W, row0, h, out);
  } else if (band) {
    warp_packed_kernel<false, true><<<grid, block, 0, stream>>>(
        packed, u, v, H, W, row0, h, out);
  } else {
    warp_packed_kernel<false, false><<<grid, block, 0, stream>>>(
        packed, u, v, H, W, row0, h, out);
  }
  return (int)cudaGetLastError();
}

// K4, f32.  x f32 [B, C, HW]; gamma_t f32 [C, C] (gamma transposed:
// [j, o]); beta f32 [C]; C % 128 == 0.  Out: f32 [B, C, HW].
int aivc_gdn_fused(const float* x, const float* gamma_t, const float* beta,
                   int B, int C, int HW, int inverse, float* out,
                   cudaStream_t stream) {
  if (C % kGdnOut != 0 || C % kGdnChunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (HW + kGdnPix - 1) / kGdnPix;
  const int threads = kGdnPix * kGdnGroups;
  if (n_tiles == 0 || B == 0) return (int)cudaGetLastError();
  dim3 grid;
  cudaError_t err = gdn_grid(gdn_fused_f32_kernel, threads, kGdnSmem, B, C,
                             n_tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  gdn_fused_f32_kernel<<<grid, threads, kGdnSmem, stream>>>(
      x, gamma_t, beta, C, HW, inverse, out);
  return (int)cudaGetLastError();
}

// K4, bf16, on the tensor cores.  x bf16 [B, C, HW]; g_hi, g_lo bf16
// [C, C] ([o, j]: gamma = g_hi + g_lo to ~16 bits); beta f32 [C];
// C % 128 == 0.  Out: bf16 [B, C, HW].
int aivc_gdn_fused_bf16(const void* x, const void* g_hi, const void* g_lo,
                        const float* beta, int B, int C, int HW,
                        int inverse, void* out, cudaStream_t stream) {
  if (C % kTcCh != 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (HW + kTcPix - 1) / kTcPix;
  if (n_tiles == 0 || B == 0) return (int)cudaGetLastError();
  dim3 grid;
  cudaError_t err = gdn_grid(gdn_fused_tc_kernel, kTcThreads, kTcSmem, B, C,
                             n_tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  const int vec = HW % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gdn_fused_tc_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g_hi),
      static_cast<const __nv_bfloat16*>(g_lo), beta, C, HW, inverse, vec,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// K4 in a GDN layer, on the tensor cores.  x bf16 [B, C, HW] (nhwc 0) or
// channels-last [B, HW, C] (nhwc 1), C 96 or 128; g_hi, g_lo bf16 [C, C]
// ([o, j]; g_lo is not read with lowp); beta f32 [C] (bf16 values with
// lowp).  Out, in x's layout: bf16 with lowp, else f32.
int aivc_gdn_layer_bf16(const void* x, const void* g_hi, const void* g_lo,
                        const float* beta, int B, int C, int HW,
                        int inverse, int lowp, int nhwc, void* out,
                        cudaStream_t stream) {
  if (C != 96 && C != 128) return (int)cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return (int)cudaGetLastError();
  if (B > 65535) return (int)cudaErrorInvalidValue;
#define AIVC_LAYER(CC, LOWP, NHWC)                                          \
  gdn_layer_launch<CC, LOWP, NHWC>(x, g_hi, g_lo, beta, B, HW, inverse,    \
                                   out, stream)
#define AIVC_LAYER_C(CC, NHWC) \
  (lowp ? AIVC_LAYER(CC, true, NHWC) : AIVC_LAYER(CC, false, NHWC))
  const cudaError_t err =
      C == 96 ? (nhwc ? AIVC_LAYER_C(96, true) : AIVC_LAYER_C(96, false))
              : (nhwc ? AIVC_LAYER_C(128, true) : AIVC_LAYER_C(128, false));
#undef AIVC_LAYER_C
#undef AIVC_LAYER
  return (int)err;
}

// K6.  in f32 (in_bf16 0) or bf16 (in_bf16 1) [B, C, H, W], NCHW-
// contiguous (nhwc 0) or channels-last (nhwc 1); pad >= 0; Co >= C.  Out:
// bf16 channels-last [B, H + 2 pad, W + 2 pad, Co], channels C .. Co - 1
// zero.
int aivc_pad_stage(const void* in, int in_bf16, int nhwc, int B, int C,
                   int H, int W, int pad, int Co, void* out,
                   cudaStream_t stream) {
  if (B < 0 || C < 0 || H < 0 || W < 0 || pad < 0 || Co < C) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || C == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  const long Hp = H + 2L * pad, Wp = W + 2L * pad;
  const long rows = (long)B * Hp;
  if (rows > 0x7FFFFFFFL || Wp * Co > 0x7FFFFFFFL) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned gy = (unsigned)(rows < 65535 ? rows : 65535);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (nhwc) {
    const bool vec = C % 8 == 0 && Co == C &&
                     ((reinterpret_cast<uintptr_t>(in) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const long n = Wp * (vec ? Co / 8 : Co);
    const dim3 grid((unsigned)((n + kStageThreads * kStageVec - 1) /
                               (kStageThreads * kStageVec)), gy);
#define AIVC_STAGE(T, V)                                                    \
  pad_stage_nhwc_kernel<T, V><<<grid, kStageThreads, 0, stream>>>(          \
      static_cast<const T*>(in), C, H, W, pad, (int)rows, Co, o)
    if (in_bf16) {
      if (vec) AIVC_STAGE(__nv_bfloat16, true);
      else AIVC_STAGE(__nv_bfloat16, false);
    } else {
      if (vec) AIVC_STAGE(float, true);
      else AIVC_STAGE(float, false);
    }
#undef AIVC_STAGE
  } else {
    // The widest tile of at most kStageTile elements that holds every
    // channel, 32 to 256 pixels; past 128 channels, chunks of 128.
    int tx_shift = 5;
    while (tx_shift < 8 && ((long)C << (tx_shift + 1)) <= kStageTile) {
      ++tx_shift;
    }
    const int cc = C < (kStageTile >> tx_shift) ? C : (kStageTile >> tx_shift);
    const dim3 grid((unsigned)((Wp + (1 << tx_shift) - 1) >> tx_shift), gy);
    if (in_bf16) {
      pad_stage_nchw_kernel<__nv_bfloat16><<<grid, kStageThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(in), C, H, W, pad, (int)rows,
          tx_shift, cc, Co, o);
    } else {
      pad_stage_nchw_kernel<float><<<grid, kStageThreads, 0, stream>>>(
          static_cast<const float*>(in), C, H, W, pad, (int)rows, tx_shift,
          cc, Co, o);
    }
  }
  return (int)cudaGetLastError();
}

// K5.  x f32 [B, C, H, W]; flow f32 [B, 2, H, W] (u, v planes); vmax the
// vertical clamp in rows; W % 128 == 0 and H * W < 2^31 (plane offsets
// are 32-bit).  Out: f32 [B, C, H, W].
int aivc_warp_vclamped(const float* x, const float* flow, int B, int C,
                       int H, int W, int vmax, float* out,
                       cudaStream_t stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  const long gy = (H + kVcTy - 1) / kVcTy;
  if (W % (kVcTx * kVcPx) != 0 || (long)H * W > 0x7FFFFFFFL || B > 65535 ||
      gy > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kVcTx, kVcTy);
  const dim3 grid((unsigned)(W / (kVcTx * kVcPx)), (unsigned)gy,
                  (unsigned)B);
  if (C == 3) {
    warp_vclamped_kernel<3><<<grid, block, 0, stream>>>(x, flow, C, H, W,
                                                        (float)vmax, out);
  } else {
    warp_vclamped_kernel<0><<<grid, block, 0, stream>>>(x, flow, C, H, W,
                                                        (float)vmax, out);
  }
  return (int)cudaGetLastError();
}

// K7.  a bf16 [P, K] (channels-last pixels), w bf16 [N, K], bias bf16
// [N]; epi 0 relu, 1 residual (b_in bf16 [K], res bf16 [P, N]), 2 gate
// (res, trunk bf16 [P, N]).  K and N multiples of 16 from 16 to 320,
// every pointer 16-byte aligned.  Out: bf16 [P, N].
int aivc_conv1x1(const void* a, const void* w, const void* bias,
                 const void* b_in, const void* res, const void* trunk, int P,
                 int K, int N, int epi, void* out, cudaStream_t stream) {
  if (P < 0 || K < 16 || K > kC1KMax || K % 16 != 0 || N < 16 ||
      N > kC1NMax || N % 16 != 0 || epi < 0 || epi > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const void* need[6] = {a, w, bias, epi == 1 ? b_in : a,
                         epi == 0 ? a : res, epi == 2 ? trunk : a};
  for (const void* ptr : need) {
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (P == 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (epi == 0) {
    err = conv1x1_launch<kC1Relu>(a, w, bias, b_in, res, trunk, P, K, N, out,
                                  stream);
  } else if (epi == 1) {
    err = conv1x1_launch<kC1Residual>(a, w, bias, b_in, res, trunk, P, K, N,
                                      out, stream);
  } else {
    err = conv1x1_launch<kC1Gate>(a, w, bias, b_in, res, trunk, P, K, N,
                                  out, stream);
  }
  return (int)err;
}

}  // extern "C"
