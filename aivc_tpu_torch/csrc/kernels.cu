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
//                 (through gdn_pallas).
// K5 warp_vclamped replaces aivc_tpu/ops/warp_pallas.py:_warp_plane_kernel
//                 (through warp_pallas).
//
// Each kernel is bit-identical to its plain PyTorch version beside its
// wrapper (coding/vrans.py, ops/warp.py, ops/gdn.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kProbScale = 1u << 16;   // PROB_BITS = 16
constexpr uint32_t kRansL = 1u << 16;       // state lower bound, 16-bit words

// ---------------------------------------------------------------------------
// Shared helpers of K1 and K2
// ---------------------------------------------------------------------------

// Block-wide exclusive prefix sum of one int per thread, in thread order.
// Writes the block total to *total.  `warp_sums` holds >= 32 ints of
// shared memory.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int base = wid > 0 ? warp_sums[wid - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is rewritten by the next call
  return base + x - v;
}

// Copies the CDF table [n_rows, n_sym] (u16, cdf[:, :n_sym]; the last edge
// is PROB_SCALE implicitly) into dynamic shared memory.
__device__ __forceinline__ void load_table(uint16_t* dst, const uint16_t* src,
                                           int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// ---------------------------------------------------------------------------
// K1: batched interleaved K-stream rANS encode.
//
// What bounds it on the H100: the serial chain of S = n_pad / K dependent
// steps per chunk (each step needs the previous state), not bytes or
// operations: ~1.9M symbols per 1080p P/B frame move ~15 MB, which the
// card reads in microseconds.  Design: one block per chunk walks the
// steps in reverse; each thread owns L = K / blockDim adjacent lanes so
// K = 2048 fits a 1024-thread block; the CDF table sits in shared memory
// (one load per block); the division is exact integer u32 `/` and `%`
// (the TPU's f32 long division was a workaround); the emitted words go to
// a descending cursor in decode order (step ascending, lane ascending) via
// one block-wide exclusive scan of the emit flags per step, so no second
// compaction pass exists.  The cursor is snapshotted at each segment's
// first step for the fused frame format.
// ---------------------------------------------------------------------------
template <int L>
__global__ void rans_encode_kernel(const int* __restrict__ sym,
                                   const int* __restrict__ rows,
                                   const uint16_t* __restrict__ cdf_g,
                                   int n_rows, int n_sym, int n_pad, int K,
                                   int4 seg_start, int n_seg,
                                   uint16_t* __restrict__ buf,
                                   uint32_t* __restrict__ states,
                                   int* __restrict__ seg_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* warp_sums = reinterpret_cast<int*>(smem);
  uint16_t* cdf = reinterpret_cast<uint16_t*>(smem + 32 * sizeof(int));
  load_table(cdf, cdf_g, n_rows * n_sym);

  const int b = blockIdx.x;
  const int* sb = sym + (size_t)b * n_pad;
  const int* rb = rows + (size_t)b * n_pad;
  uint16_t* out = buf + (size_t)b * n_pad;
  const int steps = n_pad / K;
  const int lane0 = threadIdx.x * L;
  const bool active = lane0 < K;
  const int seg_t[4] = {seg_start.x, seg_start.y, seg_start.z, seg_start.w};

  uint32_t x[L];
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = kRansL;
  int g = n_pad;

  for (int t = steps - 1; t >= 0; --t) {
    uint16_t word[L];
    bool emit[L];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      emit[j] = false;
      word[j] = 0;
      if (active) {
        const int idx = t * K + lane0 + j;
        // Symbols and rows outside the table are a caller bug; clamping
        // keeps the kernel inside shared memory.
        const int s = clamp_index(sb[idx], n_sym);
        const uint16_t* row = cdf + clamp_index(rb[idx], n_rows) * n_sym;
        const uint32_t start = row[s];
        const uint32_t next = s + 1 < n_sym ? row[s + 1] : kProbScale;
        const uint32_t freq = next - start;
        uint32_t xs = x[j];
        emit[j] = xs >= (freq << 16);
        word[j] = (uint16_t)(xs & 0xFFFFu);
        if (emit[j]) xs >>= 16;
        const uint32_t q = xs / freq;
        x[j] = (q << 16) + (xs - q * freq) + start;
        cnt += emit[j] ? 1 : 0;
      }
    }
    int total;
    int rank = block_exclusive_scan(cnt, warp_sums, &total);
    g -= total;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (emit[j]) out[g + rank++] = word[j];
    }
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_seg; ++i) {
        if (t == seg_t[i]) seg_g[b * n_seg + i] = g;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < L; ++j) states[(size_t)b * K + lane0 + j] = x[j];
  }
}

// ---------------------------------------------------------------------------
// K2: batched K-stream rANS decode with a resumable (states, g) carry.
//
// Bound, as K1: the serial step chain.  Design: one block per chunk, the
// same lane ownership and shared-memory table as K1; slot -> symbol by a
// binary search of the row in shared memory (the TPU's one-hot MXU
// lookups were a workaround); renormalisation words are fed by a
// block-wide exclusive prefix count of the lanes that need one.  Words
// past w_cap read as 0, like the zero-padded buffer of the JAX decoder.
// ---------------------------------------------------------------------------
template <int L>
__global__ void rans_decode_kernel(const uint16_t* __restrict__ words,
                                   int w_cap,
                                   const uint32_t* __restrict__ states_in,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ g0,
                                   const uint16_t* __restrict__ cdf_g,
                                   int n_rows, int n_sym, int n_pad, int K,
                                   int* __restrict__ syms,
                                   uint32_t* __restrict__ states_out,
                                   int* __restrict__ g_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* warp_sums = reinterpret_cast<int*>(smem);
  uint16_t* cdf = reinterpret_cast<uint16_t*>(smem + 32 * sizeof(int));
  load_table(cdf, cdf_g, n_rows * n_sym);

  const int b = blockIdx.x;
  const uint16_t* wb = words + (size_t)b * w_cap;
  const int* rb = rows + (size_t)b * n_pad;
  int* ob = syms + (size_t)b * n_pad;
  const int steps = n_pad / K;
  const int lane0 = threadIdx.x * L;
  const bool active = lane0 < K;

  uint32_t x[L];
#pragma unroll
  for (int j = 0; j < L; ++j)
    x[j] = active ? states_in[(size_t)b * K + lane0 + j] : 0u;
  int g = g0[b];

  for (int t = 0; t < steps; ++t) {
    bool need[L];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      need[j] = false;
      if (active) {
        const int idx = t * K + lane0 + j;
        const uint16_t* row = cdf + clamp_index(rb[idx], n_rows) * n_sym;
        const uint32_t slot = x[j] & (kProbScale - 1);
        int lo = 0, hi = n_sym - 1;      // row[0] == 0 <= slot
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (row[mid] <= slot) lo = mid; else hi = mid - 1;
        }
        const uint32_t start = row[lo];
        const uint32_t next = lo + 1 < n_sym ? row[lo + 1] : kProbScale;
        const uint32_t xs = (next - start) * (x[j] >> 16) + slot - start;
        need[j] = xs < kRansL;
        x[j] = xs;
        ob[idx] = lo;
        cnt += need[j] ? 1 : 0;
      }
    }
    int total;
    int rank = block_exclusive_scan(cnt, warp_sums, &total);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (need[j]) {
        const int p = g + rank++;
        const uint32_t w = (p >= 0 && p < w_cap) ? wb[p] : 0u;
        x[j] = (x[j] << 16) | w;
      }
    }
    g += total;
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < L; ++j) states_out[(size_t)b * K + lane0 + j] = x[j];
  }
  if (threadIdx.x == 0) g_out[b] = g;
}

// ---------------------------------------------------------------------------
// K3: bilinear backward warp of a byte-packed YUV frame, border clamp.
//
// What bounds it on the H100: bytes.  Per output pixel it reads the
// packed source (4 B, the four corners mostly from L1/L2: |flow| <= fb
// keeps them within fb rows), two flow planes (8 B) and writes three f32
// planes (12 B): ~24 B/pixel, ~50 MB per 1088x1920 frame, ~15 us at the
// card's 3.35 TB/s.  Design: one thread per output pixel, coalesced on
// the flow reads and the three plane writes; the TPU's windowed
// select-accumulate was a workaround for its missing 2-D gather.  The
// arithmetic keeps warp_packed's operation order with explicit
// round-to-nearest intrinsics (no FMA contraction), so it is
// bit-identical to the plain PyTorch version run op by op on the card.
// ---------------------------------------------------------------------------
__global__ void warp_packed_kernel(const int* __restrict__ packed,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v, int B,
                                   int H, int W,
                                   float* __restrict__ out) {
  const size_t hw = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * hw) return;
  const size_t b = i / hw;
  const int p = (int)(i - b * hw);
  const int y = p / W;
  const int x = p - y * W;
  const float inv255 = __int_as_float(0x3b808081);  // float32(1 / 255)

  const float sx = fminf(fmaxf(__fadd_rn((float)x, u[i]), 0.0f),
                         (float)(W - 1));
  const float sy = fminf(fmaxf(__fadd_rn((float)y, v[i]), 0.0f),
                         (float)(H - 1));
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float wx = __fsub_rn(sx, x0f);
  const float wy = __fsub_rn(sy, y0f);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const int* src = packed + b * hw;
  const uint32_t c00 = (uint32_t)src[y0 * W + x0];
  const uint32_t c01 = (uint32_t)src[y0 * W + x1];
  const uint32_t c10 = (uint32_t)src[y1 * W + x0];
  const uint32_t c11 = (uint32_t)src[y1 * W + x1];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int sh = 8 * ch;
    const float v00 = __fmul_rn((float)((c00 >> sh) & 0xFFu), inv255);
    const float v01 = __fmul_rn((float)((c01 >> sh) & 0xFFu), inv255);
    const float v10 = __fmul_rn((float)((c10 >> sh) & 0xFFu), inv255);
    const float v11 = __fmul_rn((float)((c11 >> sh) & 0xFFu), inv255);
    const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), wx));
    const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), wx));
    out[(b * 3 + ch) * hw + p] =
        __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), wy));
  }
}

// ---------------------------------------------------------------------------
// K4: fused (I)GDN, NCHW.
//
// out[b, o, p] = x / n (x * n for the inverse), n = to_xtype(sqrt(
// sum_j x2[b, j, p] * gammaT[j, o] + beta[o])), x2 = to_xtype(x * x), the
// sum in f32 over j in order, each product and sum rounded (no FMA), so it
// is bit-identical to ops/gdn.py:gdn_fused_plain run op by op.
//
// What bounds it on the H100: operations.  2 * C flops per output element
// (C = 128: 256 per element) against 4 bytes moved per bf16 element, far
// above the card's ~20 flop/byte f32 balance; without FMA and tensor cores
// a simple kernel sits at or above the f32 operation bound.  Design: one
// block per SM slot (persistent) walks tiles of 64 pixels of one image for
// 128 output channels; per tile it takes the input channels in chunks of
// 128, staging gammaT[chunk, 128] (64 KB f32, loaded once per block when
// C == 128) and the squared inputs x2[chunk, 64] (32 KB) in dynamic
// shared memory.  256 threads: 64 pixels (consecutive threads, so x loads
// and out stores coalesce) x 4 groups of 32 output channels; a warp shares
// its output channels, so gamma reads are shared-memory broadcasts and
// each thread keeps 32 sums in registers.
// ---------------------------------------------------------------------------
constexpr int kGdnPix = 64;
constexpr int kGdnOut = 128;
constexpr int kGdnChunk = 128;
constexpr int kGdnGroups = 4;   // output-channel groups of 32 per block
constexpr int kGdnPerThread = kGdnOut / kGdnGroups;
constexpr size_t kGdnSmem =
    (size_t)(kGdnChunk * kGdnOut + kGdnChunk * kGdnPix) * sizeof(float);

template <bool kBf16>
__device__ __forceinline__ float gdn_load(const void* p, size_t i) {
  if (kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  return static_cast<const float*>(p)[i];
}

// Rounds v to the activation type and back (identity for f32).
template <bool kBf16>
__device__ __forceinline__ float gdn_round(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool kBf16>
__device__ __forceinline__ void gdn_store(void* p, size_t i, float v) {
  if (kBf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kGdnPix * kGdnGroups)
    gdn_fused_kernel(const void* __restrict__ x,
                     const float* __restrict__ gamma_t,
                     const float* __restrict__ beta, int C, int HW,
                     int inverse, void* __restrict__ out) {
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
          const float xv = gdn_load<kBf16>(
              x, img + (size_t)(j0 + jj) * HW + p0 + pp);
          v = gdn_round<kBf16>(__fmul_rn(xv, xv));
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
        const float n =
            gdn_round<kBf16>(__fsqrt_rn(__fadd_rn(acc[k], beta[o])));
        const size_t i = img + (size_t)o * HW + p;
        const float xv = gdn_load<kBf16>(x, i);
        gdn_store<kBf16>(out, i,
                         inverse ? __fmul_rn(xv, n) : __fdiv_rn(xv, n));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5: bilinear warp of float planes with the vertical flow clamped.
//
// out[b, c, y, x] = (1 - wy) * top + wy * bot, top / bot = h0 + (h1 - h0)
// * wx on rows y0 and min(y0 + 1, H - 1), where sx = clip(x + u, 0, W - 1)
// and sy = clip(y + clip(v, -vmax, vmax), 0, H - 1): the value that
// warp_pallas's select-accumulate over row offsets leaves, since it adds
// only exact zeros besides these two terms.  Explicit round-to-nearest
// intrinsics keep the plain version's operation order (no FMA), so it is
// bit-identical to ops/warp.py:warp_vclamped run op by op.
//
// What bounds it on the H100: bytes.  Per pixel it reads 8 B of flow and
// C x 4 corner samples, writes C x 4 B, and does ~10 float ops per
// channel.  Design: one thread per output pixel that loops over the
// channels; the flow and coordinate math is done once per pixel, and
// neighbouring threads read neighbouring flow values and (for small
// flows) neighbouring source pixels, so loads coalesce.  The TPU kernel's
// vertical window and lane-tile gathers were workarounds for Mosaic's
// gather and have no counterpart here: a gather is one load.
// ---------------------------------------------------------------------------
__global__ void warp_vclamped_kernel(const float* __restrict__ x,
                                     const float* __restrict__ flow, int B,
                                     int C, int H, int W, float vmax,
                                     float* __restrict__ out) {
  const size_t hw = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * hw) return;
  const size_t b = i / hw;
  const int p = (int)(i - b * hw);
  const int y = p / W;
  const int xq = p - y * W;
  const float u = flow[(b * 2) * hw + p];
  const float v = fminf(fmaxf(flow[(b * 2 + 1) * hw + p], -vmax), vmax);
  const float sx = fminf(fmaxf(__fadd_rn((float)xq, u), 0.0f),
                         (float)(W - 1));
  const float sy = fminf(fmaxf(__fadd_rn((float)y, v), 0.0f),
                         (float)(H - 1));
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float wx = __fsub_rn(sx, x0f);
  const float wy = __fsub_rn(sy, y0f);
  const float omwy = __fsub_rn(1.0f, wy);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  for (int c = 0; c < C; ++c) {
    const float* src = x + (b * C + c) * hw;
    const float t0 = src[(size_t)y0 * W + x0];
    const float t1 = src[(size_t)y0 * W + x1];
    const float b0 = src[(size_t)y1 * W + x0];
    const float b1 = src[(size_t)y1 * W + x1];
    const float top = __fadd_rn(t0, __fmul_rn(__fsub_rn(t1, t0), wx));
    const float bot = __fadd_rn(b0, __fmul_rn(__fsub_rn(b1, b0), wx));
    out[(b * C + c) * hw + p] =
        __fadd_rn(__fmul_rn(omwy, top), __fmul_rn(wy, bot));
  }
}

int rans_threads(int K) {
  int t = K < 1024 ? K : 1024;
  return t < 32 ? 32 : t;
}

size_t rans_smem(int n_rows, int n_sym) {
  return 32 * sizeof(int) + (size_t)n_rows * n_sym * sizeof(uint16_t);
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

}  // namespace

extern "C" {

// Shared-memory bytes K1/K2 need for a table of n_rows x n_sym.
size_t aivc_rans_smem_bytes(int n_rows, int n_sym) {
  return rans_smem(n_rows, n_sym);
}

// K1.  sym, rows: i32 [B, n_pad]; cdf: u16 [n_rows, n_sym]; seg_start:
// the first step of each of n_seg <= 4 segments.  Out: buf u16 [B, n_pad]
// (chunk b's words are buf[b, seg_g[b, 0]:n_pad]), states u32 [B, K],
// seg_g i32 [B, n_seg].
int aivc_rans_encode(const int* sym, const int* rows, const uint16_t* cdf,
                     int n_rows, int n_sym, int B, int n_pad, int K,
                     int s0, int s1, int s2, int s3, int n_seg,
                     uint16_t* buf, uint32_t* states, int* seg_g,
                     cudaStream_t stream) {
  const int threads = rans_threads(K);
  const int L = K > 1024 ? K / 1024 : 1;
  const size_t smem = rans_smem(n_rows, n_sym);
  const int4 seg = make_int4(s0, s1, s2, s3);
  cudaError_t err;
  if (L == 1) {
    err = set_smem(rans_encode_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    rans_encode_kernel<1><<<B, threads, smem, stream>>>(
        sym, rows, cdf, n_rows, n_sym, n_pad, K, seg, n_seg, buf, states,
        seg_g);
  } else if (L == 2) {
    err = set_smem(rans_encode_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    rans_encode_kernel<2><<<B, threads, smem, stream>>>(
        sym, rows, cdf, n_rows, n_sym, n_pad, K, seg, n_seg, buf, states,
        seg_g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2.  words u16 [B, w_cap]; states_in u32 [B, K]; rows i32 [B, n_pad];
// g0 i32 [B].  Out: syms i32 [B, n_pad], states_out u32 [B, K], g_out [B].
int aivc_rans_decode(const uint16_t* words, int w_cap,
                     const uint32_t* states_in, const int* rows,
                     const int* g0, const uint16_t* cdf, int n_rows,
                     int n_sym, int B, int n_pad, int K, int* syms,
                     uint32_t* states_out, int* g_out, cudaStream_t stream) {
  const int threads = rans_threads(K);
  const int L = K > 1024 ? K / 1024 : 1;
  const size_t smem = rans_smem(n_rows, n_sym);
  cudaError_t err;
  if (L == 1) {
    err = set_smem(rans_decode_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    rans_decode_kernel<1><<<B, threads, smem, stream>>>(
        words, w_cap, states_in, rows, g0, cdf, n_rows, n_sym, n_pad, K,
        syms, states_out, g_out);
  } else if (L == 2) {
    err = set_smem(rans_decode_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    rans_decode_kernel<2><<<B, threads, smem, stream>>>(
        words, w_cap, states_in, rows, g0, cdf, n_rows, n_sym, n_pad, K,
        syms, states_out, g_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K3.  packed i32 [B, H, W] (pack_yuv_u32); u, v f32 [B, H, W] flow
// planes.  Out: f32 [B, 3, H, W].
int aivc_warp_packed(const int* packed, const float* u, const float* v,
                     int B, int H, int W, float* out, cudaStream_t stream) {
  const size_t total = (size_t)B * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    warp_packed_kernel<<<blocks, threads, 0, stream>>>(packed, u, v, B, H,
                                                       W, out);
  }
  return (int)cudaGetLastError();
}

// K4.  x [B, C, HW] f32 (bf16 = 0) or bf16 (bf16 = 1); gamma_t f32 [C, C]
// (gamma transposed: [j, o]); beta f32 [C]; C % 128 == 0.  Out like x.
int aivc_gdn_fused(const void* x, int bf16, const float* gamma_t,
                   const float* beta, int B, int C, int HW, int inverse,
                   void* out, cudaStream_t stream) {
  if (C % kGdnOut != 0 || C % kGdnChunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (HW + kGdnPix - 1) / kGdnPix;
  const int threads = kGdnPix * kGdnGroups;
  if (n_tiles == 0 || B == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    err = set_smem(gdn_fused_kernel<true>, kGdnSmem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gdn_fused_kernel<true>, threads, kGdnSmem);
    }
  } else {
    err = set_smem(gdn_fused_kernel<false>, kGdnSmem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gdn_fused_kernel<false>, threads, kGdnSmem);
    }
  }
  if (err != cudaSuccess) return (int)err;
  // Enough blocks to fill every SM once over all images and channel tiles.
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long per_image = (slots + (long)B * (C / kGdnOut) - 1) /
                         ((long)B * (C / kGdnOut));
  const dim3 grid((unsigned)(per_image < n_tiles ? per_image : n_tiles),
                  (unsigned)(C / kGdnOut), (unsigned)B);
  if (bf16) {
    gdn_fused_kernel<true><<<grid, threads, kGdnSmem, stream>>>(
        x, gamma_t, beta, C, HW, inverse, out);
  } else {
    gdn_fused_kernel<false><<<grid, threads, kGdnSmem, stream>>>(
        x, gamma_t, beta, C, HW, inverse, out);
  }
  return (int)cudaGetLastError();
}

// K5.  x f32 [B, C, H, W]; flow f32 [B, 2, H, W] (u, v planes); vmax the
// vertical clamp in rows.  Out: f32 [B, C, H, W].
int aivc_warp_vclamped(const float* x, const float* flow, int B, int C,
                       int H, int W, int vmax, float* out,
                       cudaStream_t stream) {
  const size_t total = (size_t)B * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    warp_vclamped_kernel<<<blocks, threads, 0, stream>>>(
        x, flow, B, C, H, W, (float)vmax, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
