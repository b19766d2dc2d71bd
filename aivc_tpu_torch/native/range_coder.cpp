// Host rANS range coder of aivc_tpu_torch, a copy of
// aivc_tpu/native/range_coder.cpp (the same bytes for the same inputs),
// which replaces the reference's torchac C++ dependency (reference:
// src/real_life/bitstream.py:10,281,454).  Built by g++ at first use
// (coding/range_coder.py).
//
// Byte-wise rANS with 16-bit quantized probabilities:
//   state x: uint32, renormalisation interval [2^23, 2^31), byte output.
// CDFs are integer-quantized on the Python side (deterministically) to
// uint32 rows of length Lp with cdf[0] == 0 and cdf[Lp-1] == 1 << 16 and
// strictly increasing, so every symbol has a non-zero frequency.  Each
// element selects its CDF row through row_idx (per-channel rows for the
// hyper-latent z, per-scale-bin rows for the Laplace-coded y), which keeps
// host transfers to one small table + one int index per element instead of
// the reference's [B,C,H,W,514] float CDF tensor.
//
// rANS encodes in reverse element order so the decoder emits symbols in
// forward order; all CDFs within a chunk are known up front at both ends,
// which the codec guarantees (z is decoded before y, sigma before y's CDF).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t PROB_BITS = 16;
constexpr uint32_t PROB_SCALE = 1u << PROB_BITS;
constexpr uint32_t RANS_L = 1u << 23;  // lower bound of the renorm interval

}  // namespace

extern "C" {

// Encode n symbols. Returns the number of bytes written, or -1 on overflow
// of out_capacity, -2 on invalid symbol/frequency.
//
//   symbols:  [n]   each in [0, Lp-2]
//   cdf:      [n_rows * Lp] quantized CDF rows
//   row_idx:  [n]   CDF row per element
long rans_encode(const uint16_t* symbols, long n,
                 const uint32_t* cdf, long Lp,
                 const int32_t* row_idx,
                 uint8_t* out, long out_capacity) {
  // rANS emits bytes backwards; write into the tail of a scratch region
  // inside `out` and memmove to the front at the end.
  uint8_t* end = out + out_capacity;
  uint8_t* ptr = end;
  uint32_t x = RANS_L;

  for (long i = n - 1; i >= 0; --i) {
    const uint32_t s = symbols[i];
    const uint32_t* row = cdf + static_cast<long>(row_idx[i]) * Lp;
    if (s + 1 >= static_cast<uint32_t>(Lp)) return -2;
    const uint32_t start = row[s];
    const uint32_t freq = row[s + 1] - start;
    if (freq == 0) return -2;

    // Renormalise: x < freq * 2^(31-16) * 2^8 after the encode step.
    const uint32_t x_max = ((RANS_L >> PROB_BITS) << 8) * freq;
    while (x >= x_max) {
      if (ptr == out) return -1;
      *--ptr = static_cast<uint8_t>(x & 0xff);
      x >>= 8;
    }
    x = ((x / freq) << PROB_BITS) + (x % freq) + start;
  }

  // Flush the 4-byte final state (little-endian).
  for (int k = 0; k < 4; ++k) {
    if (ptr == out) return -1;
    *--ptr = static_cast<uint8_t>(x & 0xff);
    x >>= 8;
  }

  const long nbytes = static_cast<long>(end - ptr);
  std::memmove(out, ptr, static_cast<size_t>(nbytes));
  return nbytes;
}

// Decode n symbols from bytes. Returns 0, or -1 if the stream ran dry,
// -2 on malformed CDF.
long rans_decode(const uint8_t* bytes, long nbytes,
                 const uint32_t* cdf, long Lp,
                 const int32_t* row_idx,
                 long n, uint16_t* out_symbols) {
  if (nbytes < 4) return -1;
  const uint8_t* ptr = bytes;
  const uint8_t* end = bytes + nbytes;

  // The encoder flush writes the state LSB-first to decreasing addresses,
  // so the stream starts with the state in big-endian order.
  uint32_t x = (static_cast<uint32_t>(ptr[0]) << 24) |
               (static_cast<uint32_t>(ptr[1]) << 16) |
               (static_cast<uint32_t>(ptr[2]) << 8) |
               static_cast<uint32_t>(ptr[3]);
  ptr += 4;

  for (long i = 0; i < n; ++i) {
    const uint32_t* row = cdf + static_cast<long>(row_idx[i]) * Lp;
    const uint32_t dv = x & (PROB_SCALE - 1);

    // Binary search: largest s with row[s] <= dv.
    long lo = 0, hi = Lp - 1;
    while (hi - lo > 1) {
      const long mid = (lo + hi) >> 1;
      if (row[mid] <= dv) lo = mid; else hi = mid;
    }
    const uint32_t s = static_cast<uint32_t>(lo);
    const uint32_t start = row[s];
    const uint32_t freq = row[s + 1] - start;
    if (freq == 0) return -2;
    out_symbols[i] = static_cast<uint16_t>(s);

    x = freq * (x >> PROB_BITS) + dv - start;
    while (x < RANS_L) {
      if (ptr == end) {
        // The final renorms may legitimately exhaust the stream only if
        // we are at the very last symbols; feed zero bytes.
        x <<= 8;
      } else {
        x = (x << 8) | *ptr++;
      }
    }
  }
  return 0;
}

}  // extern "C"
