// The window core that K5, K7 (histogram.cu) and K2 (counts_matrix.cu)
// share: 16 window starts counted from 2-bit digits and validity bits
// (count16), u8 bases turned into both (digits4, valid4, count_u8), and the
// aligned 16-byte chunks of a u8 stream with their halo (stream_chunk,
// u8_chunk_pair).
//
// Included by the sources that use it; ops/kernels.library_path hashes it
// with them.

#pragma once

#include <cstdint>

#include "planes.cuh"

namespace {

// Count the windows of one run of 16 window starts. d holds positions
// 0..31 of the run (position 0 is base `first` of the input), 2 bits each,
// position i at bits 2i; v has bit i set where position i is valid. add(key)
// takes each window that starts at a position in [0, 16), at a base in
// [0, limit), whose k bases are valid and whose key is below bins; k <= 15,
// so a window ends by position 29. The codes come from shifts of d, with no
// step depending on the one before: the digits reversed once, a window's
// big-endian code is a funnel shift of them, its reverse complement one of
// the complemented d.
template <bool kCanonical, typename Add>
__device__ __forceinline__ void count16(uint64_t d, uint32_t v, int64_t first, int64_t limit,
                                        int k, uint32_t bins, Add& add) {
  const int64_t room = limit - first;  // starts [lo, hi) lie in [0, limit)
  const int hi = room < 16 ? (room > 0 ? static_cast<int>(room) : 0) : 16;
  const int lo = first < 0 ? static_cast<int>(-first) : 0;
  uint32_t wv = v;  // bit j: positions j .. j + k - 1 valid
  for (int t = 1; t < k; ++t) wv &= v >> t;
  wv &= ((1u << hi) - 1) & ~((1u << lo) - 1);
  if (!wv) return;
  const uint32_t dlo = static_cast<uint32_t>(d), dhi = static_cast<uint32_t>(d >> 32);
  const uint32_t rhi = digit_rev32(dlo), rlo = digit_rev32(dhi);  // position 0 at bits 31-30
  const int sh = 32 - 2 * k;
  const uint32_t mask = (1u << (2 * k)) - 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t key = __funnelshift_l(rlo, rhi, 2 * j) >> sh;
    if (kCanonical) key = min(key, ~__funnelshift_r(dlo, dhi, 2 * j) & mask);
    if ((wv >> j) & 1u && key < bins) add(key);
  }
}

// 4 u8 bases (one per byte of w) as 4 2-bit digits, byte i at bits 2i
// (the low 2 bits of each byte), and their validity bits (a byte < 4).
__device__ __forceinline__ uint32_t digits4(uint32_t w) {
  return ((w & 0x03030303u) * 0x01041040u) >> 24;
}
__device__ __forceinline__ uint32_t valid4(uint32_t w) {
  return ((__vcmpeq4(w & 0xFCFCFCFCu, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Count the 16 window starts of a u8 chunk: bytes w[0..3] and, for the
// halo, w[4..7].
template <bool kCanonical, typename Add>
__device__ __forceinline__ void count_u8(const uint32_t (&w)[8], int64_t first, int64_t limit,
                                         int k, uint32_t bins, Add& add) {
  uint64_t d = 0;
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d |= static_cast<uint64_t>(digits4(w[i])) << (8 * i);
    v |= valid4(w[i]) << (4 * i);
  }
  count16<kCanonical>(d, v, first, limit, k, bins, add);
}

// The 16 bytes of chunk c of the stream in aligned coordinates: aligned
// byte a is base a - mis, and bytes outside [mis, end) read as invalid
// (0xFF), so no load reaches outside the stream.
__device__ __forceinline__ uint4 stream_chunk(const uint8_t* __restrict__ abase,
                                              int64_t c, int64_t mis, int64_t end) {
  const int64_t lo = 16 * c;
  if (lo >= mis && lo + 16 <= end) {
    return __ldg(reinterpret_cast<const uint4*>(abase + lo));
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t a = lo + 4 * j + b;
      const uint32_t v = (a >= mis && a < end) ? __ldg(abase + a) : 0xFFu;
      word |= v << (8 * b);
    }
    w[j] = word;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 32 bytes a lane rolls over: its chunk c of the stream and, for the
// halo, chunk c + 1, taken from the next lane's load. All 32 lanes of the
// warp call it together.
__device__ __forceinline__ void u8_chunk_pair(const uint8_t* __restrict__ abase, int64_t c,
                                              int64_t mis, int64_t end, uint32_t (&w)[8]) {
  const uint4 cur = stream_chunk(abase, c, mis, end);
  uint4 nxt;
  nxt.x = __shfl_down_sync(0xFFFFFFFFu, cur.x, 1);
  nxt.y = __shfl_down_sync(0xFFFFFFFFu, cur.y, 1);
  nxt.z = __shfl_down_sync(0xFFFFFFFFu, cur.z, 1);
  nxt.w = __shfl_down_sync(0xFFFFFFFFu, cur.w, 1);
  if ((threadIdx.x & 31) == 31) nxt = stream_chunk(abase, c + 1, mis, end);
  w[0] = cur.x; w[1] = cur.y; w[2] = cur.z; w[3] = cur.w;
  w[4] = nxt.x; w[5] = nxt.y; w[6] = nxt.z; w[7] = nxt.w;
}

}  // namespace
