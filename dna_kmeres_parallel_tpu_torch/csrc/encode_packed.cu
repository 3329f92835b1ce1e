// Packed-plane window encoder (K1) and its minimizer plane (K1m) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/encode_pallas.py::rolling_codes_split_packed_pallas
//   (body _make_packed_encode_kernel), as called with words_le=True,
// with its minimizer plane and without its benchmark hooks.
//
// Input: two u32 planes of n_words words, 16 bases per word.
//   words_le  2-bit base codes, base j of a word at bits 2j (a zero-copy
//             view of the 2-bit packed bytes);
//   inval_be  2-bit digits, base j of a word at bits 30-2j, 11 where the
//             base is invalid (N or a sequence sentinel).
// Output, for every window start p in [0, 16 * n_words), in stream order:
//   lo  int32: the last min(k, 16) bases of the window's 2k-bit code;
//   hi  int16 (16 <= k <= 23) or int32 (k >= 24): the first k - 16 bases;
//       no hi plane for k <= 15.
// A window is valid iff p < n_own, p + k <= 16 * n_words and none of its
// k bases is invalid; an invalid window holds all-ones in every plane.
// With canonical set, the code is the smaller of the window and its
// reverse complement (the lexicographic min of (hi, lo), since the split
// preserves order).
// With a minimizer length m (1 <= m < min(k, 16)), a third plane holds
// each window's minimizer (the Pallas body's `minimizer_m` plane,
// encode_pallas.py:490-549): the smallest FORWARD m-mer code among the
// window's L = k-m+1 m-mers, forward even when canonical is set, since it
// decides the window's owner in the bucketed exchange. INT32_MAX at an
// invalid window (the TPU plane holds garbage there).
//
// Bound: the stores. A window costs 0.5 B of planes read and 4 B of output
// for k <= 15, 6 B for 16-23 and 8 B for k >= 24, 4 B more with the
// minimizer plane, so the kernel is a streaming write at device-memory
// bandwidth. The first port (one thread a window) stayed 3x above that
// bound: each window re-read and re-reversed the three words it spans, the
// minimizer walked its L m-mers one by one (25 steps of a 64-bit shift,
// mask and min at k=31, m=7, about 100 instructions a window), and the
// int16 plane left in 64-byte warp stores.
//
// Design: a thread owns the 16 window starts of one plane word w. It reads
// words w, w+1 and w+2 of both planes once (neighbouring threads read
// neighbouring words; 16 windows of k <= 31 bases end by base 45 of the
// three), reverses each data word's digits once into a 96-bit big-endian
// stream X, and from there nothing depends on the window before:
//   Codes. One runtime shift Z = X >> (66 - 2k) puts window j's code at
//     bits 30-2j of Z, so its lo and hi words are two funnel shifts by
//     constants; its reverse complement is the complemented little-endian
//     words funnel-shifted by 2j (the Pallas body's funnel family, one
//     thread's worth).
//   Validity. The 48 bases' validity bits (valid16 of each inval word,
//     zero past the plane) go through a doubling ladder of runs: after
//     r &= r >> len for len = 1, 2, 4, ... while 2*len <= k, bit i says
//     bases [i, i+len) are valid, and r & (r >> (k - len)) covers [i, i+k).
//   Minimizers. The m-mer code at each of the 46 positions the thread's
//     windows reach is computed once (a funnel shift of one of three
//     pre-shifted word pairs and a mask). A sparse-table ladder then takes
//     the window minimum: level d sets M[i] = min(M[i], M[i+d]) for d = 1,
//     2, 4, 8 while 2d <= L, so M[i] is the min over [i, i+s) with s the
//     largest power of two <= L, and one combine min(M[j], M[j+L-s])
//     covers window j's [j, j+L). That is at most 4 levels over the 46
//     positions and 16 mins, for 16 windows, against L steps a window. The
//     combine's offset L-s (< 16) is uniform, so a switch over it keeps
//     every index a constant and M in registers. This is the Pallas body's
//     span-min doubling ladder (there over a tile's 16 residues), with the
//     two halves of its binary decomposition replaced by one overlapping
//     combine.
//   Stores. Each plane leaves through the warp's 2 KB of shared memory: a
//     thread writes its 16 values as 16-byte chunks, then each store
//     instruction of the warp writes 512 contiguous bytes (4 windows of lo
//     or mins, 8 of an int16 hi, a thread). Chunk c of the warp's span sits
//     at slot c ^ ((c >> 3) & 7), so neither the writes nor the reads of a
//     quarter warp share a bank. The stores are streaming (st.global.cs):
//     the kernel never reads its planes back.
// Measured on an H100 80GB HBM3 at 700 W (scripts/encode_variants_probe.py):
// each thread's 16 bytes stored straight from its registers, 64 bytes
// apart in a warp, ran 2.0-2.9x slower than the stage; streaming stores ran
// 11-13% faster than plain ones on a 16 Mbase batch and 0.6-1.3% on a
// 64 Mbase shard; blocks of 128 or 512 threads ran as fast as 256. The
// kernel then moves 2.8-3.0 TB/s, 1.1-1.2x its byte bound.
// The minimizer plane is a template flag: without it the kernel computes
// none of it, and the words are the same instructions either way.

#include <cuda_runtime.h>

#include <cstdint>

#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageChunks = 128;  // 16-byte chunks of one warp's 512 windows of int32
// m-mer positions a thread's windows reach: 16 starts + L - 1, L <= 31.
constexpr int kPos = 46;
constexpr uint32_t kAllOnes = 0xFFFFFFFFu;
constexpr uint32_t kMinSentinel = 0x7FFFFFFFu;  // INT32_MAX, above every m-mer code (< 4^15)

// (x2:x1:x0) >> s for s in [0, 64], as three words (z2 highest).
__device__ __forceinline__ void shr96(uint32_t x2, uint32_t x1, uint32_t x0, int s,
                                      uint32_t& z2, uint32_t& z1, uint32_t& z0) {
  if (s >= 32) {
    x0 = x1;
    x1 = x2;
    x2 = 0;
    s -= 32;
  }
  z0 = __funnelshift_rc(x0, x1, s);
  z1 = __funnelshift_rc(x1, x2, s);
  z2 = __funnelshift_rc(x2, 0u, s);
}

// Bit i set where bits [i, i + k) of v are all set (1 <= k <= 32).
__device__ __forceinline__ uint64_t runs_of(uint64_t v, int k) {
  int len = 1;
  while (2 * len <= k) {
    v &= v >> len;
    len *= 2;
  }
  return v & (v >> (k - len));
}

template <int O>
__device__ __forceinline__ void combine(const uint32_t (&M)[kPos], uint32_t (&r)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) r[j] = min(M[j], M[j + O]);
}

// One ladder level: M[i] = min(M[i], M[i + D]) for i <= kPos - 2D, in
// ascending i, so every M[i + D] read is still the level below.
template <int D>
__device__ __forceinline__ void level(uint32_t (&M)[kPos]) {
#pragma unroll
  for (int i = 0; i + 2 * D <= kPos; ++i) M[i] = min(M[i], M[i + D]);
}

// The minimizers of the thread's 16 windows (forward m-mers of the
// big-endian stream x2:x1:x0, base 0 at the top of x2), L = k - m + 1.
__device__ __forceinline__ void window_minima(uint32_t x2, uint32_t x1, uint32_t x0, int m,
                                              int L, uint32_t (&r)[16]) {
  // Position 16g + q: pair (x_g : x_g+1) >> (34 - 2m) puts its m-mer at
  // bits 30-2q; base 45 is the last any window reaches, so pair 2's low
  // word is zero.
  const uint32_t pair[4] = {x2, x1, x0, 0u};
  const int sh = 34 - 2 * m;  // [4, 32]
  const uint32_t mmask = (1u << (2 * m)) - 1u;
  uint32_t M[kPos];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const uint32_t qlo = __funnelshift_rc(pair[g + 1], pair[g], sh);
    const uint32_t qhi = __funnelshift_rc(pair[g], 0u, sh);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (16 * g + q < kPos) M[16 * g + q] = __funnelshift_r(qlo, qhi, 30 - 2 * q) & mmask;
    }
  }
  level<1>(M);  // L >= 2
  if (L >= 4) level<2>(M);
  if (L >= 8) level<4>(M);
  if (L >= 16) level<8>(M);
  switch (L - (1 << (31 - __clz(L)))) {
    case 0: combine<0>(M, r); break;
    case 1: combine<1>(M, r); break;
    case 2: combine<2>(M, r); break;
    case 3: combine<3>(M, r); break;
    case 4: combine<4>(M, r); break;
    case 5: combine<5>(M, r); break;
    case 6: combine<6>(M, r); break;
    case 7: combine<7>(M, r); break;
    case 8: combine<8>(M, r); break;
    case 9: combine<9>(M, r); break;
    case 10: combine<10>(M, r); break;
    case 11: combine<11>(M, r); break;
    case 12: combine<12>(M, r); break;
    case 13: combine<13>(M, r); break;
    case 14: combine<14>(M, r); break;
    default: combine<15>(M, r); break;
  }
}

__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 7); }

// Store one plane of the warp's 512 windows: lane l hands its 16 values as
// CHUNKS 16-byte chunks (chunks CHUNKS*l .. CHUNKS*l + CHUNKS-1 of the
// warp's span); out points at the span's first chunk, of which n_chunks
// lie in the plane.
template <int CHUNKS>
__device__ __forceinline__ void store_span(const uint4 (&chunk)[CHUNKS], uint4* stage, int lane,
                                           uint4* __restrict__ out, int64_t n_chunks) {
  __syncwarp();  // the warp's reads of the previous plane are done
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) stage[swizzle(CHUNKS * lane + q)] = chunk[q];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = 32 * i + lane;
    if (c < n_chunks) __stcs(out + c, stage[swizzle(c)]);  // streaming: evict first
  }
}

// A plane of 32-bit values: 4 windows a chunk.
__device__ __forceinline__ void store_u32(const uint32_t (&v)[16], uint4* stage, int lane,
                                          void* plane, int64_t first, int64_t left) {
  uint4 chunk[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    chunk[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  store_span<4>(chunk, stage, lane, static_cast<uint4*>(plane) + first / 4, left / 4);
}

// A plane of 16-bit values (the low halves of v): 8 windows a chunk.
__device__ __forceinline__ void store_u16(const uint32_t (&v)[16], uint4* stage, int lane,
                                          void* plane, int64_t first, int64_t left) {
  uint4 chunk[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t* u = v + 8 * q;
    chunk[q] = make_uint4(__byte_perm(u[0], u[1], 0x5410), __byte_perm(u[2], u[3], 0x5410),
                          __byte_perm(u[4], u[5], 0x5410), __byte_perm(u[6], u[7], 0x5410));
  }
  store_span<2>(chunk, stage, lane, static_cast<uint4*>(plane) + first / 8, left / 8);
}

template <int HI_BYTES, bool CANONICAL, bool MINIMIZER>
__global__ void __launch_bounds__(kThreads)
encode_packed_kernel(const uint32_t* __restrict__ words_le,
                     const uint32_t* __restrict__ inval_be, int64_t n_words,
                     int64_t n_own, int k, int32_t* __restrict__ lo_out,
                     void* __restrict__ hi_out, int m, int32_t* __restrict__ mins_out) {
  __shared__ uint4 stage_all[kThreads / 32 * kStageChunks];
  const int lane = threadIdx.x & 31;
  uint4* stage = stage_all + (threadIdx.x >> 5) * kStageChunks;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t first = 16 * (w - lane);    // the warp's first window
  const int64_t left = 16 * n_words - first;  // windows from there to the plane's end

  // Words past the plane read as zero data and no valid base.
  const uint32_t a = word_or_zero(words_le, w, n_words);
  const uint32_t b = word_or_zero(words_le, w + 1, n_words);
  const uint32_t c = word_or_zero(words_le, w + 2, n_words);
  uint64_t v = 0;  // bit i: base 16w + i valid
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (w + i < n_words) v |= static_cast<uint64_t>(valid16(__ldg(inval_be + w + i))) << (16 * i);
  }
  const int64_t room = n_own - 16 * w;  // owned starts among this word's
  const uint32_t own = room >= 16 ? 0xFFFFu : (room > 0 ? (1u << room) - 1u : 0u);
  const uint32_t valid = static_cast<uint32_t>(runs_of(v, k)) & own;
  const uint32_t x2 = digit_rev32(a), x1 = digit_rev32(b), x0 = digit_rev32(c);

  if constexpr (MINIMIZER) {
    uint32_t r[16];
    window_minima(x2, x1, x0, m, k - m + 1, r);
#pragma unroll
    for (int j = 0; j < 16; ++j) r[j] = (valid >> j) & 1u ? r[j] : kMinSentinel;
    store_u32(r, stage, lane, mins_out, first, left);
  }

  uint32_t z2, z1, z0;  // window j's code at bits 30-2j
  shr96(x2, x1, x0, 66 - 2 * k, z2, z1, z0);
  uint32_t mask = kAllOnes, hmask = 0u;  // of lo and of hi
  if constexpr (HI_BYTES) {
    hmask = (1u << (2 * k - 32)) - 1u;
  } else {
    mask = (1u << (2 * k)) - 1u;
  }
  uint32_t lo[16], hi[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t fl = __funnelshift_r(z0, z1, 30 - 2 * j) & mask;
    uint32_t fh = __funnelshift_r(z1, z2, 30 - 2 * j) & hmask;
    if constexpr (CANONICAL) {
      const uint32_t rl = __funnelshift_r(~a, ~b, 2 * j) & mask;
      const uint32_t rh = __funnelshift_r(~b, ~c, 2 * j) & hmask;
      if (rh < fh || (rh == fh && rl < fl)) {
        fl = rl;
        fh = rh;
      }
    }
    const bool ok = (valid >> j) & 1u;
    lo[j] = ok ? fl : kAllOnes;
    hi[j] = ok ? fh : kAllOnes;
  }
  store_u32(lo, stage, lane, lo_out, first, left);
  if constexpr (HI_BYTES == 2) store_u16(hi, stage, lane, hi_out, first, left);
  if constexpr (HI_BYTES == 4) store_u32(hi, stage, lane, hi_out, first, left);
}

template <int HI_BYTES, bool CANONICAL, bool MINIMIZER>
void launch_one(unsigned blocks, cudaStream_t s, const uint32_t* w, const uint32_t* iv,
                int64_t n_words, int64_t n_own, int k, int32_t* lo, void* hi, int m,
                int32_t* mins) {
  encode_packed_kernel<HI_BYTES, CANONICAL, MINIMIZER>
      <<<blocks, kThreads, 0, s>>>(w, iv, n_words, n_own, k, lo, hi, m, mins);
}

template <bool CANONICAL, bool MINIMIZER>
void launch(unsigned blocks, cudaStream_t s, const uint32_t* w, const uint32_t* iv,
            int64_t n_words, int64_t n_own, int k, int32_t* lo, void* hi, int hi_bytes, int m,
            int32_t* mins) {
  switch (hi_bytes) {
    case 0:
      launch_one<0, CANONICAL, MINIMIZER>(blocks, s, w, iv, n_words, n_own, k, lo, hi, m, mins);
      break;
    case 2:
      launch_one<2, CANONICAL, MINIMIZER>(blocks, s, w, iv, n_words, n_own, k, lo, hi, m, mins);
      break;
    default:
      launch_one<4, CANONICAL, MINIMIZER>(blocks, s, w, iv, n_words, n_own, k, lo, hi, m, mins);
      break;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// hi_bytes must be 0 for k <= 15, 2 for 16 <= k <= 23 and 4 for k >= 24.
// minimizer_m = 0 writes no minimizer plane; 1 <= minimizer_m < min(k, 16)
// writes one into `mins` (int32, one per window start). The planes may
// start at any word; lo, hi and mins must be 16-byte aligned.
extern "C" int kp_encode_packed(const void* words_le, const void* inval_be,
                                long long n_words, long long n_own, int k,
                                int canonical, void* lo, void* hi, int hi_bytes,
                                int minimizer_m, void* mins, void* stream) {
  const int want_hi = k <= 15 ? 0 : (k <= 23 ? 2 : 4);
  const int m_max = k < 16 ? k : 16;
  if (k < 1 || k > 31 || n_words <= 0 || hi_bytes != want_hi ||
      (hi_bytes && hi == nullptr) || minimizer_m < 0 || minimizer_m >= m_max ||
      (minimizer_m && mins == nullptr) || !aligned16(lo) || (hi_bytes && !aligned16(hi)) ||
      (minimizer_m && !aligned16(mins))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks64 = (static_cast<int64_t>(n_words) + kThreads - 1) / kThreads;
  if (blocks64 > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(blocks64);
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const uint32_t*>(words_le);
  auto iv = static_cast<const uint32_t*>(inval_be);
  auto lo32 = static_cast<int32_t*>(lo);
  auto mn = static_cast<int32_t*>(mins);
  const int m = minimizer_m;
  if (canonical && m) {
    launch<true, true>(blocks, s, w, iv, n_words, n_own, k, lo32, hi, hi_bytes, m, mn);
  } else if (canonical) {
    launch<true, false>(blocks, s, w, iv, n_words, n_own, k, lo32, hi, hi_bytes, m, mn);
  } else if (m) {
    launch<false, true>(blocks, s, w, iv, n_words, n_own, k, lo32, hi, hi_bytes, m, mn);
  } else {
    launch<false, false>(blocks, s, w, iv, n_words, n_own, k, lo32, hi, hi_bytes, m, mn);
  }
  return static_cast<int>(cudaGetLastError());
}
