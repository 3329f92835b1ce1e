// Packed-plane window encoder (K1) for Hopper, sm_90a.
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
// window's k-m+1 m-mers, forward even when canonical is set, since it
// decides the window's owner in the bucketed exchange. INT32_MAX at an
// invalid window (the TPU plane holds garbage there).
//
// Design: one thread per window start. A thread reads the at most three
// words its window spans (neighbouring threads share them through L1),
// forms the window as a little-endian 64-bit digit stream, checks the same
// span of the invalid plane, and reverses the digits into the big-endian
// code. The reverse complement is the complemented little-endian stream
// itself, masked to 2k bits. Neighbouring threads store to neighbouring
// addresses.
//
// The minimizer reuses the window's forward code: the m-mer at offset j
// is the 2m-bit field at bit 2(k-m-j) of it, so the plane costs k-m+1
// shift/and/min steps per window (25 at k=31, m=7) and one more store;
// the span-min doubling ladder of the Pallas body shares work across a
// TPU tile's 16 residues and has no counterpart here. A template flag
// keeps the kernel without the plane unchanged.
//
// Bound: the stores. A window costs 4 B of output for k <= 15, 6 B for
// 16-23 and 8 B for k >= 24 (4 B more with the minimizer plane), against
// about 0.5 B per base read, so the kernel is a streaming write at
// device-memory bandwidth. The funnel and lane-roll families of the
// Pallas body are TPU layout devices and have no counterpart here; wide
// stores and several windows per thread are left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Reverse the 32 2-bit digits of x.
__device__ __forceinline__ uint64_t digit_rev64(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// Reverse the 16 2-bit digits of x (big-endian plane word -> little-endian).
__device__ __forceinline__ uint32_t digit_rev32(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// The 32 little-endian digits that start at digit r (0 <= r < 16) of the
// three consecutive words a, b, c: digit i of the result at bits 2i.
__device__ __forceinline__ uint64_t span_le(uint32_t a, uint32_t b, uint32_t c,
                                            int r) {
  uint64_t s = static_cast<uint64_t>(a) | (static_cast<uint64_t>(b) << 32);
  if (r) s = (s >> (2 * r)) | (static_cast<uint64_t>(c) << (64 - 2 * r));
  return s;
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* __restrict__ p,
                                                 int64_t i, int64_t n) {
  return i < n ? __ldg(p + i) : 0u;
}

template <int HI_BYTES, bool MINIMIZER>
__global__ void __launch_bounds__(kThreads)
encode_packed_kernel(const uint32_t* __restrict__ words_le,
                     const uint32_t* __restrict__ inval_be, int64_t n_words,
                     int64_t n_own, int k, bool canonical,
                     int32_t* __restrict__ lo_out, void* __restrict__ hi_out,
                     int m, int32_t* __restrict__ mins_out) {
  const int64_t n = 16 * n_words;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  bool valid = p < n_own && p + k <= n;
  uint64_t code = 0;
  uint32_t mini = 0x7FFFFFFFu;  // INT32_MAX: above every m-mer code (< 4^15)
  if (valid) {
    const int64_t w = p >> 4;
    const int r = static_cast<int>(p & 15);
    const uint64_t mask = (1ull << (2 * k)) - 1;
    // Words past the plane only ever feed digits past the window.
    const uint64_t bad =
        span_le(digit_rev32(__ldg(inval_be + w)),
                digit_rev32(word_or_zero(inval_be, w + 1, n_words)),
                digit_rev32(word_or_zero(inval_be, w + 2, n_words)), r) &
        mask;
    valid = bad == 0;
    const uint64_t s = span_le(__ldg(words_le + w),
                               word_or_zero(words_le, w + 1, n_words),
                               word_or_zero(words_le, w + 2, n_words), r);
    code = digit_rev64(s) >> (64 - 2 * k);
    if constexpr (MINIMIZER) {
      if (valid) {
        const uint32_t mmask = (1u << (2 * m)) - 1u;
        for (int sh = 2 * (k - m); sh >= 0; sh -= 2) {
          const uint32_t v = static_cast<uint32_t>(code >> sh) & mmask;
          mini = v < mini ? v : mini;
        }
      }
    }
    if (canonical) {
      const uint64_t rc = ~s & mask;
      code = rc < code ? rc : code;
    }
  }
  lo_out[p] = valid ? static_cast<int32_t>(static_cast<uint32_t>(code)) : -1;
  if constexpr (HI_BYTES == 2) {
    static_cast<int16_t*>(hi_out)[p] =
        valid ? static_cast<int16_t>(code >> 32) : static_cast<int16_t>(-1);
  } else if constexpr (HI_BYTES == 4) {
    static_cast<int32_t*>(hi_out)[p] =
        valid ? static_cast<int32_t>(code >> 32) : -1;
  }
  if constexpr (MINIMIZER) {
    mins_out[p] = static_cast<int32_t>(mini);
  }
}

template <bool MINIMIZER>
void launch(unsigned blocks, cudaStream_t s, const uint32_t* w,
            const uint32_t* iv, int64_t n_words, int64_t n_own, int k, bool c,
            int32_t* lo, void* hi, int hi_bytes, int m, int32_t* mins) {
  switch (hi_bytes) {
    case 0:
      encode_packed_kernel<0, MINIMIZER><<<blocks, kThreads, 0, s>>>(
          w, iv, n_words, n_own, k, c, lo, hi, m, mins);
      break;
    case 2:
      encode_packed_kernel<2, MINIMIZER><<<blocks, kThreads, 0, s>>>(
          w, iv, n_words, n_own, k, c, lo, hi, m, mins);
      break;
    default:
      encode_packed_kernel<4, MINIMIZER><<<blocks, kThreads, 0, s>>>(
          w, iv, n_words, n_own, k, c, lo, hi, m, mins);
      break;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// hi_bytes must be 0 for k <= 15, 2 for 16 <= k <= 23 and 4 for k >= 24.
// minimizer_m = 0 writes no minimizer plane; 1 <= minimizer_m < min(k, 16)
// writes one into `mins` (int32, one per window start).
extern "C" int kp_encode_packed(const void* words_le, const void* inval_be,
                                long long n_words, long long n_own, int k,
                                int canonical, void* lo, void* hi, int hi_bytes,
                                int minimizer_m, void* mins, void* stream) {
  const int want_hi = k <= 15 ? 0 : (k <= 23 ? 2 : 4);
  const int m_max = k < 16 ? k : 16;
  if (k < 1 || k > 31 || n_words <= 0 || hi_bytes != want_hi ||
      (hi_bytes && hi == nullptr) || minimizer_m < 0 || minimizer_m >= m_max ||
      (minimizer_m && mins == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = 16 * static_cast<int64_t>(n_words);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const uint32_t*>(words_le);
  auto iv = static_cast<const uint32_t*>(inval_be);
  auto lo32 = static_cast<int32_t*>(lo);
  auto mn = static_cast<int32_t*>(mins);
  const bool c = canonical != 0;
  if (minimizer_m) {
    launch<true>(blocks, s, w, iv, n_words, n_own, k, c, lo32, hi, hi_bytes,
                 minimizer_m, mn);
  } else {
    launch<false>(blocks, s, w, iv, n_words, n_own, k, c, lo32, hi, hi_bytes,
                  0, mn);
  }
  return static_cast<int>(cudaGetLastError());
}
