// Packed-plane window encoder (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/encode_pallas.py::rolling_codes_split_packed_pallas
//   (body _make_packed_encode_kernel), as called with words_le=True,
// without its minimizer plane and benchmark hooks.
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
//
// Design: one thread per window start. A thread reads the at most three
// words its window spans (neighbouring threads share them through L1),
// forms the window as a little-endian 64-bit digit stream, checks the same
// span of the invalid plane, and reverses the digits into the big-endian
// code. The reverse complement is the complemented little-endian stream
// itself, masked to 2k bits. Neighbouring threads store to neighbouring
// addresses.
//
// Bound: the stores. A window costs 4 B of output for k <= 15, 6 B for
// 16-23 and 8 B for k >= 24, against about 0.5 B per base read, so the
// kernel is a streaming write at device-memory bandwidth. The funnel and
// lane-roll families of the Pallas body are TPU layout devices and have
// no counterpart here; wide stores and several windows per thread are
// left for later.

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

template <int HI_BYTES>
__global__ void __launch_bounds__(kThreads)
encode_packed_kernel(const uint32_t* __restrict__ words_le,
                     const uint32_t* __restrict__ inval_be, int64_t n_words,
                     int64_t n_own, int k, bool canonical,
                     int32_t* __restrict__ lo_out, void* __restrict__ hi_out) {
  const int64_t n = 16 * n_words;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  bool valid = p < n_own && p + k <= n;
  uint64_t code = 0;
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
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// hi_bytes must be 0 for k <= 15, 2 for 16 <= k <= 23 and 4 for k >= 24.
extern "C" int kp_encode_packed(const void* words_le, const void* inval_be,
                                long long n_words, long long n_own, int k,
                                int canonical, void* lo, void* hi, int hi_bytes,
                                void* stream) {
  const int want_hi = k <= 15 ? 0 : (k <= 23 ? 2 : 4);
  if (k < 1 || k > 31 || n_words <= 0 || hi_bytes != want_hi ||
      (hi_bytes && hi == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = 16 * static_cast<int64_t>(n_words);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const uint32_t*>(words_le);
  auto iv = static_cast<const uint32_t*>(inval_be);
  auto lo32 = static_cast<int32_t*>(lo);
  const bool c = canonical != 0;
  switch (hi_bytes) {
    case 0:
      encode_packed_kernel<0><<<blocks, kThreads, 0, s>>>(w, iv, n_words, n_own,
                                                          k, c, lo32, hi);
      break;
    case 2:
      encode_packed_kernel<2><<<blocks, kThreads, 0, s>>>(w, iv, n_words, n_own,
                                                          k, c, lo32, hi);
      break;
    default:
      encode_packed_kernel<4><<<blocks, kThreads, 0, s>>>(w, iv, n_words, n_own,
                                                          k, c, lo32, hi);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
