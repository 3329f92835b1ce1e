// The first port's K1/K1m kernel, timed beside the port's packed-plane
// window encoder (dna_kmeres_parallel_tpu_torch/csrc/encode_packed.cu,
// included whole here, so this library also holds kp_encode_packed as
// built):
//   kv_encode_packed_before  one thread per window start: it reads the
//       three words its window spans from both planes, reverses the digits
//       of the 64-bit span, and with the minimizer plane walks the window's
//       k-m+1 m-mers one by one; one scalar store a plane.
// Same C signature as kp_encode_packed. Built by
// scripts/encode_variants_probe.py with nvcc -I <csrc>; it is not part of
// the port's library.

#include "encode_packed.cu"

namespace before {

constexpr int kThreads = 256;

// Reverse the 32 2-bit digits of x.
__device__ __forceinline__ uint64_t digit_rev64(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// The 32 little-endian digits that start at digit r (0 <= r < 16) of the
// three consecutive words a, b, c: digit i of the result at bits 2i.
__device__ __forceinline__ uint64_t span_le(uint32_t a, uint32_t b, uint32_t c, int r) {
  uint64_t s = static_cast<uint64_t>(a) | (static_cast<uint64_t>(b) << 32);
  if (r) s = (s >> (2 * r)) | (static_cast<uint64_t>(c) << (64 - 2 * r));
  return s;
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
  uint32_t mini = 0x7FFFFFFFu;
  if (valid) {
    const int64_t w = p >> 4;
    const int r = static_cast<int>(p & 15);
    const uint64_t mask = (1ull << (2 * k)) - 1;
    const uint64_t bad =
        span_le(digit_rev32(__ldg(inval_be + w)),
                digit_rev32(word_or_zero(inval_be, w + 1, n_words)),
                digit_rev32(word_or_zero(inval_be, w + 2, n_words)), r) &
        mask;
    valid = bad == 0;
    const uint64_t s = span_le(__ldg(words_le + w), word_or_zero(words_le, w + 1, n_words),
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
    static_cast<int32_t*>(hi_out)[p] = valid ? static_cast<int32_t>(code >> 32) : -1;
  }
  if constexpr (MINIMIZER) mins_out[p] = static_cast<int32_t>(mini);
}

template <bool MINIMIZER>
void launch(unsigned blocks, cudaStream_t s, const uint32_t* w, const uint32_t* iv,
            int64_t n_words, int64_t n_own, int k, bool c, int32_t* lo, void* hi,
            int hi_bytes, int m, int32_t* mins) {
  switch (hi_bytes) {
    case 0:
      encode_packed_kernel<0, MINIMIZER><<<blocks, kThreads, 0, s>>>(w, iv, n_words, n_own, k,
                                                                     c, lo, hi, m, mins);
      break;
    case 2:
      encode_packed_kernel<2, MINIMIZER><<<blocks, kThreads, 0, s>>>(w, iv, n_words, n_own, k,
                                                                     c, lo, hi, m, mins);
      break;
    default:
      encode_packed_kernel<4, MINIMIZER><<<blocks, kThreads, 0, s>>>(w, iv, n_words, n_own, k,
                                                                     c, lo, hi, m, mins);
      break;
  }
}

}  // namespace before

extern "C" int kv_encode_packed_before(const void* words_le, const void* inval_be,
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
  const unsigned blocks = static_cast<unsigned>((n + before::kThreads - 1) / before::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const uint32_t*>(words_le);
  auto iv = static_cast<const uint32_t*>(inval_be);
  auto lo32 = static_cast<int32_t*>(lo);
  auto mn = static_cast<int32_t*>(mins);
  const bool c = canonical != 0;
  if (minimizer_m) {
    before::launch<true>(blocks, s, w, iv, n_words, n_own, k, c, lo32, hi, hi_bytes,
                         minimizer_m, mn);
  } else {
    before::launch<false>(blocks, s, w, iv, n_words, n_own, k, c, lo32, hi, hi_bytes, 0, mn);
  }
  return static_cast<int>(cudaGetLastError());
}
