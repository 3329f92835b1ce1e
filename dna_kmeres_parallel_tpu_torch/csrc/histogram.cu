// Dense k-mer histograms (K5-K8) for Hopper, sm_90a.
//
// Replace the TPU kernels of dna_kmeres_parallel_tpu/ops/histogram_pallas.py:
//   K5 kp_hist_planes    histogram_bp2_packed_pallas (_make_hist_bp2_packed_kernel)
//   K6 kp_hist_u8        histogram_bp2_pallas (_make_hist_bp2_kernel, _bp2_accumulate)
//   K7 kp_hist_u8_small  histogram_bitplane_pallas (_make_hist_bitplane_kernel)
//   K8 kp_hist_u8_any    histogram_pallas (_make_hist2d_fused_kernel)
//
// Every entry computes one function and ADDS it into a caller-given int32
// accumulator acc[bins]: acc[c] += the number of windows starting at p with
// p < n_own, p + k <= n (n bases in the input), all k bases valid, and
// code == c, where code is the window's big-endian 2-bit code, or the
// smaller of it and its reverse complement with canonical set. Codes >= bins
// are dropped. Integer atomics make the counts exact in any order.
//
// Inputs:
//   K5  two u32 planes of n_words words, 16 bases per word (K1's wire
//       format, csrc/encode_packed.cu): words_le holds base j of a word at
//       bits 2j; inval_be holds digit 11 at bits 30-2j where base j is
//       invalid. k <= 8 and bins = 4^k.
//   K6  a u8 base stream (0..3 valid, anything else invalid); bins a power
//       of two <= 65,536.
//   K7  the same stream; bins <= 64 (k <= 3).
//   K8  the same stream; any bins from 1 to 4^12.
//
// Design. The TPU kernels build one-hot planes and reduce them on the MXU
// because a TPU has no scatter; on the card a histogram is a shared-memory
// atomic add per window. A block zeroes a private copy of its slice of the
// bins in shared memory, walks its windows with a grid-stride loop, adds
// the windows whose code falls in its slice, and flushes the non-zero bins
// into acc with device-memory atomics. 65,536 int32 bins (256 KB) do not fit
// a block's 227 KB, so the bin range is split across blockIdx.y into slices
// of at most kSliceBins (64 KB, above the 48 KB default, so the entries raise
// the kernels' dynamic shared-memory limit); each slice's blocks re-read the
// input, which stays in L2. The grid is sized to about two blocks per SM
// in all, so the flush costs at most about 2 * SMs * bins atomics per
// launch, against one shared atomic per window.
//   K5 forms a window from the two plane words its start word and the next
//   hold (k <= 8 spans at most two), one thread per word, 16 windows each.
//   K7 keeps one sub-histogram per warp and aggregates the lanes of a warp
//   that hold one code (__match_any_sync) into one add, so a homopolymer run,
//   which sends all 32 lanes to one bin, costs one atomic and not 32.
//   K8 above 65,536 bins adds each window straight into acc in device memory
//   (4^11 int32 bins are 16 MB, which stay in L2).
//
// Bound: the bytes. A window costs 1 B of u8 input (K6-K8) or 0.5 B of
// planes (K5) and one integer add; the histogram is read and written once.
// At one 16 Mbase batch that is 16.8 MB (8.4 MB for K5), a few microseconds
// at 3.35 TB/s. Shared-atomic throughput, the repeated reads of the slices
// and the flush keep these simple kernels well above it; wider loads,
// several windows per thread and sub-word counters are left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceBins = 16384;   // 64 KB of int32 per block
constexpr int kSmallBins = 64;      // K7's widest histogram
constexpr int kSlicedMaxBins = 65536;
constexpr int kMaxDenseBins = 1 << 24;  // 4^12

// Reverse the 16 2-bit digits of x.
__device__ __forceinline__ uint32_t digit_rev32(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* __restrict__ p,
                                                 int64_t i, int64_t n) {
  return i < n ? __ldg(p + i) : 0u;
}

// The code of the window of the u8 stream that starts at p (its k bases lie
// in the stream); false if one of them is invalid.
__device__ __forceinline__ bool u8_code(const uint8_t* __restrict__ bases,
                                        int64_t p, int k, bool canonical,
                                        uint32_t* out) {
  uint32_t code = 0, rc = 0;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t b = __ldg(bases + p + j);
    ok &= b < 4;
    code = (code << 2) | (b & 3);
    rc |= (3u - (b & 3)) << (2 * j);  // base j is digit j of the RC
  }
  *out = canonical ? min(code, rc) : code;
  return ok;
}

__device__ __forceinline__ void zero_shared(int32_t* hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0;
  __syncthreads();
}

// Add the block's non-zero shared bins into acc (device memory).
__device__ __forceinline__ void flush_shared(const int32_t* hist, int n,
                                             int32_t* __restrict__ acc) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t h = hist[i];
    if (h) atomicAdd(acc + i, h);
  }
}

// K5: windows from the planes, one thread per start word. limit = the
// number of window starts to count, min(n_own, 16 * n_words - k + 1) > 0.
__global__ void __launch_bounds__(kThreads)
hist_planes_kernel(const uint32_t* __restrict__ words_le,
                   const uint32_t* __restrict__ inval_be, int64_t n_words,
                   int64_t limit, int k, bool canonical, int bins, int slice,
                   int32_t* __restrict__ acc) {
  extern __shared__ int32_t hist[];
  const int b0 = blockIdx.y * slice;
  const int nb = min(slice, bins - b0);
  zero_shared(hist, nb);
  const uint32_t mask = (1u << (2 * k)) - 1;
  const int64_t n_start_words = (limit + 15) >> 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       w < n_start_words; w += stride) {
    // Digits 0..31 from base 16w on, little-endian; a counted window never
    // reaches past the plane, so the zero word past its end is never read
    // as a base.
    const uint64_t s = static_cast<uint64_t>(__ldg(words_le + w)) |
                       (static_cast<uint64_t>(word_or_zero(words_le, w + 1, n_words)) << 32);
    const uint64_t bad =
        static_cast<uint64_t>(digit_rev32(__ldg(inval_be + w))) |
        (static_cast<uint64_t>(digit_rev32(word_or_zero(inval_be, w + 1, n_words))) << 32);
    const int64_t left = limit - 16 * w;
    const int n_here = left < 16 ? static_cast<int>(left) : 16;
    for (int r = 0; r < n_here; ++r) {
      if (static_cast<uint32_t>(bad >> (2 * r)) & mask) continue;
      const uint32_t sr = static_cast<uint32_t>(s >> (2 * r));
      uint32_t code = digit_rev32(sr) >> (32 - 2 * k);
      if (canonical) code = min(code, ~sr & mask);
      const uint32_t off = code - static_cast<uint32_t>(b0);
      if (off < static_cast<uint32_t>(nb)) atomicAdd(&hist[off], 1);
    }
  }
  flush_shared(hist, nb, acc + b0);
}

// K6, and K8 up to 65,536 bins: a sliced block-private histogram of the
// u8 stream. limit = min(n_own, n - k + 1) > 0.
__global__ void __launch_bounds__(kThreads)
hist_u8_sliced_kernel(const uint8_t* __restrict__ bases, int64_t limit, int k,
                      bool canonical, int bins, int slice,
                      int32_t* __restrict__ acc) {
  extern __shared__ int32_t hist[];
  const int b0 = blockIdx.y * slice;
  const int nb = min(slice, bins - b0);
  zero_shared(hist, nb);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < limit; p += stride) {
    uint32_t code;
    if (!u8_code(bases, p, k, canonical, &code)) continue;
    const uint32_t off = code - static_cast<uint32_t>(b0);
    if (off < static_cast<uint32_t>(nb)) atomicAdd(&hist[off], 1);
  }
  flush_shared(hist, nb, acc + b0);
}

// K7: per-warp sub-histograms, lanes of one code aggregated.
__global__ void __launch_bounds__(kThreads)
hist_u8_small_kernel(const uint8_t* __restrict__ bases, int64_t limit, int k,
                     bool canonical, int bins, int32_t* __restrict__ acc) {
  __shared__ int32_t hist[kWarps * kSmallBins];
  zero_shared(hist, kWarps * kSmallBins);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* mine = hist + warp * kSmallBins;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // The loop bound is the warp's first window, so all 32 lanes take every
  // step together, as __match_any_sync needs.
  for (int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads + (warp << 5);
       p0 < limit; p0 += stride) {
    const int64_t p = p0 + lane;
    uint32_t code = 0;
    const bool ok = p < limit && u8_code(bases, p, k, canonical, &code) &&
                    code < static_cast<uint32_t>(bins);
    const uint32_t key = ok ? code : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&mine[code], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += kThreads) {
    int32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += hist[w * kSmallBins + i];
    if (s) atomicAdd(acc + i, s);
  }
}

// K8 above 65,536 bins: each window adds straight into acc.
__global__ void __launch_bounds__(kThreads)
hist_u8_global_kernel(const uint8_t* __restrict__ bases, int64_t limit, int k,
                      bool canonical, int bins, int32_t* __restrict__ acc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < limit; p += stride) {
    uint32_t code;
    if (u8_code(bases, p, k, canonical, &code) &&
        code < static_cast<uint32_t>(bins)) {
      atomicAdd(acc + code, 1);
    }
  }
}

// Blocks along x for `items` work items and `gy` bin slices: enough for
// every item, at most about two blocks per SM in all, at least one.
int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

unsigned blocks_x(int64_t items, int gy) {
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = (2 * static_cast<int64_t>(sm_count()) + gy - 1) / gy;
  const int64_t n = want < cap ? want : cap;
  return static_cast<unsigned>(n < 1 ? 1 : n);
}

// The width of a bin slice for `bins`.
int slice_of(int bins) { return bins < kSliceBins ? bins : kSliceBins; }

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Windows to count: starts below n_own whose k bases lie in the n bases.
int64_t window_limit(int64_t n, int64_t n_own, int k) {
  const int64_t in_stream = n - k + 1;
  const int64_t lim = n_own < in_stream ? n_own : in_stream;
  return lim > 0 ? lim : 0;
}

cudaError_t launch_u8_sliced(const uint8_t* bases, int64_t limit, int k,
                             bool canonical, int bins, int32_t* acc,
                             cudaStream_t s) {
  const int slice = slice_of(bins);
  const int gy = (bins + slice - 1) / slice;
  const int bytes = slice * static_cast<int>(sizeof(int32_t));
  cudaError_t err = allow_shared(hist_u8_sliced_kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks_x(limit, gy), gy);
  hist_u8_sliced_kernel<<<grid, kThreads, bytes, s>>>(bases, limit, k, canonical,
                                                      bins, slice, acc);
  return cudaGetLastError();
}

bool u8_args_ok(long long n, int k, int bins) {
  return n >= 0 && k >= 1 && k <= 15 && bins >= 1;
}

}  // namespace

// Each entry launches one kernel on `stream`, even when no window counts,
// and returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue for arguments it does not take, without launching.

// K5. words_le, inval_be: u32 [n_words]; acc: int32 [4^k]; 1 <= k <= 8.
extern "C" int kp_hist_planes(const void* words_le, const void* inval_be,
                              long long n_words, long long n_own, int k,
                              int canonical, void* acc, void* stream) {
  if (k < 1 || k > 8 || n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bins = 1 << (2 * k);
  const int64_t limit = window_limit(16 * static_cast<int64_t>(n_words), n_own, k);
  const int slice = slice_of(bins);
  const int gy = (bins + slice - 1) / slice;
  const int bytes = slice * static_cast<int>(sizeof(int32_t));
  cudaError_t err = allow_shared(hist_planes_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks_x((limit + 15) / 16, gy), gy);
  hist_planes_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words_le), static_cast<const uint32_t*>(inval_be),
      n_words, limit, k, canonical != 0, bins, slice, static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// K6. bases: u8 [n]; acc: int32 [bins]; bins a power of two <= 65,536.
extern "C" int kp_hist_u8(const void* bases, long long n, long long n_own, int k,
                          int canonical, int bins, void* acc, void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kSlicedMaxBins || (bins & (bins - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_u8_sliced(
      static_cast<const uint8_t*>(bases), window_limit(n, n_own, k), k,
      canonical != 0, bins, static_cast<int32_t*>(acc),
      static_cast<cudaStream_t>(stream)));
}

// K7. bases: u8 [n]; acc: int32 [bins]; bins <= 64.
extern "C" int kp_hist_u8_small(const void* bases, long long n, long long n_own,
                                int k, int canonical, int bins, void* acc,
                                void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kSmallBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t limit = window_limit(n, n_own, k);
  hist_u8_small_kernel<<<blocks_x(limit, 1), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), limit, k, canonical != 0, bins,
      static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// K8. bases: u8 [n]; acc: int32 [bins]; 1 <= bins <= 4^12.
extern "C" int kp_hist_u8_any(const void* bases, long long n, long long n_own,
                              int k, int canonical, int bins, void* acc,
                              void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kMaxDenseBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const uint8_t*>(bases);
  auto* a = static_cast<int32_t*>(acc);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t limit = window_limit(n, n_own, k);
  if (bins <= kSlicedMaxBins) {
    return static_cast<int>(launch_u8_sliced(b, limit, k, canonical != 0, bins, a, s));
  }
  // No flush here, so the grid may be as wide as the card holds.
  const int64_t want = (limit + kThreads - 1) / kThreads;
  const int64_t cap = 8 * static_cast<int64_t>(sm_count());
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  hist_u8_global_kernel<<<blocks, kThreads, 0, s>>>(b, limit, k, canonical != 0,
                                                    bins, a);
  return static_cast<int>(cudaGetLastError());
}
