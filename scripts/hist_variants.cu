// Candidates timed beside the port's dense histogram kernels K5 and K7
// (dna_kmeres_parallel_tpu_torch/csrc/histogram.cu, included whole here, so
// this library also holds the kernels as built):
//   kv_old_planes  K5 as first ported: one thread per plane word, the 4^k
//                  bins split over blockIdx.y into 64 KB slices, each slice's
//                  blocks re-reading every plane, a per-bin atomic flush;
//   kv_old_small   K7 as first ported: one window a thread, k byte loads,
//                  one 64-bin sub-histogram per warp, lanes of one code
//                  aggregated by __match_any_sync;
//   kv_planes_cluster  K5 on the cluster histogram (ClusterHist) in clusters
//                  of 1, 2 or 4 blocks, as K6 holds 4^8 bins;
//   kv_planes_global  K5 with every window (or run of one code in a
//                  thread) added straight into acc in device memory (red.global;
//                  4^8 int32 bins are 256 KB, which stay in L2);
//   kv_pair_small  K7 (u8 or packed) with 16-bit counters in pairs, in
//                  blocks of 1,024 threads (one block of 128 KB an SM).
// Built by scripts/hist_variants_probe.py with nvcc -I <csrc>; it is not
// part of the port's library.

#include "histogram.cu"

namespace {

constexpr int kOldSliceBins = 16384;  // the first port's 64 KB of int32 per block
constexpr int kOldWarps = kThreads / 32;

__device__ __forceinline__ void old_zero_shared(int32_t* hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0;
  __syncthreads();
}

__device__ __forceinline__ void old_flush_shared(const int32_t* hist, int n,
                                                 int32_t* __restrict__ acc) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t h = hist[i];
    if (h) atomicAdd(acc + i, h);
  }
}

__global__ void __launch_bounds__(kThreads)
old_planes_kernel(const uint32_t* __restrict__ words_le,
                  const uint32_t* __restrict__ inval_be, int64_t n_words,
                  int64_t limit, int k, bool canonical, int bins, int slice,
                  int32_t* __restrict__ acc) {
  extern __shared__ int32_t old_hist[];
  const int b0 = blockIdx.y * slice;
  const int nb = min(slice, bins - b0);
  old_zero_shared(old_hist, nb);
  const uint32_t mask = (1u << (2 * k)) - 1;
  const int64_t n_start_words = (limit + 15) >> 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       w < n_start_words; w += stride) {
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
      if (off < static_cast<uint32_t>(nb)) atomicAdd(&old_hist[off], 1);
    }
  }
  old_flush_shared(old_hist, nb, acc + b0);
}

__global__ void __launch_bounds__(kThreads)
old_small_kernel(const uint8_t* __restrict__ bases, int64_t limit, int k,
                 bool canonical, int bins, int32_t* __restrict__ acc) {
  __shared__ int32_t hist[kOldWarps * kSmallBins];
  old_zero_shared(hist, kOldWarps * kSmallBins);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* mine = hist + warp * kSmallBins;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
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
    for (int w = 0; w < kOldWarps; ++w) s += hist[w * kSmallBins + i];
    if (s) atomicAdd(acc + i, s);
  }
}

// The first port's grid: enough blocks for every item, about two per SM in all.
unsigned old_blocks_x(int64_t items, int gy) {
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = (2 * static_cast<int64_t>(sm_count()) + gy - 1) / gy;
  const int64_t n = want < cap ? want : cap;
  return static_cast<unsigned>(n < 1 ? 1 : n);
}

struct GlobalHist {
  int32_t* acc;
  __device__ __forceinline__ void add(uint32_t code, int32_t n) const {
    atomicAdd(acc + code, n);
  }
};

template <bool kCanonical>
__global__ void __launch_bounds__(kThreads)
planes_global_kernel(const uint32_t* __restrict__ words_le,
                     const uint32_t* __restrict__ inval_be, int64_t n_words,
                     int64_t limit, int k, int bins, int32_t* __restrict__ acc) {
  const GlobalHist h{acc};
  const int64_t n_start_words = (limit + 15) >> 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < n_start_words; w += stride) {
    Held<GlobalHist> held{h};
    count_planes<kCanonical>(words_le, inval_be, n_words, w, limit, k,
                             static_cast<uint32_t>(bins), held);
    held.done();
  }
}


constexpr int kPairThreads = 1024;
// A 16-bit counter holds at most 65,535: the most starts a thread takes.
constexpr int64_t kPairMaxStarts = 65535;

// K7 with bin b of thread t in the 16 bits from 16 (b % 2) up of word
// (b / 2) * kPairThreads + t; kPacked: from the packed batch (data, mask),
// else from the u8 stream (data; mask not read).
template <bool kCanonical, bool kPacked>
__global__ void __launch_bounds__(kPairThreads)
pair_small_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ mask,
                  int64_t n, int64_t limit, int k, int bins, int32_t* __restrict__ acc) {
  extern __shared__ uint4 pair4[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(pair4);
  const int words = (bins + 1) / 2;
  for (int i = threadIdx.x; i < words * kPairThreads / 4; i += kPairThreads) {
    pair4[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  uint32_t* mine = cnt + threadIdx.x;
  auto add = [&](uint32_t key) { mine[(key >> 1) * kPairThreads] += 1u << ((key & 1u) << 4); };
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (kPacked) {
    const bool vec = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(mask) % 8 == 0;
    for (int64_t c0 = warp * 32; c0 < ((limit + 63) >> 6); c0 += stride) {
      const int64_t c = c0 + lane;
      uint32_t cd[4], cm[2];
      packed_chunk(data, mask, c, n, vec, cd, cm);
      uint32_t hd = __shfl_down_sync(0xFFFFFFFFu, cd[0], 1);
      uint32_t hm = __shfl_down_sync(0xFFFFFFFFu, cm[0], 1);
      if (lane == 31) {
        uint32_t nd[4], nm[2];
        packed_chunk(data, mask, c + 1, n, vec, nd, nm);
        hd = nd[0];
        hm = nm[0];
      }
      const uint32_t d[5] = {cd[0], cd[1], cd[2], cd[3], hd};
      const uint32_t m[3] = {cm[0], cm[1], hm};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint64_t dr = d[r] | (static_cast<uint64_t>(d[r + 1]) << 32);
        const uint32_t vr = __funnelshift_r(m[r / 2], m[r / 2 + 1], 16 * (r & 1));
        count16<kCanonical>(dr, vr, 64 * c + 16 * r, limit, k, static_cast<uint32_t>(bins),
                            add);
      }
    }
  } else {
    const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(data) & 15);
    const uint8_t* abase = data - mis;
    for (int64_t c0 = warp * 32; c0 < ((limit + mis + 15) >> 4); c0 += stride) {
      const int64_t c = c0 + lane;
      uint32_t w[8];
      u8_chunk_pair(abase, c, mis, n + mis, w);
      count_u8<kCanonical>(w, 16 * c - mis, limit, k, static_cast<uint32_t>(bins), add);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x >> 5; b < bins; b += kPairThreads / 32) {
    const uint32_t* row = cnt + (b >> 1) * kPairThreads + lane;
    uint32_t sum = 0;
#pragma unroll 8
    for (int t = 0; t < kPairThreads; t += 32) sum += (row[t] >> (16 * (b & 1))) & 0xFFFFu;
    sum = __reduce_add_sync(0xFFFFFFFFu, sum);
    if (lane == 0 && sum) atomicAdd(acc + b, static_cast<int32_t>(sum));
  }
}

}  // namespace

extern "C" int kv_old_planes(const void* words_le, const void* inval_be, long long n_words,
                             long long n_own, int k, int canonical, void* acc, void* stream) {
  if (k < 1 || k > 8 || n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bins = 1 << (2 * k);
  const int64_t limit = window_limit(16 * static_cast<int64_t>(n_words), n_own, k);
  const int slice = bins < kOldSliceBins ? bins : kOldSliceBins;
  const int gy = (bins + slice - 1) / slice;
  const int bytes = slice * static_cast<int>(sizeof(int32_t));
  cudaError_t err = allow_shared(old_planes_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(old_blocks_x((limit + 15) / 16, gy), gy);
  old_planes_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words_le), static_cast<const uint32_t*>(inval_be),
      n_words, limit, k, canonical != 0, bins, slice, static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_old_small(const void* bases, long long n, long long n_own, int k,
                            int canonical, int bins, void* acc, void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kSmallBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t limit = window_limit(n, n_own, k);
  old_small_kernel<<<old_blocks_x(limit, 1), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), limit, k, canonical != 0, bins,
      static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_planes_global(const void* words_le, const void* inval_be,
                                long long n_words, long long n_own, int k, int canonical,
                                void* acc, void* stream) {
  if (k < 1 || k > 8 || n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bins = 1 << (2 * k);
  const int64_t limit = window_limit(16 * static_cast<int64_t>(n_words), n_own, k);
  const int64_t want = ((limit + 15) / 16 + kThreads - 1) / kThreads;
  const int64_t cap = 8 * static_cast<int64_t>(sm_count());
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  auto kernel = canonical ? planes_global_kernel<true> : planes_global_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words_le), static_cast<const uint32_t*>(inval_be),
      static_cast<int64_t>(n_words), limit, k, bins, static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_planes_cluster(const void* words_le, const void* inval_be,
                                 long long n_words, long long n_own, int k, int canonical,
                                 int cluster, void* acc, void* stream) {
  if (k < 1 || k > 8 || n_words < 0 || cluster < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bins = 1 << (2 * k);
  const int slice = ((bins + cluster - 1) / cluster + 3) / 4 * 4;
  const int64_t limit = window_limit(16 * static_cast<int64_t>(n_words), n_own, k);
  auto kernel = canonical ? hist_planes_cluster_kernel<true> : hist_planes_cluster_kernel<false>;
  auto* a = static_cast<int32_t*>(acc);
  return static_cast<int>(launch_cluster(
      kernel, (limit + 15) / 16, bins, cluster, slice, a, static_cast<cudaStream_t>(stream),
      static_cast<const uint32_t*>(words_le), static_cast<const uint32_t*>(inval_be),
      static_cast<int64_t>(n_words), limit, k, bins, slice, a));
}

// data: u8 bases [n] (mask null), or the packed batch: data u8 [n/4], mask
// u8 [n/8].
extern "C" int kv_pair_small(const void* data, const void* mask, long long n,
                             long long n_own, int k, int canonical, int bins, void* acc,
                             void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kSmallBins || (mask && n % 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* d = static_cast<const uint8_t*>(data);
  const int64_t limit = window_limit(n, n_own, k);
  const int starts = mask ? 64 : 16;
  const int64_t mis = mask ? 0 : static_cast<int64_t>(reinterpret_cast<uintptr_t>(d) & 15);
  const int64_t chunks = (limit + mis + starts - 1) / starts;
  auto kernel = mask ? (canonical ? pair_small_kernel<true, true> : pair_small_kernel<false, true>)
                     : (canonical ? pair_small_kernel<true, false>
                                  : pair_small_kernel<false, false>);
  const int bytes = (bins + 1) / 2 * kPairThreads * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPairThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (chunks + kPairThreads - 1) / kPairThreads;
  const int64_t cap = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * sm_count();
  const int64_t per_thread = kPairMaxStarts / starts;
  const int64_t least = (chunks + kPairThreads * per_thread - 1) / (kPairThreads * per_thread);
  int64_t blocks = want < cap ? want : cap;
  if (blocks < least) blocks = least;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kPairThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(d, static_cast<const uint8_t*>(mask), n, limit,
                                                k, bins, static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}
