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
// atomic add per window.
//   K6, and K8 up to 65,536 bins, keep ONE histogram per thread block
//   cluster in distributed shared memory: block r of a cluster of C blocks
//   holds bins [r*S, (r+1)*S) (S = ceil(bins / C), padded to 4 bins), and a
//   window's count goes to block code / S with a shared-memory atomic,
//   local or remote (cluster.map_shared_rank). C = 1 up to 32,768 bins
//   (128 KB); above, C comes from the wrapper (histogram_cuda.u8_plan: 2 at
//   65,536 bins, which ran faster on the card than 4). The blocks of a
//   cluster read different bases, so the grid reads the batch once and
//   encodes each window once. A thread owns 16 consecutive window starts:
//   one 16-byte load of its bases, the k - 1 halo bases from the next
//   lane's load (__shfl_down_sync), and rolled codes, reverse complements
//   and valid-run lengths, one base a step. A run of one code among a
//   thread's windows (a one-base run) is held and added once. Warp
//   aggregation (__match_any_sync before each atomic) was tried and cost
//   more on the card than the atomics it saved, on random and on run-rich
//   streams alike. Blocks of 1,024 threads; the grid holds as many
//   clusters as the card runs at once (cudaOccupancyMaxActiveClusters).
//   cluster.sync() after the zeroing (no remote add reaches an unzeroed
//   bin) and before the flush (no block exits while a peer adds into it);
//   each block then adds its slice into acc with cp.reduce.async.bulk
//   (16-byte aligned runs, a multiple of 16 bytes; the last < 4 bins with
//   atomics). The core (ClusterHist) is a set of device functions K5 can
//   take over.
//   K5 forms a window from the two plane words its start word and the next
//   hold (k <= 8 spans at most two), one thread per word, 16 windows each;
//   its bins are split across blockIdx.y into 64 KB slices, each slice's
//   blocks re-reading the planes.
//   K7 keeps one sub-histogram per warp and aggregates the lanes of a warp
//   that hold one code (__match_any_sync) into one add.
//   K8 above 65,536 bins adds each window straight into acc in device memory
//   (4^11 int32 bins are 16 MB, which stay in L2).
//
// Bound: the bytes. A window costs 1 B of u8 input (K6-K8) or 0.5 B of
// planes (K5) and one integer add; the histogram is read and written once.
// At one 16 Mbase batch that is 16.8 MB (8.4 MB for K5), a few microseconds
// at 3.35 TB/s. K6 reads each base once and spends about one byte
// operation a window on its code; the shared and remote atomics, one per
// window (or per run of one code in a thread), and the flush of C*S bins
// per cluster are what keep it above the bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceBins = 16384;   // 64 KB of int32 per block
constexpr int kSmallBins = 64;      // K7's widest histogram
constexpr int kSlicedMaxBins = 65536;
constexpr int kU8Threads = 1024;         // K6's block
constexpr int kMaxClusterSlice = 32768;  // 128 KB of int32 per block
constexpr int kFlushChunk = 4096;        // bytes per bulk reduce
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

// The histogram of a cluster (K6, K8 up to 65,536 bins): bins [r*S, (r+1)*S)
// live in the shared memory of the cluster's block r.
struct ClusterHist {
  int32_t* local;  // this block's slice, in its shared memory
  uint32_t slice;  // S, a multiple of 4
  uint32_t rank;   // this block's rank in its cluster
  uint32_t size;   // C, blocks in the cluster

  // Zero this block's slice, then wait for the whole cluster, so that no
  // remote add reaches a bin before its block has zeroed it.
  __device__ __forceinline__ void begin() const {
    uint4* h4 = reinterpret_cast<uint4*>(local);
    for (uint32_t i = threadIdx.x; i < slice / 4; i += blockDim.x) {
      h4[i] = make_uint4(0, 0, 0, 0);
    }
    cg::this_cluster().sync();
  }

  // Add n to bin `code` (< C*S), in whichever block of the cluster holds it.
  __device__ __forceinline__ void add(uint32_t code, int32_t n) const {
    const uint32_t r = size == 1 ? 0u : code / slice;
    int32_t* bin = local + (code - r * slice);
    if (r == rank) {
      atomicAdd(bin, n);
    } else {
      atomicAdd(cg::this_cluster().map_shared_rank(bin, r), n);
    }
  }

  // Wait for the cluster (every remote add has landed and no peer still
  // adds into this block), then add this block's bins [rank*S, ...) below
  // `bins` into acc: whole 16-byte runs by bulk reduces, the last < 4 bins
  // by atomics. acc is 16-byte aligned.
  __device__ __forceinline__ void flush(int32_t* __restrict__ acc, int bins) const {
    cg::this_cluster().sync();
    const int64_t b0 = static_cast<int64_t>(rank) * slice;
    const int64_t left = bins - b0;
    const int n = left < static_cast<int64_t>(slice) ? static_cast<int>(left) : static_cast<int>(slice);
    if (n <= 0) return;
    const int body = n & ~3;
    // Make the generic-proxy adds visible to the bulk copy engine.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int bytes = body * static_cast<int>(sizeof(int32_t));
    const int chunks = (bytes + kFlushChunk - 1) / kFlushChunk;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int off = c * kFlushChunk;
      const int len = bytes - off < kFlushChunk ? bytes - off : kFlushChunk;
      const uint32_t src = static_cast<uint32_t>(
          __cvta_generic_to_shared(reinterpret_cast<const char*>(local) + off));
      const char* dst = reinterpret_cast<const char*>(acc + b0) + off;
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 [%0], [%1], %2;"
          :: "l"(dst), "r"(src), "r"(len) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    for (int i = body + static_cast<int>(threadIdx.x); i < n; i += blockDim.x) {
      if (local[i]) atomicAdd(acc + b0 + i, local[i]);
    }
    // The block's shared memory must outlive the bulk reads of it.
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
};

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

// K6, and K8 up to 65,536 bins: one histogram per cluster, in distributed
// shared memory. n bases; limit = min(n_own, n - k + 1) >= 0; k <= 15.
__global__ void __launch_bounds__(kU8Threads, 1)
hist_u8_cluster_kernel(const uint8_t* __restrict__ bases, int64_t n, int64_t limit,
                       int k, bool canonical, int bins, int slice,
                       int32_t* __restrict__ acc) {
  extern __shared__ uint4 hist4[];
  const cg::cluster_group cluster = cg::this_cluster();
  const ClusterHist h{reinterpret_cast<int32_t*>(hist4), static_cast<uint32_t>(slice),
                      cluster.block_rank(), cluster.num_blocks()};
  h.begin();

  // Chunks of 16 aligned bytes; chunk c holds the window starts
  // q = 16c - mis + j, j < 16.
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(bases) & 15);
  const uint8_t* abase = bases - mis;
  const int64_t end = n + mis;
  const int64_t n_chunks = (limit + mis + 15) >> 4;
  const uint32_t mask = (1u << (2 * k)) - 1;
  const int rc_shift = 2 * (k - 1);
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // The loop bound is the warp's first chunk, so all 32 lanes take every
  // step together, as the halo shuffle needs.
  for (int64_t c0 = warp * 32; c0 < n_chunks; c0 += stride) {
    const int64_t c = c0 + lane;
    const uint4 cur = stream_chunk(abase, c, mis, end);
    uint4 nxt;
    nxt.x = __shfl_down_sync(0xFFFFFFFFu, cur.x, 1);
    nxt.y = __shfl_down_sync(0xFFFFFFFFu, cur.y, 1);
    nxt.z = __shfl_down_sync(0xFFFFFFFFu, cur.z, 1);
    nxt.w = __shfl_down_sync(0xFFFFFFFFu, cur.w, 1);
    if (lane == 31) nxt = stream_chunk(abase, c + 1, mis, end);
    const uint32_t w[8] = {cur.x, cur.y, cur.z, cur.w, nxt.x, nxt.y, nxt.z, nxt.w};
    const int64_t q0 = 16 * c - mis - (k - 1);  // the window ending at byte i starts at q0 + i
    uint32_t code = 0, rc = 0;
    int run = 0;
    // A run of equal codes among the thread's windows (a one-base run)
    // is held and added once.
    uint32_t held_code = 0;
    int32_t held = 0;
#pragma unroll
    for (int i = 0; i < 31; ++i) {
      if (i >= 15 + k) break;  // 16 starts and their k - 1 halo bases
      const uint32_t b = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      run = b < 4 ? run + 1 : 0;
      code = ((code << 2) | (b & 3)) & mask;
      rc = (rc >> 2) | ((3u - (b & 3)) << rc_shift);
      if (i >= k - 1) {
        const int64_t q = q0 + i;
        const uint32_t key = canonical ? min(code, rc) : code;
        if (run >= k && q >= 0 && q < limit && key < static_cast<uint32_t>(bins)) {
          if (held && key == held_code) {
            ++held;
          } else {
            if (held) h.add(held_code, held);
            held_code = key;
            held = 1;
          }
        }
      }
    }
    if (held) h.add(held_code, held);
  }
  h.flush(acc, bins);
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

// The cluster launch of K6 / K8's sliced route: `cluster` blocks of
// `slice` bins each (a multiple of 4, cluster * slice >= bins), as many
// clusters as the card runs at once, at most one chunk of 16 window starts
// a thread. acc must be 16-byte aligned (the bulk reduces).
cudaError_t launch_u8_cluster(const uint8_t* bases, int64_t n, int64_t limit, int k,
                              bool canonical, int bins, int cluster, int slice,
                              int32_t* acc, cudaStream_t s) {
  if ((cluster != 1 && cluster != 2 && cluster != 4) || slice < 4 ||
      slice % 4 || slice > kMaxClusterSlice ||
      static_cast<int64_t>(cluster) * slice < bins ||
      reinterpret_cast<uintptr_t>(acc) % 16) {
    return cudaErrorInvalidValue;
  }
  const int bytes = slice * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      hist_u8_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kU8Threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, hist_u8_cluster_kernel, &cfg);
  if (err != cudaSuccess) return err;
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(bases) & 15);
  const int64_t threads = (limit + mis + 15) / 16;
  const int64_t per_cluster = static_cast<int64_t>(cluster) * kU8Threads;
  int64_t clusters = (threads + per_cluster - 1) / per_cluster;
  if (clusters > resident) clusters = resident;
  if (clusters < 1) clusters = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  return cudaLaunchKernelEx(&cfg, hist_u8_cluster_kernel, bases, static_cast<int64_t>(n),
                            limit, k, canonical, bins, slice, acc);
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

// K6. bases: u8 [n]; acc: int32 [bins], 16-byte aligned; bins a power of
// two <= 65,536; `cluster` blocks of `slice` bins (histogram_cuda.u8_plan).
extern "C" int kp_hist_u8(const void* bases, long long n, long long n_own, int k,
                          int canonical, int bins, int cluster, int slice, void* acc,
                          void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kSlicedMaxBins || (bins & (bins - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_u8_cluster(
      static_cast<const uint8_t*>(bases), n, window_limit(n, n_own, k), k,
      canonical != 0, bins, cluster, slice, static_cast<int32_t*>(acc),
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

// K8. bases: u8 [n]; acc: int32 [bins]; 1 <= bins <= 4^12. Up to 65,536
// bins it launches K6's kernel (`cluster`, `slice` as for K6, acc 16-byte
// aligned); above, `cluster` and `slice` are not read.
extern "C" int kp_hist_u8_any(const void* bases, long long n, long long n_own,
                              int k, int canonical, int bins, int cluster, int slice,
                              void* acc, void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kMaxDenseBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const uint8_t*>(bases);
  auto* a = static_cast<int32_t*>(acc);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t limit = window_limit(n, n_own, k);
  if (bins <= kSlicedMaxBins) {
    return static_cast<int>(
        launch_u8_cluster(b, n, limit, k, canonical != 0, bins, cluster, slice, a, s));
  }
  // No flush here, so the grid may be as wide as the card holds.
  const int64_t want = (limit + kThreads - 1) / kThreads;
  const int64_t cap = 8 * static_cast<int64_t>(sm_count());
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  hist_u8_global_kernel<<<blocks, kThreads, 0, s>>>(b, limit, k, canonical != 0,
                                                    bins, a);
  return static_cast<int>(cudaGetLastError());
}
