// Dense k-mer histograms (K5-K8) for Hopper, sm_90a.
//
// Replace the TPU kernels of dna_kmeres_parallel_tpu/ops/histogram_pallas.py:
//   K5 kp_hist_planes        histogram_bp2_packed_pallas (_make_hist_bp2_packed_kernel)
//   K6 kp_hist_u8            histogram_bp2_pallas (_make_hist_bp2_kernel, _bp2_accumulate)
//   K7 kp_hist_u8_small      histogram_bitplane_pallas (_make_hist_bitplane_kernel);
//      kp_hist_packed_small  the same kernel together with the unpack the JAX
//                            engine fuses before it (models/engine.py
//                            _count_batch_acc_packed, ops/encode.py unpack_stream)
//   K8 kp_hist_u8_any        histogram_pallas (_make_hist2d_fused_kernel)
//
// Every entry computes one function and ADDS it into a caller-given int32
// accumulator acc[bins]: acc[c] += the number of windows starting at p with
// p < n_own, p + k <= n (n bases in the input), all k bases valid, and
// code == c, where code is the window's big-endian 2-bit code, or the
// smaller of it and its reverse complement with canonical set. Codes >= bins
// are dropped. Integer adds make the counts exact in any order.
//
// Inputs:
//   K5  two u32 planes of n_words words, 16 bases per word (K1's wire
//       format, csrc/encode_packed.cu): words_le holds base j of a word at
//       bits 2j; inval_be holds digit 11 at bits 30-2j where base j is
//       invalid. k <= 8 and bins = 4^k.
//   K6  a u8 base stream (0..3 valid, anything else invalid); bins a power
//       of two <= 65,536.
//   K7  the same stream (kp_hist_u8_small), or the 2-bit packed batch that
//       native.pack_2bit_native ships (kp_hist_packed_small): data u8
//       [n/4], base i at bits 2(i % 4) of byte i / 4; mask u8 [n/8], bit
//       i % 8 of byte i / 8 set where base i is valid. bins <= 64 (k <= 3
//       on the engine's route; any k <= 15, as histogram_pallas routes).
//   K8  the u8 stream; any bins from 1 to 4^12.
//
// Design. The TPU kernels build one-hot planes and reduce them on the MXU
// because a TPU has no scatter; on the card a histogram is an add per
// window into shared memory.
//   Windows. A thread owns a chunk of consecutive window starts: 16 from
//   one 16-byte load of u8 bases (K6-K8), 16 from one word of each plane
//   (K5), 64 from 16 bytes of packed data and 8 of mask (K7 packed). It
//   takes the halo from the next chunk (the next lane's load,
//   __shfl_down_sync). K5 and K7 count each run of 16 starts from two words
//   (count16): the run's 32 positions as 2-bit digits and their 32 validity
//   bits (the u8 bytes turned into both with a multiply each per 4 bytes).
//   A window's validity is the AND of k shifted validity words; its
//   big-endian code is one funnel shift of the digits reversed once, its
//   reverse complement one of the complemented digits; no step waits on
//   the one before. K6 and K8 roll codes, reverse complements and
//   valid-run lengths one base a step. Where the histogram is shared by
//   threads (K5, K6, K8), a run of one code among a thread's windows (a
//   one-base run) is held and added once. Warp aggregation
//   (__match_any_sync before each add) cost more on the card than the adds
//   it saved.
//   K6, K8 up to 65,536 bins, and K5 up to 16,384 bins keep ONE histogram
//   per thread block cluster in distributed shared memory (ClusterHist):
//   block r of a cluster of C blocks holds bins [r*S, (r+1)*S) (S =
//   ceil(bins / C), padded to 4 bins), and a window's count goes to block
//   code / S with a shared-memory atomic, local or remote
//   (cluster.map_shared_rank). C = 1 up to 32,768 bins (128 KB); above, C
//   comes from the wrapper (histogram_cuda.u8_plan). The blocks of a
//   cluster read different bases, so the grid reads the batch once. Blocks
//   of 1,024 threads; the grid holds as many clusters as the card runs at
//   once (cudaOccupancyMaxActiveClusters). cluster.sync() after the zeroing
//   and before the flush; each block then adds its slice into acc with
//   cp.reduce.async.bulk (16-byte aligned runs; the last < 4 bins with
//   atomics).
//   K5 at 65,536 bins keeps the whole histogram in each block,
//   one block of 1,024 threads per SM, as 16-bit halves of 128 KB of u32
//   words (HalfHist), so that no add is remote. No half can carry into its
//   neighbour: every 32,768 windows of a block (two steps of its 1,024
//   threads x 16 windows) the block stops and moves 2^15 into acc out of
//   every half that has reached it, so a half that starts a round below
//   2^15 ends it below 2^16. The final flush widens the halves into a
//   32 KB int32 stage and bulk-reduces it into acc.
//   K7 (at most 64 bins) gives every thread its own counters, laid out
//   cnt[bin * threads + thread] in shared memory, so that lane i always
//   reaches bank i: a window is a plain load, add and store, with no
//   atomic and no conflict. 64 bins x 768 threads x 4 B is 192 KB, one
//   block an SM (as many as the card holds at once,
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor). A thread's counter
//   holds at most the windows it took (< 2^31). At the end the block sums
//   each bin over its threads and adds it into acc with one atomic. One
//   block of 768 threads an SM ran faster on the card than one of 512 or
//   three of 256, and 32-bit counters faster than 16-bit pairs in blocks of
//   1,024 (scripts/hist_variants_probe.py). The packed entry reads 0.375 B
//   a base, and no unpacked stream is made.
//   K8 above 65,536 bins adds each window straight into acc in device memory
//   (4^11 int32 bins are 16 MB, which stay in L2).
//
// Bound: the bytes. A window costs 1 B of u8 input (K6-K8), 0.5 B of planes
// (K5) or 0.375 B packed (K7) and one integer add; the histogram is read
// and written once. At one 16 Mbase batch that is a few microseconds at
// 3.35 TB/s. What keeps each kernel above it: K5 and K6 the shared (and,
// in clusters, remote) atomics, one per window or run, and the flush of
// every block's histogram; K7 the window arithmetic itself, about a dozen
// integer operations a window.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "planes.cuh"
#include "windows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // K8's global route
constexpr int kSmallThreads = 768;       // K7's block: 192 KB of counters at 64 bins
// The most window starts a K7 thread takes in one launch, so that no
// counter passes its width.
constexpr int64_t kSmallMaxStarts = (int64_t{1} << 31) - 1;
constexpr int kSmallBins = 64;           // K7's widest histogram
constexpr int kSlicedMaxBins = 65536;
constexpr int kU8Threads = 1024;         // K5's and K6's block
constexpr int kMaxClusterSlice = 32768;  // 128 KB of int32 per block
constexpr int kFlushChunk = 4096;        // bytes per bulk reduce
constexpr int kMaxDenseBins = 1 << 24;   // 4^12
constexpr int kHalfBins = 65536;         // HalfHist: 128 KB of 16-bit halves
constexpr int kStageBins = 8192;         // HalfHist's flush stage: 32 KB of int32
// HalfHist's windows between spills: at most 2^15, so no half passes 2^16 - 1
constexpr int kHalfRoundSteps = 2;
static_assert(kHalfRoundSteps * kU8Threads * 16 <= 32768, "a round must stay below a carry");

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

// Count the 16 window starts of plane word w (K5): its bases and the next
// word's for the halo; the zero word past the plane's end is never read as
// a counted window's base.
template <bool kCanonical, typename Add>
__device__ __forceinline__ void count_planes(const uint32_t* __restrict__ words_le,
                                             const uint32_t* __restrict__ inval_be,
                                             int64_t n_words, int64_t w, int64_t limit, int k,
                                             uint32_t bins, Add& add) {
  const uint64_t d = static_cast<uint64_t>(__ldg(words_le + w)) |
                     (static_cast<uint64_t>(word_or_zero(words_le, w + 1, n_words)) << 32);
  const uint32_t v = valid16(__ldg(inval_be + w)) |
                     (w + 1 < n_words ? valid16(__ldg(inval_be + w + 1)) << 16 : 0u);
  count16<kCanonical>(d, v, 16 * w, limit, k, bins, add);
}

// Adds a run of one key among a thread's windows into a shared histogram
// once (a one-base run).
template <typename Hist>
struct Held {
  const Hist& h;
  uint32_t key = 0;
  int32_t n = 0;

  __device__ __forceinline__ void operator()(uint32_t k) {
    if (n && k == key) {
      ++n;
      return;
    }
    if (n) h.add(key, n);
    key = k;
    n = 1;
  }
  __device__ __forceinline__ void done() {
    if (n) h.add(key, n);
  }
};

// The histogram of a cluster (K5 up to 32,768 bins, K6, K8 up to 65,536
// bins): bins [r*S, (r+1)*S) live in the shared memory of the cluster's
// block r.
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

// K5's whole histogram of 65,536 bins in one block: bin 2j in the low 16
// bits of words[j], bin 2j + 1 in the high 16 bits.
struct HalfHist {
  uint32_t* words;  // kHalfBins / 2 words
  int32_t* stage;   // kStageBins int32 for the flush, 16-byte aligned

  __device__ __forceinline__ void begin() const {
    uint4* w4 = reinterpret_cast<uint4*>(words);
    for (int i = threadIdx.x; i < kHalfBins / 8; i += blockDim.x) {
      w4[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
  }

  // n <= 16 (a held run of one thread's windows).
  __device__ __forceinline__ void add(uint32_t code, int32_t n) const {
    atomicAdd(words + (code >> 1), static_cast<uint32_t>(n) << ((code & 1) << 4));
  }

  static __device__ __forceinline__ uint32_t spill_word(uint32_t e, int32_t* acc) {
    if (e & 0x8000u) atomicAdd(acc, 0x8000);
    if (e & 0x80000000u) atomicAdd(acc + 1, 0x8000);
    return e & 0x7FFF7FFFu;
  }

  // Between two spills the block adds at most 2^15 counts, so a half that
  // was below 2^15 after the last spill is now at most 2^16 - 1: no carry.
  // Move 2^15 into acc out of every half that has reached it; every half
  // is then below 2^15 again. All threads of the block call it together.
  __device__ __forceinline__ void spill(int32_t* __restrict__ acc) const {
    __syncthreads();
    uint4* w4 = reinterpret_cast<uint4*>(words);
    for (int i = threadIdx.x; i < kHalfBins / 8; i += blockDim.x) {
      const uint4 v = w4[i];
      if ((v.x | v.y | v.z | v.w) & 0x80008000u) {
        int32_t* a = acc + 8 * i;
        w4[i] = make_uint4(spill_word(v.x, a), spill_word(v.y, a + 2),
                           spill_word(v.z, a + 4), spill_word(v.w, a + 6));
      }
    }
    __syncthreads();
  }

  // Widen the halves, kStageBins at a time, into the int32 stage and
  // bulk-reduce it into acc (16-byte aligned).
  __device__ __forceinline__ void flush(int32_t* __restrict__ acc) const {
    constexpr int kChunks = kStageBins * 4 / kFlushChunk;
    for (int b0 = 0; b0 < kHalfBins; b0 += kStageBins) {
      // Every add has landed (first pass), and the stage's last bulk reads
      // are done (the issuing threads waited for them).
      __syncthreads();
      int2* s2 = reinterpret_cast<int2*>(stage);
      for (int j = threadIdx.x; j < kStageBins / 2; j += blockDim.x) {
        const uint32_t e = words[b0 / 2 + j];
        s2[j] = make_int2(static_cast<int32_t>(e & 0xFFFFu), static_cast<int32_t>(e >> 16));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x < kChunks) {
        const int off = threadIdx.x * kFlushChunk;
        const uint32_t src = static_cast<uint32_t>(
            __cvta_generic_to_shared(reinterpret_cast<const char*>(stage) + off));
        const char* dst = reinterpret_cast<const char*>(acc + b0) + off;
        asm volatile(
            "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 [%0], [%1], %2;"
            :: "l"(dst), "r"(src), "r"(kFlushChunk) : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    }
  }
};

// K7's per-thread counters: bin b of thread t in word b * kSmallThreads +
// t. Lane i of a warp always reaches bank i.
__device__ __forceinline__ void small_begin(uint32_t* cnt, int bins) {
  uint4* c4 = reinterpret_cast<uint4*>(cnt);
  for (int i = threadIdx.x; i < bins * kSmallThreads / 4; i += kSmallThreads) {
    c4[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
}

// Sum each bin over the block's threads (warp w takes bins w, w + 32, ...)
// and add it into acc.
__device__ __forceinline__ void small_flush(const uint32_t* cnt, int bins,
                                            int32_t* __restrict__ acc) {
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < bins; b += kSmallThreads / 32) {
    const uint32_t* row = cnt + b * kSmallThreads + lane;
    uint32_t s = 0;
#pragma unroll 8
    for (int t = 0; t < kSmallThreads; t += 32) s += row[t];
    s = __reduce_add_sync(0xFFFFFFFFu, s);
    if (lane == 0 && s) atomicAdd(acc + b, static_cast<int32_t>(s));
  }
}

// The 64 bases of packed chunk c: data words d (16 bases each, base j of a
// word at bits 2j) and mask words m (32 bases each, bit j set where base j
// is valid). Bases at or past n read as invalid. `vec`: the data are
// 16-byte and the mask 8-byte aligned.
__device__ __forceinline__ void packed_chunk(const uint8_t* __restrict__ data,
                                             const uint8_t* __restrict__ mask, int64_t c,
                                             int64_t n, bool vec, uint32_t (&d)[4],
                                             uint32_t (&m)[2]) {
  if (vec && 64 * c + 64 <= n) {
    const uint4 dv = __ldg(reinterpret_cast<const uint4*>(data) + c);
    const uint2 mv = __ldg(reinterpret_cast<const uint2*>(mask) + c);
    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
    m[0] = mv.x; m[1] = mv.y;
    return;
  }
  const int64_t nd = n >> 2, nm = n >> 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t a = 16 * c + 4 * j + b;
      word |= (a < nd ? static_cast<uint32_t>(__ldg(data + a)) : 0u) << (8 * b);
    }
    d[j] = word;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t a = 8 * c + 4 * j + b;
      word |= (a < nm ? static_cast<uint32_t>(__ldg(mask + a)) : 0u) << (8 * b);
    }
    m[j] = word;
  }
}

// K5 through a cluster histogram. n_words plane words; limit = the number
// of window starts to count, min(n_own, 16 * n_words - k + 1) >= 0.
template <bool kCanonical>
__global__ void __launch_bounds__(kU8Threads, 1)
hist_planes_cluster_kernel(const uint32_t* __restrict__ words_le,
                           const uint32_t* __restrict__ inval_be, int64_t n_words,
                           int64_t limit, int k, int bins, int slice,
                           int32_t* __restrict__ acc) {
  extern __shared__ uint4 planes4[];
  const cg::cluster_group cluster = cg::this_cluster();
  const ClusterHist h{reinterpret_cast<int32_t*>(planes4), static_cast<uint32_t>(slice),
                      cluster.block_rank(), cluster.num_blocks()};
  h.begin();
  const int64_t n_start_words = (limit + 15) >> 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < n_start_words; w += stride) {
    Held<ClusterHist> held{h};
    count_planes<kCanonical>(words_le, inval_be, n_words, w, limit, k,
                             static_cast<uint32_t>(bins), held);
    held.done();
  }
  h.flush(acc, bins);
}

// K5 at 65,536 bins through one HalfHist per block, one block per SM.
template <bool kCanonical>
__global__ void __launch_bounds__(kU8Threads, 1)
hist_planes_half_kernel(const uint32_t* __restrict__ words_le,
                        const uint32_t* __restrict__ inval_be, int64_t n_words,
                        int64_t limit, int32_t* __restrict__ acc) {
  constexpr int k = 8;
  extern __shared__ uint4 half4[];
  const HalfHist h{reinterpret_cast<uint32_t*>(half4),
                   reinterpret_cast<int32_t*>(half4 + kHalfBins / 8)};
  h.begin();
  const int64_t n_start_words = (limit + 15) >> 4;
  // Steps of the block's 1,024 words, taken by all its threads together
  // (the spill's barriers): step t covers words from (t * grid + block) *
  // 1,024 on.
  for (int64_t t = 0;; ++t) {
    const int64_t w0 = (t * gridDim.x + blockIdx.x) * static_cast<int64_t>(kU8Threads);
    if (w0 >= n_start_words) break;
    const int64_t w = w0 + threadIdx.x;
    if (w < n_start_words) {
      Held<HalfHist> held{h};
      count_planes<kCanonical>(words_le, inval_be, n_words, w, limit, k,
                               static_cast<uint32_t>(kHalfBins), held);
      held.done();
    }
    if (t % kHalfRoundSteps == kHalfRoundSteps - 1) h.spill(acc);
  }
  h.flush(acc);
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
    uint32_t w[8];
    u8_chunk_pair(abase, c, mis, end, w);
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

// K7 from the u8 stream: per-thread counters. n bases; limit as K6's.
template <bool kCanonical>
__global__ void __launch_bounds__(kSmallThreads)
hist_u8_small_kernel(const uint8_t* __restrict__ bases, int64_t n, int64_t limit, int k,
                     int bins, int32_t* __restrict__ acc) {
  extern __shared__ uint4 small4[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(small4);
  small_begin(cnt, bins);
  uint32_t* mine = cnt + threadIdx.x;
  auto add = [&](uint32_t key) { mine[key * kSmallThreads] += 1u; };
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(bases) & 15);
  const uint8_t* abase = bases - mis;
  const int64_t end = n + mis;
  const int64_t n_chunks = (limit + mis + 15) >> 4;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c0 = warp * 32; c0 < n_chunks; c0 += stride) {
    const int64_t c = c0 + lane;
    uint32_t w[8];
    u8_chunk_pair(abase, c, mis, end, w);
    count_u8<kCanonical>(w, 16 * c - mis, limit, k, static_cast<uint32_t>(bins), add);
  }
  small_flush(cnt, bins, acc);
}

// K7 from the packed batch: per-thread counters, 64 window starts a chunk.
// n bases (4 per data byte, 8 per mask byte); limit = min(n_own, n - k + 1).
template <bool kCanonical>
__global__ void __launch_bounds__(kSmallThreads)
hist_packed_small_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ mask,
                         int64_t n, int64_t limit, int k, int bins,
                         int32_t* __restrict__ acc) {
  extern __shared__ uint4 packed4[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(packed4);
  small_begin(cnt, bins);
  uint32_t* mine = cnt + threadIdx.x;
  auto add = [&](uint32_t key) { mine[key * kSmallThreads] += 1u; };
  const bool vec = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  const int64_t n_chunks = (limit + 63) >> 6;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // The loop bound is the warp's first chunk: all lanes shuffle together.
  for (int64_t c0 = warp * 32; c0 < n_chunks; c0 += stride) {
    const int64_t c = c0 + lane;
    uint32_t cd[4], cm[2];
    packed_chunk(data, mask, c, n, vec, cd, cm);
    // The halo: the first data and mask words of chunk c + 1.
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
    // Four runs of 16 starts: run r reads positions 16r .. 16r + 31.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint64_t dr = d[r] | (static_cast<uint64_t>(d[r + 1]) << 32);
      const uint32_t vr = __funnelshift_r(m[r / 2], m[r / 2 + 1], 16 * (r & 1));
      count16<kCanonical>(dr, vr, 64 * c + 16 * r, limit, k, static_cast<uint32_t>(bins), add);
    }
  }
  small_flush(cnt, bins, acc);
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

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

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

// Launch a ClusterHist kernel: `cluster` blocks of kU8Threads threads and
// `slice` bins each (a multiple of 4, cluster * slice >= bins), as many
// clusters as the card runs at once and no more than `threads` threads
// need. acc must be 16-byte aligned (the bulk reduces).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int64_t threads, int bins,
                           int cluster, int slice, const int32_t* acc, cudaStream_t s,
                           Args... args) {
  if ((cluster != 1 && cluster != 2 && cluster != 4) || slice < 4 ||
      slice % 4 || slice > kMaxClusterSlice ||
      static_cast<int64_t>(cluster) * slice < bins ||
      reinterpret_cast<uintptr_t>(acc) % 16) {
    return cudaErrorInvalidValue;
  }
  const int bytes = slice * static_cast<int>(sizeof(int32_t));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return err;
  const int64_t per_cluster = static_cast<int64_t>(cluster) * kU8Threads;
  int64_t clusters = (threads + per_cluster - 1) / per_cluster;
  if (clusters > resident) clusters = resident;
  if (clusters < 1) clusters = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// K6 / K8's sliced route: chunks of 16 window starts a thread.
cudaError_t launch_u8_cluster(const uint8_t* bases, int64_t n, int64_t limit, int k,
                              bool canonical, int bins, int cluster, int slice,
                              int32_t* acc, cudaStream_t s) {
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(bases) & 15);
  const int64_t threads = (limit + mis + 15) / 16;
  return launch_cluster(hist_u8_cluster_kernel, threads, bins, cluster, slice, acc, s, bases,
                        n, limit, k, canonical, bins, slice, acc);
}

// K7: as many blocks as the card holds at once and no more than `chunks`
// (of `starts` window starts each) need, but enough that no thread takes
// more than kSmallMaxStarts starts.
template <typename... Params, typename... Args>
cudaError_t launch_small(void (*kernel)(Params...), int64_t chunks, int starts, int bins,
                         cudaStream_t s, Args... args) {
  const int bytes = bins * kSmallThreads * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSmallThreads, bytes);
  if (err != cudaSuccess) return err;
  const int64_t want = (chunks + kSmallThreads - 1) / kSmallThreads;
  const int64_t cap = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * sm_count();
  // A thread takes at most ceil(chunks / (blocks * kSmallThreads)) chunks.
  const int64_t per_thread = kSmallMaxStarts / starts;
  const int64_t least = (chunks + kSmallThreads * per_thread - 1) / (kSmallThreads * per_thread);
  int64_t blocks = want < cap ? want : cap;
  if (blocks < least) blocks = least;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kSmallThreads, bytes, s>>>(
      static_cast<Params>(args)...);
  return cudaGetLastError();
}

bool u8_args_ok(long long n, int k, int bins) {
  return n >= 0 && k >= 1 && k <= 15 && bins >= 1;
}

}  // namespace

// Each entry launches one kernel on `stream`, even when no window counts,
// and returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue for arguments it does not take, without launching.

// K5. words_le, inval_be: u32 [n_words]; acc: int32 [4^k], 16-byte aligned;
// 1 <= k <= 8. One HalfHist a block at k = 8, one block's ClusterHist
// below.
extern "C" int kp_hist_planes(const void* words_le, const void* inval_be,
                              long long n_words, long long n_own, int k,
                              int canonical, void* acc, void* stream) {
  if (k < 1 || k > 8 || n_words < 0 || reinterpret_cast<uintptr_t>(acc) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bins = 1 << (2 * k);
  const int64_t limit = window_limit(16 * static_cast<int64_t>(n_words), n_own, k);
  const auto* wl = static_cast<const uint32_t*>(words_le);
  const auto* ib = static_cast<const uint32_t*>(inval_be);
  auto* a = static_cast<int32_t*>(acc);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t threads = (limit + 15) / 16;
  if (bins < kHalfBins) {
    auto kernel = canonical ? hist_planes_cluster_kernel<true>
                            : hist_planes_cluster_kernel<false>;
    return static_cast<int>(launch_cluster(kernel, threads, bins, 1, bins, a, s, wl, ib,
                                           static_cast<int64_t>(n_words), limit, k, bins,
                                           bins, a));
  }
  auto kernel = canonical ? hist_planes_half_kernel<true> : hist_planes_half_kernel<false>;
  const int bytes = (kHalfBins / 2 + kStageBins) * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (threads + kU8Threads - 1) / kU8Threads;
  const int64_t cap = sm_count();
  const int64_t blocks = want < 1 ? 1 : (want < cap ? want : cap);
  kernel<<<static_cast<unsigned>(blocks), kU8Threads, bytes, s>>>(
      wl, ib, static_cast<int64_t>(n_words), limit, a);
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

// K7 from u8. bases: u8 [n]; acc: int32 [bins]; bins <= 64.
extern "C" int kp_hist_u8_small(const void* bases, long long n, long long n_own,
                                int k, int canonical, int bins, void* acc,
                                void* stream) {
  if (!u8_args_ok(n, k, bins) || bins > kSmallBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const uint8_t*>(bases);
  const int64_t limit = window_limit(n, n_own, k);
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(b) & 15);
  auto kernel = canonical ? hist_u8_small_kernel<true> : hist_u8_small_kernel<false>;
  return static_cast<int>(launch_small(kernel, (limit + mis + 15) / 16, 16, bins,
                                       static_cast<cudaStream_t>(stream), b,
                                       static_cast<int64_t>(n), limit, k, bins,
                                       static_cast<int32_t*>(acc)));
}

// K7 from the packed batch. data: u8 [n/4]; mask: u8 [n/8]; n a multiple of
// 8; acc: int32 [bins]; bins <= 64.
extern "C" int kp_hist_packed_small(const void* data, const void* mask, long long n,
                                    long long n_own, int k, int canonical, int bins,
                                    void* acc, void* stream) {
  if (!u8_args_ok(n, k, bins) || n % 8 || bins > kSmallBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t limit = window_limit(n, n_own, k);
  auto kernel = canonical ? hist_packed_small_kernel<true> : hist_packed_small_kernel<false>;
  return static_cast<int>(launch_small(kernel, (limit + 63) / 64, 64, bins,
                                       static_cast<cudaStream_t>(stream),
                                       static_cast<const uint8_t*>(data),
                                       static_cast<const uint8_t*>(mask),
                                       static_cast<int64_t>(n), limit, k, bins,
                                       static_cast<int32_t*>(acc)));
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
