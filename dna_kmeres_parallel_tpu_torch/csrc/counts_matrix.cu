// Per-sequence k-mer counts matrix (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/histogram_pallas.py::counts_matrix_pallas
//   (body _make_counts_kernel),
// and serves every dense bin count up to 4^15 with one entry. The TPU
// kernel stops at 1,024 bins: its one-hot compare costs bins per window,
// and above that the JAX engine counts with an XLA scatter, which computes
// the same function.
//
// Input: a u8 grid [S, L], row-major, one sequence per row, base codes
// 0..3 and anything else (0xFF pads a short row) invalid. Output: int32
// [S, bins], row-major: out[s, c] = the number of windows of row s whose
// k bases are all valid and whose code (the smaller of the code and its
// reverse complement with canonical set) is c. Codes >= bins are dropped.
// 1 <= k <= 15, so a code fits 30 bits; 1 <= bins <= 4^15.
//
// Design. The grid is read as one stream of aligned 16-byte chunks
// (windows.cuh, the window core K5 and K7 count with): a thread takes the
// 16 window starts of one chunk and the next chunk as its halo (the next
// lane's load), turns the bytes into 2-bit digits and validity bits with a
// multiply each per 4 bytes, and forms each window's code and reverse
// complement as funnel shifts (count16). A row starts at byte s*L, which
// need not be aligned: the chunks that cover a row also hold bytes of its
// neighbours, and count16 takes only the starts in [0, L - k + 1) of the
// row, whose windows never leave it. A chunk of 16 bytes of 0xFF (the
// padding of a short row) is skipped after one compare.
//   Work items. An item is a row, or a part of a row when rows are too few
//   to fill the card (or too long for the block route's 16-bit counters):
//   parts of one row add into an output zeroed first, with device-memory
//   atomics; a whole row is stored.
//   Up to 4,096 bins (k <= 6; the reference workload is k = 3): the warp
//   route. A warp takes an item; its 32 lanes take 32 consecutive chunks a
//   step (a row of 2,000 bases is 4 steps), and count into the warp's own
//   32-bit histogram in shared memory with shared atomics (256 B at 64
//   bins, so a block of 8 warps holds 8 rows at once and the card holds 64
//   warps an SM; 16 KB at 4,096 bins). The warp then stores its counts as
//   one row of the output. On the card these atomics beat per-lane
//   counters in K7's layout by about 20% at 64 bins (their flush reads 8 KB
//   a row, as much as the row's windows); more warps an SM (fewer
//   registers) ran as fast or up to 16% slower, and a halo shuffled as
//   digits in place of bytes tied. Above 64 bins the warp route beat the
//   block route 3.1x at 1,024 bins and 1.10x at 4,096 (the block route's
//   512 threads take a 2,000-base row's 125 chunks in one step, three
//   quarters of them idle) (scripts/counts_matrix_variants_probe.py).
//   Above 4,096 bins: the block route. A block takes an item and keeps its
//   histogram in shared memory as 16-bit halves (bin 2j in the low half of
//   word j, 2j + 1 in the high half; 128 KB at 4^8 bins), so that 65,536
//   bins fit one block and no bin slice re-reads the row. A half cannot
//   carry into its neighbour: an item holds at most kMaxPartChunks * 16 <
//   2^16 window starts. The flush widens two words into four int32 counts
//   and writes them as one 16-byte streaming store.
//   Above 65,536 bins (k = 9..15, the dense distances of mid k): the global
//   route. No histogram fits shared memory (4^9 bins are 1 MB a row), so
//   the C entry zeroes the output and every window adds one to its count
//   in device memory with an atomic. Items are taken as in the warp route
//   (rows split into parts of at least 256 chunks until 64 warps an SM
//   have work); parts of one row need nothing more, since every add is an
//   atomic. A row holds about L distinct codes among 4^k bins, so the
//   atomics seldom collide.
//
// Bound: the bytes. Each base is read once and each count written once:
// 1 B a base in, 4 B a bin out; the arithmetic is about a dozen integer
// operations a window. At k <= 3 the grid dominates; at k = 8 the output
// does (256 KB a row), and above it the zeroing of the output does (1 MB a
// row at k = 9), the atomics adding one transaction a valid window.

#include <cuda_runtime.h>

#include <cstdint>

#include "windows.cuh"

namespace {

constexpr int kWarpThreads = 256;  // the warp route's block: 8 items at once
constexpr int kWarpsPerBlock = kWarpThreads / 32;
constexpr int kBlockThreads = 512;  // the block route's block
constexpr int kWarpMaxBins = 4096;  // the warp route's widest histogram
constexpr int kMaxBins = 65536;    // the widest shared-memory histogram
constexpr int kMaxAnyBins = 1 << 30;  // 4^15: the global route's widest
// The most chunks an item of the block route takes: 65,520 window starts,
// so that no 16-bit half reaches 2^16.
constexpr int64_t kMaxPartChunks = 4095;
// The fewest chunks an item of the warp route takes when a row is split:
// 8 a lane.
constexpr int64_t kMinWarpPart = 256;

// Work item `item` of a launch of `parts` items a row, `per` chunks an
// item: row `row`, chunks [c0, c1) of the aligned stream; `row_lo` is the
// aligned byte index of the row's first base.
struct Item {
  int64_t row, row_lo, c0, c1;
};

__device__ __forceinline__ Item item_of(int64_t item, int64_t parts, int64_t per,
                                        int64_t L, int k, int64_t mis) {
  Item it;
  it.row = item / parts;
  const int64_t part = item - it.row * parts;
  it.row_lo = it.row * L + mis;
  if (L < k) {
    it.c0 = it.c1 = 0;
    return it;
  }
  const int64_t c_lo = it.row_lo >> 4;
  const int64_t c_end = ((it.row_lo + L - k) >> 4) + 1;  // past the last start's chunk
  it.c0 = c_lo + part * per;
  it.c1 = it.c0 + per < c_end ? it.c0 + per : c_end;
  return it;
}

// Count the windows that start in chunk c of an item (every lane of the
// warp calls it together, for the halo's shuffle).
template <bool kCanonical, typename Add>
__device__ __forceinline__ void count_chunk(const uint8_t* __restrict__ abase, int64_t c,
                                            const Item& it, int64_t mis, int64_t end,
                                            int64_t limit, int k, uint32_t bins, Add& add) {
  uint32_t w[8];
  u8_chunk_pair(abase, c, mis, end, w);
  if (c < it.c1 && (w[0] & w[1] & w[2] & w[3]) != 0xFFFFFFFFu) {
    count_u8<kCanonical>(w, 16 * c - it.row_lo, limit, k, bins, add);
  }
}

// The warp route's counters: one histogram per warp in shared memory,
// added into with shared atomics.
struct WarpHist {
  uint32_t* h;  // bins words
  int lane;

  __host__ __device__ static constexpr int words(int bins) { return bins; }
  __device__ __forceinline__ void zero(int bins) const {
    for (int b = lane; b < bins; b += 32) h[b] = 0;
  }
  __device__ __forceinline__ void add(uint32_t key) const { atomicAdd(h + key, 1u); }
  // The count of bin b (b % 32 == lane).
  __device__ __forceinline__ uint32_t total(int b) const { return h[b]; }
};

// Warp route: a warp per item, bins <= kWarpMaxBins.
template <bool kCanonical>
__global__ void __launch_bounds__(kWarpThreads)
counts_warp_kernel(const uint8_t* __restrict__ grid, int64_t L, int k, int bins,
                   int64_t items, int64_t parts, int64_t per, int64_t mis, int64_t end,
                   bool add_out, int32_t* __restrict__ out) {
  extern __shared__ uint4 warp_smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const WarpHist cnt{reinterpret_cast<uint32_t*>(warp_smem) + wib * WarpHist::words(bins), lane};
  auto add = [&](uint32_t key) { cnt.add(key); };
  const uint8_t* abase = grid - mis;
  const int64_t limit = L - k + 1;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + wib; item < items;
       item += n_warps) {
    const Item it = item_of(item, parts, per, L, k, mis);
    cnt.zero(bins);
    __syncwarp();
    // The loop bound is the warp's first chunk: all lanes shuffle together.
    for (int64_t c0 = it.c0; c0 < it.c1; c0 += 32) {
      count_chunk<kCanonical>(abase, c0 + lane, it, mis, end, limit, k,
                              static_cast<uint32_t>(bins), add);
    }
    __syncwarp();
    int32_t* o = out + it.row * bins;
    for (int b = lane; b < bins; b += 32) {
      const int32_t s = static_cast<int32_t>(cnt.total(b));
      if (!add_out) {
        o[b] = s;
      } else if (s) {
        atomicAdd(o + b, s);
      }
    }
    __syncwarp();
  }
}

// Block route: a block per item, bins > kWarpMaxBins, 16-bit halves in shared memory
// (`words` u32 words, a multiple of 4). `vec`: bins % 4 == 0 and out
// 16-byte aligned.
template <bool kCanonical>
__global__ void __launch_bounds__(kBlockThreads)
counts_block_kernel(const uint8_t* __restrict__ grid, int64_t L, int k, int bins, int words,
                    int64_t items, int64_t parts, int64_t per, int64_t mis, int64_t end,
                    bool add_out, bool vec, int32_t* __restrict__ out) {
  extern __shared__ uint4 block_smem[];
  uint32_t* h = reinterpret_cast<uint32_t*>(block_smem);
  auto add = [&](uint32_t key) { atomicAdd(h + (key >> 1), 1u << ((key & 1u) << 4)); };
  const uint8_t* abase = grid - mis;
  const int64_t limit = L - k + 1;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_of(item, parts, per, L, k, mis);
    for (int i = threadIdx.x; i < words / 4; i += kBlockThreads) {
      block_smem[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    // The loop bound is the block's first chunk: all lanes shuffle together.
    for (int64_t c0 = it.c0; c0 < it.c1; c0 += kBlockThreads) {
      count_chunk<kCanonical>(abase, c0 + threadIdx.x, it, mis, end, limit, k,
                              static_cast<uint32_t>(bins), add);
    }
    __syncthreads();
    int32_t* o = out + it.row * bins;
    if (vec && !add_out) {
      const uint2* h2 = reinterpret_cast<const uint2*>(h);
      int4* o4 = reinterpret_cast<int4*>(o);
      for (int j = threadIdx.x; j < bins / 4; j += kBlockThreads) {
        const uint2 e = h2[j];
        __stcs(o4 + j, make_int4(static_cast<int32_t>(e.x & 0xFFFFu),
                                 static_cast<int32_t>(e.x >> 16),
                                 static_cast<int32_t>(e.y & 0xFFFFu),
                                 static_cast<int32_t>(e.y >> 16)));
      }
    } else {
      for (int b = threadIdx.x; b < bins; b += kBlockThreads) {
        const int32_t s = static_cast<int32_t>((h[b >> 1] >> ((b & 1) << 4)) & 0xFFFFu);
        if (!add_out) {
          o[b] = s;
        } else if (s) {
          atomicAdd(o + b, s);
        }
      }
    }
    __syncthreads();
  }
}

// Global route: a warp per item, bins > kMaxBins, each window added with a
// device-memory atomic into an output zeroed first.
template <bool kCanonical>
__global__ void __launch_bounds__(kWarpThreads)
counts_global_kernel(const uint8_t* __restrict__ grid, int64_t L, int k, int bins,
                     int64_t items, int64_t parts, int64_t per, int64_t mis, int64_t end,
                     int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const uint8_t* abase = grid - mis;
  const int64_t limit = L - k + 1;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + wib; item < items;
       item += n_warps) {
    const Item it = item_of(item, parts, per, L, k, mis);
    int32_t* o = out + it.row * bins;
    auto add = [&](uint32_t key) { atomicAdd(o + key, 1); };
    // The loop bound is the warp's first chunk: all lanes shuffle together.
    for (int64_t c0 = it.c0; c0 < it.c1; c0 += 32) {
      count_chunk<kCanonical>(abase, c0 + lane, it, mis, end, limit, k,
                              static_cast<uint32_t>(bins), add);
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
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Parts a row is cut into, and chunks a part: a row whose starts span
// `span` chunks is split when S rows make fewer than `fill` items, or when
// it spans more than `most` chunks; a part takes at least `least` chunks.
void plan_parts(int64_t S, int64_t span, int64_t fill, int64_t least, int64_t most,
                int64_t* parts, int64_t* per) {
  int64_t p = S >= fill ? 1 : ceil_div(fill, S);
  p = p > ceil_div(span, most) ? p : ceil_div(span, most);
  int64_t q = ceil_div(span, p);
  q = q > least ? q : least;
  q = q < most ? q : most;
  *per = q;
  *parts = ceil_div(span, q);
}

// The global route above kMaxBins: the output zeroed, then every window
// added with an atomic.
cudaError_t launch_global(const uint8_t* grid, int64_t S, int64_t L, int k, int canonical,
                          int bins, int32_t* out, cudaStream_t stream) {
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(grid) & 15);
  const int64_t span = L >= k ? ((L - k) >> 4) + 2 : 1;
  int64_t parts, per;
  plan_parts(S, span, 64LL * sm_count(), kMinWarpPart, INT64_MAX / 2, &parts, &per);
  const int64_t items = S * parts;
  const cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(S) * bins * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const int64_t blocks = ceil_div(items, kWarpsPerBlock);
  auto kernel = canonical ? counts_global_kernel<true> : counts_global_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks < INT32_MAX ? blocks : INT32_MAX), kWarpThreads, 0,
           stream>>>(grid, L, k, bins, items, parts, per, mis, S * L + mis, out);
  return cudaGetLastError();
}

// The warp route up to kWarpMaxBins bins, the block route above, the global
// route above kMaxBins.
cudaError_t launch_counts(const uint8_t* grid, int64_t S, int64_t L, int k, int canonical,
                          int bins, int32_t* out, cudaStream_t stream) {
  if (bins > kMaxBins) return launch_global(grid, S, L, k, canonical, bins, out, stream);
  const bool warp = bins <= kWarpMaxBins;
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(grid) & 15);
  const int64_t span = L >= k ? ((L - k) >> 4) + 2 : 1;  // most chunks a row's starts touch
  int64_t parts, per;
  if (warp) {
    plan_parts(S, span, 64LL * sm_count(), kMinWarpPart, INT64_MAX / 2, &parts, &per);
  } else {
    plan_parts(S, span, 2LL * sm_count(), kBlockThreads, kMaxPartChunks, &parts, &per);
  }
  const int64_t items = S * parts;
  const bool add_out = parts > 1;
  if (add_out) {
    const cudaError_t err = cudaMemsetAsync(out, 0, S * bins * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  const int64_t end = S * L + mis;
  if (warp) {
    const size_t bytes = static_cast<size_t>(kWarpsPerBlock) * WarpHist::words(bins) * 4;
    auto kernel = canonical ? counts_warp_kernel<true> : counts_warp_kernel<false>;
    const cudaError_t err = allow_shared(kernel, bytes);
    if (err != cudaSuccess) return err;
    const int64_t blocks = ceil_div(items, kWarpsPerBlock);
    kernel<<<static_cast<unsigned>(blocks < INT32_MAX ? blocks : INT32_MAX), kWarpThreads, bytes,
             stream>>>(grid, L, k, bins, items, parts, per, mis, end, add_out, out);
  } else {
    const int words = ((bins + 1) / 2 + 3) & ~3;
    const size_t bytes = static_cast<size_t>(words) * 4;
    const bool vec = bins % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    auto kernel = canonical ? counts_block_kernel<true> : counts_block_kernel<false>;
    const cudaError_t err = allow_shared(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(items < INT32_MAX ? items : INT32_MAX), kBlockThreads, bytes,
             stream>>>(grid, L, k, bins, words, items, parts, per, mis, end, add_out, vec, out);
  }
  return cudaGetLastError();
}

}  // namespace

// grid u8 [S, L] -> out int32 [S, bins], both row-major and contiguous.
// 1 <= k <= 15, 1 <= bins <= 4^15. Returns the cudaError_t of the launch.
extern "C" int kp_counts_matrix(const uint8_t* grid, long long S, long long L,
                                int k, int canonical, int bins, int32_t* out,
                                void* stream) {
  if (S <= 0) return 0;
  if (L < 0 || k < 1 || k > 15 || bins < 1 || bins > kMaxAnyBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      launch_counts(grid, S, L, k, canonical, bins, out, static_cast<cudaStream_t>(stream)));
}
