// The row sort (K11) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/sort_pallas.py::row_sort_pallas_u32
//   (body _make_kernel), the in-VMEM bitonic sort of the single-word rows
//   of the sparse device-sort route (ops/sparse.py::_sort_words_as_rows).
// Input:  x [R, m] 32-bit words, m a power of two, 128 <= m <= 32768.
// Output: out [R, m], each row ascending in UNSIGNED order, so the
//   all-ones sentinel sorts last. The TPU kernel biased its keys
//   (x ^ 0x80000000) only because Mosaic compares int32; the digits here
//   are taken from the unsigned bits.
//
// Design: an LSD radix sort with 8-bit digits, in shared memory. A bitonic
// network does O(m log^2 m) compare-exchanges (66 passes at m = 2048); a
// radix pass does a constant amount of work a word, and most rows need
// few passes.
//   - Load: one thread starts a 1-D cp.async.bulk of the block's rows into
//     shared memory, completing on an mbarrier. A row's T = m / E threads
//     then keep E words each in registers, warp-striped: word s of lane l
//     of the row's warp w sits at w*32*E + s*32 + l, so a warp reads and
//     writes 32 consecutive words and the rank order below is row order.
//   - Sentinels out: the all-ones words sort last whatever their digits,
//     so a row counts them, sorts only the rest and ends with that many
//     all-ones words. This is exact for any u32: a real key of all ones
//     equals the sentinel.
//   - Skipped passes: the AND and the OR of a row's other words show which
//     bytes differ; a pass runs only for those (taken over the rows of a
//     block, so the block stays in step). K1's k=11 words are below 2^22:
//     3 passes; random 32-bit words take 4. A block whose rows need none
//     writes them straight out.
//   - A stable pass: (1) each warp ranks its words by digit, in order: the
//     lanes that share a digit from nine ballots (eight digit bits and the
//     sentinel flag; __match_any_sync ran slower on the card), the peers
//     below the lane, and a per-warp digit count in shared memory; (2) one
//     exclusive scan of the row's counts in (digit, warp) order; (3) each
//     word goes to its scanned offset plus its rank in the one shared
//     buffer, and is read back into registers for the next pass. The keys stay in registers between passes, so one buffer
//     of m words does (128 KB at m = 32768).
//   - The sorted row goes out with 16-byte stores. A thread keeps 16 words
//     (4 at m = 128, 8 at m = 256, 32 at m = 32768; 16 ran faster on the
//     card than 8 at m = 2048); rows of fewer than 256 threads share a
//     block; above 48 KB of shared memory the kernel gets the larger limit
//     through cudaFuncSetAttribute.
//
// Bound: bytes. The sort reads and writes each word once (8 B per word:
// 128 MB, about 0.040 ms at 3.35 TB/s, for the route's [8192, 2048]
// batch). Device memory sees each row once each way; the passes run on
// registers and shared memory, about 40 integer instructions a word a pass
// (nine of them ballots), which with the shared-memory scatter and the
// barriers set the time above the bound.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMinM = 128;
constexpr int kMaxM = 32768;
constexpr int kBlockThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kDigits = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from device
// memory into shared memory, completing on `bar`; one thread calls it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  } while (!done);
}

// Shared memory: the rows (rows_per_block * m words), then the per-row
// (digit, warp) counts (256 words a warp), then per-warp scratch.
template <int E>
__global__ void __launch_bounds__(kMaxThreads)
row_sort_kernel(const uint32_t* __restrict__ x, long long R, int m,
                int rows_per_block, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* counts = buf + rows_per_block * m;
  uint32_t* stat_and = counts + kDigits * nwarps;
  uint32_t* stat_or = stat_and + nwarps;
  uint32_t* stat_sent = stat_or + nwarps;
  uint32_t* totals = stat_sent + nwarps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(totals + nwarps);  // 8-byte aligned

  const int T = m / E;          // threads per row
  const int Wr = T >> 5;        // warps per row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = tid / T;
  const int t = tid - row * T;  // thread in the row
  const int wl = t >> 5;        // warp in the row
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows_here = static_cast<int>(min(static_cast<long long>(rows_per_block), R - r0));
  const bool live = row < rows_here;
  uint32_t* srow = buf + row * m;
  uint32_t* cnt = counts + row * (kDigits * Wr);

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    bulk_load(buf, x + r0 * m, static_cast<uint32_t>(rows_here) * m * 4u, bar);
  }
  bar_wait(bar, 0);

  // E words in registers, warp-striped; a missing last row is all
  // sentinels and is never stored.
  const int first = wl * 32 * E + lane;
  uint32_t v[E];
#pragma unroll
  for (int s = 0; s < E; ++s) v[s] = live ? srow[first + 32 * s] : kSentinel;

  // The row's AND and OR of its other words, and its count of sentinels.
  uint32_t a = kSentinel, o = 0, ns = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    if (v[s] == kSentinel) {
      ++ns;
    } else {
      a &= v[s];
      o |= v[s];
    }
  }
  a = __reduce_and_sync(0xFFFFFFFFu, a);
  o = __reduce_or_sync(0xFFFFFFFFu, o);
  ns = __reduce_add_sync(0xFFFFFFFFu, ns);
  if (lane == 0) {
    stat_and[warp] = a;
    stat_or[warp] = o;
    stat_sent[warp] = ns;
  }
  __syncthreads();
  // Every thread folds every row's warps: its own row's AND and count of
  // sentinels, and the bytes in which any row of the block differs.
  uint32_t row_and = kSentinel, differ = 0;
  int nvalid = m;
  for (int r = 0; r < rows_per_block; ++r) {
    uint32_t ra = kSentinel, ro = 0, rs = 0;
    for (int w = r * Wr; w < (r + 1) * Wr; ++w) {
      ra &= stat_and[w];
      ro |= stat_or[w];
      rs += stat_sent[w];
    }
    if (rs < static_cast<uint32_t>(m)) differ |= ra ^ ro;
    if (r == row) {
      row_and = ra;
      nvalid = m - static_cast<int>(rs);
    }
  }

  uint4* dst = reinterpret_cast<uint4*>(out + (r0 + row) * m);
  if (differ == 0) {
    // Every row's other words are equal: the row is nvalid copies of them,
    // then the sentinels.
    if (live) {
      for (int i = t; i < m / 4; i += T) {
        const int p = 4 * i;
        dst[i] = make_uint4(p < nvalid ? row_and : kSentinel, p + 1 < nvalid ? row_and : kSentinel,
                            p + 2 < nvalid ? row_and : kSentinel,
                            p + 3 < nvalid ? row_and : kSentinel);
      }
    }
    return;
  }
  int last = 3;
  while (!((differ >> (8 * last)) & 0xFFu)) --last;

  const unsigned below = lanemask_lt();
  for (int pass = 0; pass <= last; ++pass) {
    const int shift = 8 * pass;
    if (!((differ >> shift) & 0xFFu)) continue;

    // (1) Zero the row's counts (8 a thread), then rank each word within
    // its warp: words s < s' of the warp and, for one s, lanes in order.
    uint4* c4 = reinterpret_cast<uint4*>(cnt);
    c4[2 * t] = make_uint4(0, 0, 0, 0);
    c4[2 * t + 1] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    uint32_t rk[(E + 1) / 2];
#pragma unroll
    for (int s = 0; s < (E + 1) / 2; ++s) rk[s] = 0;
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const bool sent = v[s] == kSentinel;
      const uint32_t d = (v[s] >> shift) & 0xFFu;
      // The lanes holding this lane's digit (or, for a sentinel, the
      // other sentinels): one ballot per digit bit.
      unsigned peers = __ballot_sync(0xFFFFFFFFu, sent);
      if (!sent) peers = ~peers;
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const unsigned set = __ballot_sync(0xFFFFFFFFu, (d >> bit) & 1u);
        peers &= ((d >> bit) & 1u) ? set : ~set;
      }
      const int leader = __ffs(peers) - 1;
      uint32_t* slot = cnt + d * Wr + wl;
      uint32_t base = 0;
      if (!sent && lane == leader) base = *slot;
      base = __shfl_sync(0xFFFFFFFFu, base, leader);
      if (!sent && lane == leader) *slot = base + __popc(peers);
      __syncwarp();
      rk[s >> 1] |= (base + __popc(peers & below)) << (16 * (s & 1));
    }
    __syncthreads();

    // (2) Exclusive scan of the row's 256 * Wr counts in (digit, warp)
    // order: 8 consecutive counts a thread, then the warp, then the row's
    // warps before this one.
    const uint4 q0 = c4[2 * t], q1 = c4[2 * t + 1];
    uint32_t e[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t c = e[i];
      e[i] = sum;
      sum += c;
    }
    uint32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) totals[warp] = incl;
    __syncthreads();
    uint32_t before = incl - sum;
    for (int w = row * Wr; w < warp; ++w) before += totals[w];
    c4[2 * t] = make_uint4(e[0] + before, e[1] + before, e[2] + before, e[3] + before);
    c4[2 * t + 1] = make_uint4(e[4] + before, e[5] + before, e[6] + before, e[7] + before);
    __syncthreads();

    // (3) Scatter the words to their ranks; the sentinels' places past
    // nvalid are left unwritten.
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if (v[s] != kSentinel) {
        const uint32_t d = (v[s] >> shift) & 0xFFu;
        srow[cnt[d * Wr + wl] + ((rk[s >> 1] >> (16 * (s & 1))) & 0xFFFFu)] = v[s];
      }
    }
    __syncthreads();
    if (pass < last) {
#pragma unroll
      for (int s = 0; s < E; ++s) {
        const int p = first + 32 * s;
        v[s] = p < nvalid ? srow[p] : kSentinel;
      }
    }
  }

  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(srow);
    for (int i = t; i < m / 4; i += T) {
      const int p = 4 * i;
      uint4 w = src[i];
      if (p + 3 >= nvalid) {
        w.x = p < nvalid ? w.x : kSentinel;
        w.y = p + 1 < nvalid ? w.y : kSentinel;
        w.z = p + 2 < nvalid ? w.z : kSentinel;
        w.w = kSentinel;
      }
      dst[i] = w;
    }
  }
}

template <int E>
int launch(const uint32_t* x, long long R, int m, uint32_t* out, cudaStream_t stream) {
  const int T = m / E;
  const int rows_per_block = std::max(1, kBlockThreads / T);
  const int threads = rows_per_block * T;
  const int nwarps = threads / 32;
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  // rows, counts, 4 words of scratch a warp, mbarrier
  const size_t smem = (static_cast<size_t>(rows_per_block) * m + kDigits * nwarps +
                       4 * nwarps) * sizeof(uint32_t) + sizeof(uint64_t);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_sort_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  row_sort_kernel<E><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, R, m, rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11: sort each row of x [R, m] (u32 words) ascending into out [R, m].
// x and out 16-byte aligned. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int kp_row_sort(const void* x, long long R, int m, void* out, void* stream) {
  if (R <= 0 || m < kMinM || m > kMaxM || (m & (m - 1)) != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Words per thread: 16 (fewer where a row would have less than a warp:
  // 4 at m = 128, 8 at 256), more where it would need over 1,024 threads
  // (32 at m = 32768).
  const int E = std::max(std::min(16, m / 32), m / kMaxThreads);
  const auto* in = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 4:
      return launch<4>(in, R, m, o, s);
    case 8:
      return launch<8>(in, R, m, o, s);
    case 16:
      return launch<16>(in, R, m, o, s);
    case 32:
      return launch<32>(in, R, m, o, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
