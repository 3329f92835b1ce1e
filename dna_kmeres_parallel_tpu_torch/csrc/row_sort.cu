// The row sort (K11) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/sort_pallas.py::row_sort_pallas_u32
//   (body _make_kernel), the in-VMEM bitonic sort of the single-word rows
//   of the sparse device-sort route (ops/sparse.py::_sort_words_as_rows).
// Input:  x [R, m] 32-bit words, m a power of two, 128 <= m <= 32768.
// Output: out [R, m], each row ascending in UNSIGNED order, so the
//   all-ones sentinel sorts last. The TPU kernel biased its keys
//   (x ^ 0x80000000) only because Mosaic compares int32; the compares
//   here are on uint32_t.
//
// Design: the bitonic network of the TPU kernel, log2(m)(log2(m)+1)/2
// compare-exchange passes (66 at m = 2048), without its lane rolls. A
// block owns whole rows: it loads them into shared memory with coalesced
// 16-byte loads, and each of a row's T = m / E threads then keeps E words
// in registers, word s at position s*T + t. A pass of span j >= T pairs
// two registers of one thread; a span 32 <= j < T exchanges through
// shared memory between two __syncthreads; a span j < 32 exchanges by
// __shfl_xor_sync inside the warp. The sorted rows go back through shared
// memory and out with 16-byte stores. Rows of m < 2048 words share a
// block (at least 256 threads); rows above 48 KB of shared memory
// (m = 16384 and 32768) get the larger limit through
// cudaFuncSetAttribute.
//
// Bound: bytes. The sort reads and writes each word once (8 B per word:
// 128 MB, about 0.040 ms at 3.35 TB/s, for the route's [8192, 2048]
// batch); its 66 passes of one min or max per word are about 1.1 G
// operations, about 0.017 ms at 67 T/s. The network keeps every pass in
// registers or shared memory, so device memory sees the row once each way.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMinM = 128;
constexpr int kMaxM = 32768;
constexpr int kBlockThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kStaticSmem = 48 * 1024;

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
row_sort_kernel(const uint32_t* __restrict__ x, long long R, int m,
                int rows_per_block, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int T = m / E;  // threads per row
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long rows_here = min(static_cast<long long>(rows_per_block), R - r0);
  const int vec_here = static_cast<int>(rows_here * m / 4);
  const int vec_all = rows_per_block * m / 4;

  // Coalesced 16-byte loads of the block's rows; a missing last row is
  // all sentinels and is never stored.
  const uint4* src = reinterpret_cast<const uint4*>(x + r0 * m);
  for (int i = tid; i < vec_all; i += nthreads) {
    smem4[i] = i < vec_here ? src[i] : make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  __syncthreads();

  const int t = tid % T;
  uint32_t* srow = smem + (tid / T) * m;
  uint32_t v[E];
#pragma unroll
  for (int s = 0; s < E; ++s) v[s] = srow[s * T + t];

  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      if (j >= T) {
        // Both words in this thread: registers s and s | (j / T).
        const int b = j / T;
#pragma unroll
        for (int bb = E / 2; bb >= 1; bb >>= 1) {
          if (bb != b) continue;
#pragma unroll
          for (int s = 0; s < E; ++s) {
            if (s & bb) continue;
            const bool up = ((s * T + t) & k) == 0;
            const uint32_t a = v[s], c = v[s | bb];
            const uint32_t lo = min(a, c), hi = max(a, c);
            v[s] = up ? lo : hi;
            v[s | bb] = up ? hi : lo;
          }
        }
      } else if (j >= 32) {
        // Partner in another warp of the row: through shared memory. The
        // first barrier keeps the last shared pass's reads before these
        // writes.
        __syncthreads();
#pragma unroll
        for (int s = 0; s < E; ++s) srow[s * T + t] = v[s];
        __syncthreads();
        const bool lower = (t & j) == 0;
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const uint32_t p = srow[s * T + (t ^ j)];
          const bool up = ((s * T + t) & k) == 0;
          v[s] = lower == up ? min(v[s], p) : max(v[s], p);
        }
      } else {
        // Partner in this warp (T is a multiple of 32): lane t ^ j.
        const bool lower = (t & j) == 0;
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const uint32_t p = __shfl_xor_sync(0xffffffffu, v[s], j);
          const bool up = ((s * T + t) & k) == 0;
          v[s] = lower == up ? min(v[s], p) : max(v[s], p);
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int s = 0; s < E; ++s) srow[s * T + t] = v[s];
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + r0 * m);
  for (int i = tid; i < vec_here; i += nthreads) dst[i] = smem4[i];
}

template <int E>
int launch(const uint32_t* x, long long R, int m, uint32_t* out, cudaStream_t stream) {
  const int T = m / E;
  const int rows_per_block = std::max(1, kBlockThreads / T);
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(rows_per_block) * m * sizeof(uint32_t);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_sort_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  row_sort_kernel<E><<<static_cast<unsigned>(blocks), rows_per_block * T, smem, stream>>>(
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
  // Words per thread: at least 8 (4 at m = 128, so a row keeps a whole
  // warp), and at most 1,024 threads a row.
  const int E = m == kMinM ? 4 : std::max(8, m / kMaxThreads);
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
