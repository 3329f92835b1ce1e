// Per-sequence k-mer counts matrix (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/histogram_pallas.py::counts_matrix_pallas
//   (body _make_counts_kernel),
// and serves every dense bin count up to 4^8 = 65,536 with one kernel. The
// TPU kernel stops at 1,024 bins: its one-hot compare costs bins per
// window, and above that the JAX engine counts with an XLA scatter, which
// computes the same function.
//
// Input: a u8 grid [S, L], row-major, one sequence per row, base codes
// 0..3 and anything else (0xFF pads a short row) invalid. Output: int32
// [S, bins], row-major: out[s, c] = the number of windows of row s whose
// k bases are all valid and whose code (the smaller of the code and its
// reverse complement with canonical set) is c. Codes >= bins are dropped.
// k <= 15, so a code fits 30 bits.
//
// Design: a 2-D grid, blockIdx.x = row, blockIdx.y = a slice of at most
// kChunkBins bins. A block zeroes its slice of the histogram in shared
// memory, walks every window of its row (one window per thread per step,
// so a warp reads 32 + k neighbouring bytes), forms the code and its
// reverse complement in registers, adds the windows whose code falls in
// its slice with shared-memory atomics, and writes the slice out with
// coalesced stores. 65,536 int32 bins (256 KB) do not fit a block's
// 227 KB of shared memory, so the bin range is split across the blocks of
// a row (8 slices of 32 KB at k = 8), each of which re-reads the row from
// L1/L2; no global atomics and no zeroing pass over the output.
//
// Bound: the bytes. Each base is read once from device memory (later
// slices of the row hit L2) and each count written once; the arithmetic
// is a few integer operations per base. A row is one block, so a grid of
// a few very long rows leaves the card idle; splitting long rows across
// blocks, and wider loads, are left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkBins = 8192;  // 32 KB of shared memory per block

__global__ void __launch_bounds__(kThreads)
counts_matrix_kernel(const uint8_t* __restrict__ grid, int64_t L, int k,
                     int canonical, int bins, int chunk,
                     int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int64_t row = blockIdx.x;
  const int b0 = blockIdx.y * chunk;
  const int nb = min(chunk, bins - b0);
  for (int i = threadIdx.x; i < nb; i += kThreads) hist[i] = 0;
  __syncthreads();

  const uint8_t* r = grid + row * L;
  const int64_t n = L - k + 1;  // windows of the row (<= 0: none)
  for (int64_t p = threadIdx.x; p < n; p += kThreads) {
    uint32_t code = 0, rc = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      const uint32_t b = __ldg(r + p + j);
      ok &= b < 4;
      code = (code << 2) | (b & 3);
      rc |= (3u - (b & 3)) << (2 * j);  // base j is digit j of the RC
    }
    if (!ok) continue;
    if (canonical) code = min(code, rc);
    const int64_t c = static_cast<int64_t>(code) - b0;
    if (c >= 0 && c < nb) atomicAdd(&hist[c], 1);
  }
  __syncthreads();

  int32_t* o = out + row * bins + b0;
  for (int i = threadIdx.x; i < nb; i += kThreads) o[i] = hist[i];
}

}  // namespace

// grid u8 [S, L] -> out int32 [S, bins], both row-major and contiguous.
// 1 <= k <= 15, 1 <= bins <= 65536. Returns the cudaError_t of the launch.
extern "C" int kp_counts_matrix(const uint8_t* grid, long long S, long long L,
                                int k, int canonical, int bins, int32_t* out,
                                void* stream) {
  if (S <= 0) return 0;
  const int chunk = bins < kChunkBins ? bins : kChunkBins;
  const dim3 blocks(static_cast<unsigned>(S), (bins + chunk - 1) / chunk);
  counts_matrix_kernel<<<blocks, kThreads, chunk * sizeof(int32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      grid, L, k, canonical, bins, chunk, out);
  return static_cast<int>(cudaGetLastError());
}
