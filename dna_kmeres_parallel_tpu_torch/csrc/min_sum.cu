// Tiled integer (min,+) products (K3 and K4) for Hopper, sm_90a.
//
// Replaces the TPU kernels
//   dna_kmeres_parallel_tpu/ops/distance_pallas.py::min_sum_matrix_pallas_tri
//     (K3, body _tri_single_slice): the symmetric all-pairs matrix,
//     upper-triangle tiles only;
//   dna_kmeres_parallel_tpu/ops/distance_pallas.py::min_sum_matrix_pallas
//     (K4): the rectangular panel of the streamed distance path.
//
// out[i, j] = sum_b min(a[i, b], c[j, b]) over int32 [S, B] and [S2, B]
// counts, int32 out. The caller guarantees that every row's sum is below
// 2^31, so no partial sum can overflow (a min-sum is at most the smaller
// row sum).
//
// Design: one routine computes a kTile x kTile output tile. The block's
// 256 threads are 16 x 16, each owning 4 x 4 outputs strided by 16 (rows
// ty + 16i, columns tx + 16j), kept in int32 registers. The bins are
// walked in stages of kBK: each stage stages kTile rows of A and kTile rows
// of C, transposed, in shared memory (padded to kTile + 1 so the
// transposing stores hit distinct banks), and every thread then takes
// min + add over the stage. All bins accumulate inside the one kernel: the
// TPU kernel's 256-bin slab scan existed for Mosaic's scoped VMEM and has
// no counterpart here, nor does its tile-stack output with its gather.
//   - min_sum_tri (K3): a 1-D grid over the nt (nt + 1) / 2 upper-triangle
//     tile pairs (ti <= tj). A block writes its tile, and for ti < tj the
//     mirror tile as well, transposed through shared memory so that the
//     stores stay coalesced: the output is the full symmetric matrix.
//   - min_sum_rect (K4): a 2-D grid over all tiles of [S, S2].
// Rows and bins past the edge load as 0 and are never stored.
//
// Bound: at the distance path's shapes (64 bins at k = 3) the operations
// and the output bytes are of one order: 2 integer operations per bin per
// pair against 4 bytes stored per pair (K3 also stores the mirror). Each
// min + add costs a quarter of a shared-memory load here (8 loads per 16
// pairs of a bin). Packed 16-bit min/add (__vimin2/__vadd2), wgmma-style
// register blocking and TMA staging are left for later.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPad = kTile + 1;
// Two [kBK][kPad] stages, reused as one [kTile][kPad] tile for the mirror.
constexpr int kSmemInts = 2 * kBK * kPad;
static_assert(kSmemInts == kTile * kPad, "mirror tile must fit the stages");

// acc[i][j] = min-sum of A row r0 + ty + 16i and C row c0 + tx + 16j.
__device__ __forceinline__ void tile_min_sum(
    const int32_t* __restrict__ A, int64_t S, const int32_t* __restrict__ C,
    int64_t S2, int64_t B, int64_t r0, int64_t c0, int32_t* smem,
    int32_t acc[4][4]) {
  int32_t(*as)[kPad] = reinterpret_cast<int32_t(*)[kPad]>(smem);
  int32_t(*cs)[kPad] = reinterpret_cast<int32_t(*)[kPad]>(smem + kBK * kPad);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int64_t b0 = 0; b0 < B; b0 += kBK) {
    // A warp loads one row's kBK consecutive bins: coalesced reads, and
    // the transposed stores fall in distinct banks thanks to the padding.
    for (int e = threadIdx.x; e < kTile * kBK; e += kThreads) {
      const int rr = e / kBK, bb = e % kBK;
      const int64_t gb = b0 + bb;
      const int64_t ga = r0 + rr, gc = c0 + rr;
      as[bb][rr] = (ga < S && gb < B) ? A[ga * B + gb] : 0;
      cs[bb][rr] = (gc < S2 && gb < B) ? C[gc * B + gb] : 0;
    }
    __syncthreads();
    const int nb = static_cast<int>(B - b0 < kBK ? B - b0 : kBK);
    for (int bb = 0; bb < nb; ++bb) {
      int32_t av[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[bb][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = cs[bb][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += min(av[i], cv[j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_tile(int32_t* __restrict__ out,
                                           int64_t S, int64_t S2, int64_t r0,
                                           int64_t c0, int32_t acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = c0 + tx + 16 * j;
      if (c < S2) out[r * S2 + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
min_sum_tri_kernel(const int32_t* __restrict__ A, int64_t S, int64_t B,
                   int64_t nt, int32_t* __restrict__ out) {
  __shared__ int32_t smem[kSmemInts];
  // Tile pair t -> (ti, tj): row ti of the triangle starts at
  // ti * nt - ti (ti - 1) / 2. Estimate ti in double, then correct.
  const int64_t t = blockIdx.x;
  auto start = [nt](int64_t i) { return i * nt - i * (i - 1) / 2; };
  const double w = 2.0 * nt + 1.0;
  int64_t ti = static_cast<int64_t>((w - sqrt(w * w - 8.0 * t)) / 2.0);
  if (ti < 0) ti = 0;
  if (ti > nt - 1) ti = nt - 1;
  while (ti > 0 && start(ti) > t) --ti;
  while (ti + 1 < nt && start(ti + 1) <= t) ++ti;
  const int64_t tj = ti + (t - start(ti));
  const int64_t r0 = ti * kTile, c0 = tj * kTile;

  int32_t acc[4][4];
  tile_min_sum(A, S, A, S, B, r0, c0, smem, acc);
  store_tile(out, S, S, r0, c0, acc);
  if (ti == tj) return;

  // Mirror: out[c0 + c, r0 + r] = acc(r, c), staged as m[c][r] so that a
  // warp stores 32 consecutive columns of one output row.
  int32_t(*m)[kPad] = reinterpret_cast<int32_t(*)[kPad]>(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[tx + 16 * j][ty + 16 * i] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int cc = e / kTile, rr = e % kTile;
    const int64_t orow = c0 + cc, ocol = r0 + rr;
    if (orow < S && ocol < S) out[orow * S + ocol] = m[cc][rr];
  }
}

__global__ void __launch_bounds__(kThreads)
min_sum_rect_kernel(const int32_t* __restrict__ A, int64_t S,
                    const int32_t* __restrict__ C, int64_t S2, int64_t B,
                    int32_t* __restrict__ out) {
  __shared__ int32_t smem[kSmemInts];
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile;
  int32_t acc[4][4];
  tile_min_sum(A, S, C, S2, B, r0, c0, smem, acc);
  store_tile(out, S, S2, r0, c0, acc);
}

}  // namespace

// a int32 [S, B] -> out int32 [S, S], the full symmetric min-sum matrix.
// Returns the cudaError_t of the launch.
extern "C" int kp_min_sum_tri(const int32_t* a, long long S, long long B,
                              int32_t* out, void* stream) {
  if (S <= 0) return 0;
  const long long nt = (S + kTile - 1) / kTile;
  const long long tiles = nt * (nt + 1) / 2;
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  min_sum_tri_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, S, B, nt, out);
  return static_cast<int>(cudaGetLastError());
}

// a int32 [S, B], c int32 [S2, B] -> out int32 [S, S2]. Returns the
// cudaError_t of the launch.
extern "C" int kp_min_sum_rect(const int32_t* a, long long S, const int32_t* c,
                               long long S2, long long B, int32_t* out,
                               void* stream) {
  if (S <= 0 || S2 <= 0) return 0;
  const long long rows = (S + kTile - 1) / kTile;
  const long long cols = (S2 + kTile - 1) / kTile;
  if (rows > 65535 || cols > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(static_cast<unsigned>(cols), static_cast<unsigned>(rows));
  min_sum_rect_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, S, c, S2, B,
                                                             out);
  return static_cast<int>(cudaGetLastError());
}
