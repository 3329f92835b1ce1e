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
// What bounds it on this card. Each (pair, bin) is one min and one add.
// The integer min (VIMNMX, and VIMNMX.U16x2 for two 16-bit lanes) issues
// only on the ALU pipe, 64 lanes a clock an SM, half the float32 rate
// behind the 67 T/s of the operation bound; the add can issue elsewhere
// (scripts/min_sum_pipe_probe.py measures both). So 32-bit lanes reach at
// best half the operation bound, and only two minima an instruction reach
// it. K4 at the streamed panel (a [2048, 64] panel against 54,018 rows,
// 7.1e9 pair-bins) is bound by that integer issue. K3 over 54,018 records
// writes an 11.7 GB int32 matrix, 3.5 ms of stores at 3.35 TB/s: bound by
// bytes.
//
// What the design does about it.
//  1. Packed 16-bit minima. Where no pair's min-sum can reach 2^16 (the
//     smaller side's largest row sum is below 2^16, and no count is
//     negative: the wrapper decides from the row sums it checks anyway),
//     C's columns are staged as pairs (c[j] | c[j+1] << 16) and A's rows as
//     a * 0x10001, each value clamped to 0xFFFF. The clamp is exact: the
//     small side's values are below 2^16, so min(clamp(a), clamp(c)) =
//     min(a, c). One __vminu2 (min.u16x2: one VIMNMX.U16x2 in the SASS for
//     sm_90a) and one 32-bit add (an IMAD, see add_min) then advance two
//     outputs; no lane can carry into the other, since its sum stays below
//     2^16. The lanes are split to int32 at the store. Otherwise the same
//     tiling runs on 32-bit lanes (min, add). Both routes are kernels of
//     this file; the route is chosen from the data, for exactness, and
//     never as a fallback.
//  2. Wide register tiles. A block computes a 128 x 128 output tile. Each
//     thread holds 8 rows x 8 words of accumulators: 8 x 16 outputs packed
//     (128 threads a block), 8 x 8 on 32-bit lanes (256 threads). A bin
//     costs a thread four 128-bit shared loads (its 8 rows of A, its 8
//     words of C) and 64 (min, add) steps.
//  3. Transposed, swizzled operands. Stages of 32 bins are staged as
//     [bin][row] and [bin][column pair], read from global memory 16 bytes
//     a thread (4 bins of one row) where the rows are 16-byte aligned, and
//     stored with the 16-byte chunks of each bin row XOR-swizzled by
//     bin / 4: the transposing stores and the operand loads are both free
//     of bank conflicts. The staging transforms every value (clamp,
//     packing, transpose), which cp.async and TMA cannot do; the overlap of
//     loads and arithmetic comes from four blocks resident on each SM (two
//     on 32-bit lanes).
//  4. Stores. The tile goes out through shared memory, half a tile (64
//     output rows) at a time, so that a warp writes whole 512-byte output
//     rows with 16-byte stores, realigned to the row's own alignment (the
//     path's row lengths, 54,018 - r0, are not multiples of 4). K3's
//     mirror tile is the transposed read of the same registers.
//   - min_sum_tri (K3): a grid over the nt (nt + 1) / 2 upper-triangle
//     tile pairs (ti <= tj); a block writes its tile and, for ti < tj, the
//     mirror tile: the output is the full symmetric matrix.
//   - min_sum_rect (K4): a grid over all tiles of [S, S2].
//  5. Bin slices (split-K), for products with few output tiles. A block
//     walks every bin of its tile, so a product of a few hundred rows over
//     10^5-10^6 bins launches 3-4 blocks on 132 SMs. The caller passes
//     the bins a slice, whole 32-bin stages (ops/distance.min_sum_split,
//     the one plan: B wherever the tiles alone give about two waves of
//     resident blocks, else enough slices of at least 1,024 bins for
//     about two waves), and the kernels launch P = ceil(B / slice)
//     slices, the last ending at B. With P > 1 each block computes one
//     tile over one slice, the output is zeroed on the stream, and the
//     block adds its int32 tile (and K3's mirror) into it with
//     fire-and-forget red.global.add.s32, staged through shared memory as
//     the stores are, a warp covering output rows. A slice's partial is a
//     sum over a subset of the bins, at most the whole min-sum, so no
//     packed lane can reach 2^16 that the route's gate did not allow;
//     integer addition is associative, so the result is bit-identical to
//     P = 1 in any order. P = 1 launches the unsplit kernel: no memset,
//     no atomics. K3's grid takes the slices on y, K4's folds them into x
//     (slice-major, so that a slice's tiles run side by side and share
//     its operand bytes in L2).
// Rows and bins past the edge load as 0 and are never stored. The TPU
// kernel's 256-bin slab scan existed for Mosaic's scoped VMEM and has no
// counterpart here, nor does its tile-stack output with its gather.
//
// Not yet: the stores do not overlap the arithmetic. A block's store phase
// follows its last stage, and the time of the stores adds to that of the
// arithmetic (scripts/min_sum_variants_probe.py times the kernels without
// their stores). Warp-specialised blocks (a loader warp and a store warp
// beside the compute warps) and bulk-copy (TMA) stores were tried and
// were slower.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 128;        // a block's output tile is kTile x kTile
constexpr int kBK = 32;           // bins a stage
constexpr int kGroups = kBK / 4;  // 4-bin groups a stage row
constexpr int kSmemWords = 8192;  // 32 KB: one stage, or half an output tile
constexpr uint32_t kLaneMax = 0xFFFFu;

template <bool kPacked>
struct Tiling {
  // Threads across the tile's columns; 16 threads run down its rows.
  static constexpr int kTX = kPacked ? 8 : 16;
  static constexpr int kThreads = 16 * kTX;
  // 32-bit words of C in one staged bin: column pairs, or columns.
  static constexpr int kCWords = kPacked ? kTile / 2 : kTile;
  static constexpr int kMinBlocks = kPacked ? 4 : 2;
};

static_assert(kBK * (kTile + kTile) <= kSmemWords, "a stage must fit");
static_assert(64 * kTile <= kSmemWords, "half an output tile must fit");

// Bins [gb, gb + 4) of row gr of X ([rows, B]), 0 past either edge. With
// vec, rows are 16-byte aligned and B % 4 == 0, so gb < B covers all four.
__device__ __forceinline__ uint4 load4(const int32_t* __restrict__ X,
                                       int64_t rows, int64_t B, int64_t gr,
                                       int64_t gb, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (gr >= rows || gb >= B) return v;
  const int32_t* p = X + gr * B + gb;
  if (vec) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p));
    return make_uint4(w.x, w.y, w.z, w.w);
  }
  v.x = static_cast<uint32_t>(p[0]);
  if (gb + 1 < B) v.y = static_cast<uint32_t>(p[1]);
  if (gb + 2 < B) v.z = static_cast<uint32_t>(p[2]);
  if (gb + 3 < B) v.w = static_cast<uint32_t>(p[3]);
  return v;
}

__device__ __forceinline__ uint32_t clamp16(uint32_t v) {
  return v < kLaneMax ? v : kLaneMax;
}

// Stages bins [b0, b0 + kBK) of A rows [r0, r0 + kTile) as as[bin][row]
// and of C rows [c0, c0 + kTile) as cs[bin][column word]. A bin row's
// 16-byte chunk ch sits at ch ^ (bin / 4).
template <bool kPacked>
__device__ __forceinline__ void stage(const int32_t* __restrict__ A,
                                      int64_t S,
                                      const int32_t* __restrict__ C,
                                      int64_t S2, int64_t B, int64_t r0,
                                      int64_t c0, int64_t b0, bool vec_a,
                                      bool vec_c, uint32_t* smem) {
  using T = Tiling<kPacked>;
  uint32_t* as = smem;
  uint32_t* cs = smem + kBK * kTile;
  constexpr int kIters = kTile * kGroups / T::kThreads;
#pragma unroll 4
  for (int it = 0; it < kIters; ++it) {
    // A warp reads 4 rows x 8 groups: four whole 128-byte row segments.
    const int e = threadIdx.x + it * T::kThreads;
    const int r = e / kGroups, g = e % kGroups;
    const int64_t gb = b0 + 4 * g;
    const uint4 va = load4(A, S, B, r0 + r, gb, vec_a);
    const uint4 vc = load4(C, S2, B, c0 + r, gb, vec_c);
    const uint32_t x[4] = {va.x, va.y, va.z, va.w};
    const uint32_t y[4] = {vc.x, vc.y, vc.z, vc.w};
    const int ai = ((((r >> 2) ^ g) << 2) | (r & 3));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      as[(4 * g + q) * kTile + ai] = kPacked ? clamp16(x[q]) * 0x10001u : x[q];
    if constexpr (kPacked) {
      // Column r is the low (even r) or high half of word r / 2.
      const int w = r >> 1;
      const int ci = ((((w >> 2) ^ g) << 2) | (w & 3));
      uint16_t* cs16 = reinterpret_cast<uint16_t*>(cs);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cs16[((4 * g + q) * T::kCWords + ci) * 2 + (r & 1)] =
            static_cast<uint16_t>(clamp16(y[q]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) cs[(4 * g + q) * kTile + ai] = y[q];
    }
  }
}

// acc += min(a, c): two 16-bit lanes, or one signed 32-bit lane. The add
// is a multiply-add by one, a kernel argument that the launch sets to 1:
// ptxas cannot fold it, so it issues as IMAD on the FMA pipe. Written as a
// plain add, ptxas folds two bins' adds into one three-input IADD3, which
// issues on the ALU pipe beside the minima and takes a third of their
// issue rate.
template <bool kPacked>
__device__ __forceinline__ uint32_t add_min(uint32_t acc, uint32_t a,
                                            uint32_t c, uint32_t one) {
  uint32_t m;
  if constexpr (kPacked) {
    m = __vminu2(a, c);
  } else {
    m = static_cast<uint32_t>(min(static_cast<int32_t>(a), static_cast<int32_t>(c)));
  }
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(m), "r"(one), "r"(acc));
  return d;
}

// Thread (tx, ty) owns tile rows 4ty + i and 64 + 4ty + i (i < 4) and
// column words 4tx + j and kCWords / 2 + 4tx + j (j < 4): a packed word w
// holds columns 2w and 2w + 1, a 32-bit word column w.
template <bool kPacked>
__device__ __forceinline__ void stage_product(const uint32_t* smem,
                                              uint32_t (&acc)[8][8],
                                              uint32_t one) {
  using T = Tiling<kPacked>;
  const int tx = threadIdx.x % T::kTX, ty = threadIdx.x / T::kTX;
  const uint32_t* as = smem;
  const uint32_t* cs = smem + kBK * kTile;
  constexpr int kCHalf = T::kCWords / 8;  // chunks in half a bin row of C
#pragma unroll
  for (int bb = 0; bb < kBK; ++bb) {
    const int sw = bb >> 2;
    const uint4 a0 = *reinterpret_cast<const uint4*>(as + bb * kTile + ((ty ^ sw) << 2));
    const uint4 a1 = *reinterpret_cast<const uint4*>(as + bb * kTile + (((16 + ty) ^ sw) << 2));
    const uint4 c0 = *reinterpret_cast<const uint4*>(cs + bb * T::kCWords + ((tx ^ sw) << 2));
    const uint4 c1 = *reinterpret_cast<const uint4*>(
        cs + bb * T::kCWords + (((kCHalf + tx) ^ sw) << 2));
    const uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const uint32_t c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = add_min<kPacked>(acc[i][j], a[i], c[j], one);
  }
}

// Lane l of an accumulator word (l = 0 on 32-bit lanes).
template <bool kPacked>
__device__ __forceinline__ uint32_t lane_of(uint32_t w, int l) {
  if constexpr (kPacked) return l ? w >> 16 : w & kLaneMax;
  return w;
}

// The tile's min-sums over bins [b_begin, b_end): b_begin is a multiple of
// kBK, and b_end is one too or B (the stages load bins past B as 0).
template <bool kPacked>
__device__ __forceinline__ void tile_min_sum(
    const int32_t* __restrict__ A, int64_t S, const int32_t* __restrict__ C,
    int64_t S2, int64_t B, int64_t r0, int64_t c0, int64_t b_begin,
    int64_t b_end, uint32_t one, uint32_t* smem, uint32_t (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
  const bool vec_a = B % 4 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool vec_c = B % 4 == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;
  for (int64_t b0 = b_begin; b0 < b_end; b0 += kBK) {
    if (b0 != b_begin) __syncthreads();  // every thread is done with the last stage
    stage<kPacked>(A, S, C, S2, B, r0, c0, b0, vec_a, vec_c, smem);
    __syncthreads();
    stage_product<kPacked>(smem, acc, one);
  }
}

// Staged output, [64][kTile] words: local row lr's chunk ch at
// ch ^ swz(lr), so that both the thread-tile writes (a row, or a column)
// and the row reads are free of bank conflicts.
__device__ __forceinline__ int out_index(int lr, int lc) {
  const int sw = ((lr >> 2) ^ (lr >> 5)) & 7;
  return lr * kTile + ((((lc >> 2) ^ sw) << 2) | (lc & 3));
}

// out += v, fire and forget (a RED: no value comes back).
__device__ __forceinline__ void red_add(int32_t* p, uint32_t v) {
  asm volatile("red.global.add.s32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "r"(v)
               : "memory");
}

// Writes the tile's int32 values to out (leading dimension ld): direct,
// out[orow0 + r][ocol0 + c] = tile(r, c); transposed, the same with
// tile(c, r). Only outputs with row < orows and column < ocols are
// written; with kAdd they are added (red_add) instead of stored.
template <bool kPacked, bool kAdd>
__device__ __forceinline__ void store_tile(const uint32_t (&acc)[8][8],
                                           uint32_t* smem,
                                           int32_t* __restrict__ out,
                                           int64_t ld, int64_t orow0,
                                           int64_t orows, int64_t ocol0,
                                           int64_t ocols, bool transpose) {
  using T = Tiling<kPacked>;
  const int tx = threadIdx.x % T::kTX, ty = threadIdx.x / T::kTX;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int kWarps = T::kThreads / 32;
  const int64_t ncol = ocols - ocol0 < kTile ? ocols - ocol0 : kTile;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __syncthreads();  // the stage, or the last half, is read out
    if (!transpose) {
      // Tile rows 64h + 4ty + ii, each as 16-byte chunks of 4 columns.
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * h + ii, lr = 4 * ty + ii;
        if constexpr (kPacked) {
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            const int lc = (j >> 2) * 64 + 8 * tx + 2 * (j & 3);
            *reinterpret_cast<uint4*>(smem + out_index(lr, lc)) =
                make_uint4(lane_of<true>(acc[i][j], 0), lane_of<true>(acc[i][j], 1),
                           lane_of<true>(acc[i][j + 1], 0), lane_of<true>(acc[i][j + 1], 1));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; j += 4) {
            const int lc = (j >> 2) * 64 + 4 * tx;
            *reinterpret_cast<uint4*>(smem + out_index(lr, lc)) =
                make_uint4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
          }
        }
      }
    } else {
      // Tile columns 64h + ..., each as two chunks of 4 tile rows.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * h + jj;
#pragma unroll
        for (int l = 0; l < (kPacked ? 2 : 1); ++l) {
          const int lr = kPacked ? 8 * tx + 2 * jj + l : 4 * tx + jj;
#pragma unroll
          for (int g = 0; g < 2; ++g)
            *reinterpret_cast<uint4*>(smem + out_index(lr, 64 * g + 4 * ty)) =
                make_uint4(lane_of<kPacked>(acc[4 * g][j], l),
                           lane_of<kPacked>(acc[4 * g + 1][j], l),
                           lane_of<kPacked>(acc[4 * g + 2][j], l),
                           lane_of<kPacked>(acc[4 * g + 3][j], l));
        }
      }
    }
    __syncthreads();
    // A warp writes whole output rows: scalars up to the first 16-byte
    // boundary, 16-byte chunks, then the scalars left.
    for (int lr = warp; lr < 64; lr += kWarps) {
      const int64_t orow = orow0 + 64 * h + lr;
      if (orow >= orows) break;
      int32_t* dst = out + orow * ld + ocol0;
      if constexpr (kAdd) {
        // Lane l adds columns l, l + 32, ...: 128-byte runs a warp.
#pragma unroll
        for (int q = 0; q < kTile / 32; ++q) {
          const int lc = lane + 32 * q;
          if (lc < ncol) red_add(dst + lc, smem[out_index(lr, lc)]);
        }
        continue;
      }
      int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
      if (head > ncol) head = static_cast<int>(ncol);
      const int nbody = static_cast<int>(ncol - head) >> 2;
      const int tail = static_cast<int>(ncol - head) & 3;
      if (lane < nbody) {
        const int lc = head + 4 * lane;
        uint4 v;
        if ((head & 1) == 0) {
          const uint2 lo = *reinterpret_cast<const uint2*>(smem + out_index(lr, lc));
          const uint2 hi = *reinterpret_cast<const uint2*>(smem + out_index(lr, lc + 2));
          v = make_uint4(lo.x, lo.y, hi.x, hi.y);
        } else {
          v = make_uint4(smem[out_index(lr, lc)], smem[out_index(lr, lc + 1)],
                         smem[out_index(lr, lc + 2)], smem[out_index(lr, lc + 3)]);
        }
        *reinterpret_cast<uint4*>(dst + lc) = v;
      }
      if (lane < head) dst[lane] = static_cast<int32_t>(smem[out_index(lr, lane)]);
      if (lane < tail) {
        const int lc = head + 4 * nbody + lane;
        dst[lc] = static_cast<int32_t>(smem[out_index(lr, lc)]);
      }
    }
  }
}

// With kSplit, blockIdx.y is the bin slice, of ``slice`` bins (a multiple
// of kBK), and the tiles are added into a zeroed out.
template <bool kPacked, bool kSplit>
__global__ void __launch_bounds__(Tiling<kPacked>::kThreads, Tiling<kPacked>::kMinBlocks)
min_sum_tri_kernel(const int32_t* __restrict__ A, int64_t S, int64_t B,
                   int64_t nt, int64_t slice, uint32_t one,
                   int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t smem[kSmemWords];
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

  int64_t b_begin = 0, b_end = B;
  if constexpr (kSplit) {
    b_begin = static_cast<int64_t>(blockIdx.y) * slice;
    b_end = b_begin + slice < B ? b_begin + slice : B;
  }

  uint32_t acc[8][8];
  tile_min_sum<kPacked>(A, S, A, S, B, r0, c0, b_begin, b_end, one, smem, acc);
  store_tile<kPacked, kSplit>(acc, smem, out, S, r0, S, c0, S, false);
  if (ti != tj) store_tile<kPacked, kSplit>(acc, smem, out, S, c0, S, r0, S, true);
}

// blockIdx.x is the column tile, or with kSplit slice * cols + the
// column tile (slices of ``slice`` bins, added into a zeroed out).
template <bool kPacked, bool kSplit>
__global__ void __launch_bounds__(Tiling<kPacked>::kThreads, Tiling<kPacked>::kMinBlocks)
min_sum_rect_kernel(const int32_t* __restrict__ A, int64_t S,
                    const int32_t* __restrict__ C, int64_t S2, int64_t B,
                    int64_t cols, int64_t slice, uint32_t one,
                    int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t smem[kSmemWords];
  int64_t ct = blockIdx.x, b_begin = 0, b_end = B;
  if constexpr (kSplit) {
    const int64_t s = ct / cols;
    ct -= s * cols;
    b_begin = s * slice;
    b_end = b_begin + slice < B ? b_begin + slice : B;
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t c0 = ct * kTile;
  uint32_t acc[8][8];
  tile_min_sum<kPacked>(A, S, C, S2, B, r0, c0, b_begin, b_end, one, smem, acc);
  store_tile<kPacked, kSplit>(acc, smem, out, S2, r0, S, c0, S2, false);
}

// The bin slices of ``slice`` bins a slice over B bins: ceil(B / slice),
// where slice is below B; 1 (the unsplit kernel) where it is B or more.
// -1 for a slice below B that is not a positive multiple of kBK.
inline long long bin_slices(long long B, long long slice) {
  if (slice >= B) return 1;
  if (slice <= 0 || slice % kBK != 0) return -1;
  return (B + slice - 1) / slice;
}

template <bool kPacked>
int launch_tri(const int32_t* a, long long S, long long B, long long slice,
               int32_t* out, void* stream) {
  const long long parts = bin_slices(B, slice);
  if (parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0) return 0;
  const long long nt = (S + kTile - 1) / kTile;
  const long long tiles = nt * (nt + 1) / 2;
  if (tiles > 0x7FFFFFFFLL || parts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (parts == 1) {
    min_sum_tri_kernel<kPacked, false>
        <<<static_cast<unsigned>(tiles), Tiling<kPacked>::kThreads, 0, st>>>(
            a, S, B, nt, B, 1u, out);
  } else {
    const cudaError_t e = cudaMemsetAsync(out, 0, S * S * sizeof(int32_t), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 blocks(static_cast<unsigned>(tiles), static_cast<unsigned>(parts));
    min_sum_tri_kernel<kPacked, true>
        <<<blocks, Tiling<kPacked>::kThreads, 0, st>>>(a, S, B, nt, slice, 1u, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kPacked>
int launch_rect(const int32_t* a, long long S, const int32_t* c, long long S2,
                long long B, long long slice, int32_t* out, void* stream) {
  const long long parts = bin_slices(B, slice);
  if (parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S2 <= 0) return 0;
  const long long rows = (S + kTile - 1) / kTile;
  const long long cols = (S2 + kTile - 1) / kTile;
  if (rows > 65535 || cols * parts > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 blocks(static_cast<unsigned>(cols * parts), static_cast<unsigned>(rows));
  if (parts == 1) {
    min_sum_rect_kernel<kPacked, false><<<blocks, Tiling<kPacked>::kThreads, 0, st>>>(
        a, S, c, S2, B, cols, B, 1u, out);
  } else {
    const cudaError_t e = cudaMemsetAsync(out, 0, S * S2 * sizeof(int32_t), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    min_sum_rect_kernel<kPacked, true><<<blocks, Tiling<kPacked>::kThreads, 0, st>>>(
        a, S, c, S2, B, cols, slice, 1u, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a int32 [S, B] -> out int32 [S, S], the full symmetric min-sum matrix,
// on 32-bit lanes, over bin slices of ``slice`` bins (B or more: no split;
// below B a multiple of kBK, and out must be contiguous, since it is
// zeroed whole). Returns the cudaError_t of the launch (of the memset
// before it, where that fails).
extern "C" int kp_min_sum_tri(const int32_t* a, long long S, long long B,
                              long long slice, int32_t* out, void* stream) {
  return launch_tri<false>(a, S, B, slice, out, stream);
}

// The same on packed 16-bit lanes: only for counts that are all >= 0 with
// every row sum below 2^16.
extern "C" int kp_min_sum_tri_u16x2(const int32_t* a, long long S,
                                    long long B, long long slice, int32_t* out,
                                    void* stream) {
  return launch_tri<true>(a, S, B, slice, out, stream);
}

// a int32 [S, B], c int32 [S2, B] -> out int32 [S, S2], on 32-bit lanes,
// over bin slices of ``slice`` bins, as kp_min_sum_tri. Returns the
// cudaError_t.
extern "C" int kp_min_sum_rect(const int32_t* a, long long S, const int32_t* c,
                               long long S2, long long B, long long slice,
                               int32_t* out, void* stream) {
  return launch_rect<false>(a, S, c, S2, B, slice, out, stream);
}

// The same on packed 16-bit lanes: only for counts that are all >= 0 where
// a's or c's largest row sum is below 2^16.
extern "C" int kp_min_sum_rect_u16x2(const int32_t* a, long long S,
                                     const int32_t* c, long long S2,
                                     long long B, long long slice, int32_t* out,
                                     void* stream) {
  return launch_rect<true>(a, S, c, S2, B, slice, out, stream);
}
