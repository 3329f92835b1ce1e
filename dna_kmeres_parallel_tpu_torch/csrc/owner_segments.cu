// Owner-segment extraction (K10) and its unit probe, the per-row dynamic
// roll (P1), for Hopper, sm_90a.
//
// K10 replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/sort_pallas.py::extract_owner_segments
//   (body _make_extract_kernel), the write side of the row-partitioned raw
//   exchange (dna_kmeres_parallel_tpu/parallel/bucketed.py, row route).
// Input: one or two row-sorted planes [n_rows, row_w] of 32-bit words and
//   starts [n_rows, D+1] int32: owner d's segment of row r is
//   [starts[r, d], starts[r, d+1]).
// Output, per plane, [n_rows, D * row_cap]:
//   out[r, d*row_cap + c] = plane[r, (starts[r, d] + c) % row_w]
//   for c < min(starts[r, d+1] - starts[r, d], row_cap), all-ones elsewhere.
//   The modulo is the TPU kernel's roll; segments from sorted rows never
//   wrap. Longer segments are cut at row_cap: the caller gates on its
//   overflow flag.
//
// P1 replaces the probe scripts/dynroll_probe.py::run (kernel at :25),
//   which checked that Mosaic rolls a row by a shift read at run time:
//   out[r, c] = x[r, (c + shift[r]) mod W].
//
// K10's design: a gather with contiguous runs. One thread per output
// element; a block covers 256 consecutive columns of one (row, owner)
// slot, so it reads its two starts once and both its loads and its stores
// are coalesced along c. Both planes go through one launch. The TPU
// kernel's whole-tile rolls and sublane selects are a VMEM layout device
// and have no counterpart here.
//
// P1's design: a warp per row (grid-stride over rows), the row's shift
// reduced into [0, W) once, in 32 bits; a lane moves one word at a time,
// with coalesced 4-byte loads and stores, at any W and any alignment. On
// the card, whole quads of 4 words written as 16-byte stores ran within
// 2% of it at [32768, 2048] and slower at the path's [8, 256] tile; two
// aligned 16-byte loads and a word select ran 9% slower, and streaming
// stores tied (scripts/counts_matrix_variants_probe.py).
//
// Bound: bytes. K10 reads each plane once (4 B per word) and writes 4 B
// per send slot, D * row_cap slots per row (twice the row at the
// non-canonical 2x margin, four times canonical); P1 reads and writes 4 B
// per element. Neither does arithmetic worth counting.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads)
owner_segments_kernel(const int32_t* __restrict__ in0,
                      const int32_t* __restrict__ in1,
                      const int32_t* __restrict__ starts, int64_t tiles,
                      int row_w, int D, int row_cap, int32_t* __restrict__ out0,
                      int32_t* __restrict__ out1) {
  // Block b: slot b / tiles (= r * D + d), column tile b % tiles.
  const int64_t slot = static_cast<int64_t>(blockIdx.x) / tiles;
  const int c = static_cast<int>(static_cast<int64_t>(blockIdx.x) % tiles) *
                    kThreads +
                threadIdx.x;
  if (c >= row_cap) return;
  const int64_t r = slot / D;
  const int d = static_cast<int>(slot % D);
  const int32_t* st = starts + r * (D + 1) + d;
  const int32_t s = __ldg(st);
  const int32_t len = __ldg(st + 1) - s;
  const int64_t o = slot * row_cap + c;  // = r * D * row_cap + d * row_cap + c
  if (c < len) {
    const int64_t i = r * row_w + wrap(static_cast<int64_t>(s) + c, row_w);
    out0[o] = __ldg(in0 + i);
    if (in1 != nullptr) out1[o] = __ldg(in1 + i);
  } else {
    out0[o] = -1;
    if (in1 != nullptr) out1[o] = -1;
  }
}

constexpr int kRollWarps = kThreads / 32;

// Row r's shift reduced into [0, W).
__device__ __forceinline__ int row_shift(const int32_t* __restrict__ shift, int64_t r, int W) {
  const int s = __ldg(shift + r) % W;
  return s < 0 ? s + W : s;
}

// P1: one warp a row, one word a lane.
__global__ void __launch_bounds__(kThreads)
row_roll_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ shift,
                      int64_t R, int W, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kRollWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRollWarps + (threadIdx.x >> 5); r < R;
       r += n_warps) {
    const int back = W - row_shift(shift, r, W);  // in [1, W]
    const int32_t* xr = x + r * W;
    int32_t* o = out + r * W;
    for (int c = lane; c < W; c += 32) {
      const int i = c < back ? c + W - back : c - back;  // (c + shift) mod W
      o[c] = __ldg(xr + i);
    }
  }
}

constexpr int64_t kMaxBlocks = 0x7FFFFFFF;

}  // namespace

// K10. in1/out1 are null for one plane. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int kp_owner_segments(const void* in0, const void* in1,
                                 const void* starts, long long n_rows,
                                 int row_w, int D, int row_cap, void* out0,
                                 void* out1, void* stream) {
  const int64_t tiles = (row_cap + kThreads - 1) / kThreads;
  const int64_t blocks = static_cast<int64_t>(n_rows) * D * tiles;
  if (n_rows <= 0 || row_w <= 0 || D < 1 || row_cap <= 0 || blocks > kMaxBlocks ||
      (in1 == nullptr) != (out1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  owner_segments_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in0), static_cast<const int32_t*>(in1),
      static_cast<const int32_t*>(starts), tiles, row_w, D, row_cap,
      static_cast<int32_t*>(out0), static_cast<int32_t*>(out1));
  return static_cast<int>(cudaGetLastError());
}

// P1: out[r, c] = x[r, (c + shift[r]) mod W] over [R, W] int32, any int32
// shift and any W >= 1.
extern "C" int kp_row_roll(const void* x, const void* shift, long long R,
                           int W, void* out, void* stream) {
  if (R <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (R + kRollWarps - 1) / kRollWarps;
  const unsigned grid = static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  row_roll_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(shift), R, W,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
