// The other reduction of K4's bin split, for scripts/min_sum_variants_probe.py:
// each bin slice's partial tile is stored into its own plane of an int32
// workspace [P, S, S2] (the stores of the unsplit kernel), and a second
// kernel sums the P planes into the output, where the port's kernel adds
// each partial into the zeroed output with red.global.add.s32.
//
// Built with -I dna_kmeres_parallel_tpu_torch/csrc: it includes the port's
// min_sum.cu and reuses its tiling, staging and stores unchanged.

#include "min_sum.cu"

namespace {

template <bool kPacked>
__global__ void __launch_bounds__(Tiling<kPacked>::kThreads, Tiling<kPacked>::kMinBlocks)
ws_rect_kernel(const int32_t* __restrict__ A, int64_t S,
               const int32_t* __restrict__ C, int64_t S2, int64_t B,
               int64_t cols, int64_t slice, uint32_t one,
               int32_t* __restrict__ ws) {
  __shared__ __align__(16) uint32_t smem[kSmemWords];
  const int64_t s = blockIdx.x / cols;
  const int64_t ct = blockIdx.x - s * cols;
  const int64_t b_begin = s * slice;
  const int64_t b_end = b_begin + slice < B ? b_begin + slice : B;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;
  uint32_t acc[8][8];
  tile_min_sum<kPacked>(A, S, C, S2, B, r0, ct * kTile, b_begin, b_end, one, smem, acc);
  store_tile<kPacked, false>(acc, smem, ws + s * S * S2, S2, r0, S, ct * kTile, S2, false);
}

// out[i] = the sum over the P planes of ws[p * n + i].
__global__ void ws_reduce_kernel(const int32_t* __restrict__ ws, int64_t n,
                                 int64_t P, int32_t* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    int32_t v = 0;
    for (int64_t p = 0; p < P; ++p) v += ws[p * n + i];
    out[i] = v;
  }
}

template <bool kPacked>
int launch_ws(const int32_t* a, long long S, const int32_t* c, long long S2,
              long long B, long long slice, int32_t* ws, int32_t* out, void* stream) {
  const long long parts = bin_slices(B, slice);
  if (parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S2 <= 0) return 0;
  const long long rows = (S + kTile - 1) / kTile;
  const long long cols = (S2 + kTile - 1) / kTile;
  if (rows > 65535 || cols * parts > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 blocks(static_cast<unsigned>(cols * parts), static_cast<unsigned>(rows));
  ws_rect_kernel<kPacked><<<blocks, Tiling<kPacked>::kThreads, 0, st>>>(
      a, S, c, S2, B, cols, slice, 1u, ws);
  const long long n = S * S2;
  long long grid = (n + 255) / 256;
  if (grid > 1056) grid = 1056;
  ws_reduce_kernel<<<static_cast<unsigned>(grid), 256, 0, st>>>(ws, n, parts, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 over bin slices of ``slice`` bins into a workspace of P x S x S2
// int32 (P = ceil(B / slice), as min_sum.cu's bin_slices), then summed
// into out.
extern "C" int kv_min_sum_rect_ws(const int32_t* a, long long S, const int32_t* c,
                                  long long S2, long long B, long long slice, int32_t* ws,
                                  int32_t* out, void* stream) {
  return launch_ws<false>(a, S, c, S2, B, slice, ws, out, stream);
}

extern "C" int kv_min_sum_rect_ws_u16x2(const int32_t* a, long long S, const int32_t* c,
                                        long long S2, long long B, long long slice,
                                        int32_t* ws, int32_t* out, void* stream) {
  return launch_ws<true>(a, S, c, S2, B, slice, ws, out, stream);
}
