// Candidates timed beside the port's K2 (counts matrix) and P1 (row roll)
// (dna_kmeres_parallel_tpu_torch/csrc/counts_matrix.cu and
// owner_segments.cu, included whole here, so this library also holds the
// kernels as built):
//   kv_old_counts_matrix  K2 as first ported: one block of 256 threads per
//                  row, one window a thread a step from k byte loads, one
//                  shared atomic per window, the bins cut into slices of
//                  8,192 across blockIdx.y, each slice re-reading the row;
//   kv_old_row_roll  P1 as first ported: one thread per element, a signed
//                  64-bit modulo each;
//   kv_roll_quads  P1 over whole quads: a lane reads 4 words with 4-byte
//                  loads and writes them as one 16-byte store;
//   kv_roll_quads_two  the same, each lane's 4 words from two aligned
//                  16-byte loads and a word select;
//   kv_roll_quads_stream  kv_roll_quads with streaming stores
//                  (st.global.cs) in place of plain ones.
// The quad kernels need W % 4 == 0 and 16-byte aligned tensors.
// K2's other candidates are text changes of counts_matrix.cu
// (counts_matrix_variants_probe.K2_VARIANTS). Built by
// scripts/counts_matrix_variants_probe.py with nvcc -I <csrc>; it is not
// part of the port's library.

#include "counts_matrix.cu"
#include "owner_segments.cu"

namespace {

constexpr int kOldThreads = 256;
constexpr int kOldChunkBins = 8192;

__global__ void __launch_bounds__(kOldThreads)
old_counts_kernel(const uint8_t* __restrict__ grid, int64_t L, int k, int canonical, int bins,
                  int chunk, int32_t* __restrict__ out) {
  extern __shared__ int32_t old_hist[];
  const int64_t row = blockIdx.x;
  const int b0 = blockIdx.y * chunk;
  const int nb = min(chunk, bins - b0);
  for (int i = threadIdx.x; i < nb; i += kOldThreads) old_hist[i] = 0;
  __syncthreads();
  const uint8_t* r = grid + row * L;
  const int64_t n = L - k + 1;
  for (int64_t p = threadIdx.x; p < n; p += kOldThreads) {
    uint32_t code = 0, rc = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      const uint32_t b = __ldg(r + p + j);
      ok &= b < 4;
      code = (code << 2) | (b & 3);
      rc |= (3u - (b & 3)) << (2 * j);
    }
    if (!ok) continue;
    if (canonical) code = min(code, rc);
    const int64_t c = static_cast<int64_t>(code) - b0;
    if (c >= 0 && c < nb) atomicAdd(&old_hist[c], 1);
  }
  __syncthreads();
  int32_t* o = out + row * bins + b0;
  for (int i = threadIdx.x; i < nb; i += kOldThreads) o[i] = old_hist[i];
}

__global__ void __launch_bounds__(kThreads)
old_row_roll_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ shift,
                    int64_t tiles, int W, int32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) / tiles;
  const int c = static_cast<int>(static_cast<int64_t>(blockIdx.x) % tiles) * kThreads +
                threadIdx.x;
  if (c >= W) return;
  const int64_t src = wrap(static_cast<int64_t>(c) + __ldg(shift + r), W);
  out[r * W + c] = __ldg(x + r * W + src);
}

template <bool kFourLoads, bool kStream>
__global__ void __launch_bounds__(kThreads)
roll_quads_variant(const int4* __restrict__ x, const int32_t* __restrict__ shift, int64_t R,
                   int nq, int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int W = 4 * nq;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kRollWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRollWarps + (threadIdx.x >> 5); r < R;
       r += n_warps) {
    const int s = row_shift(shift, r, W);
    const int m = s & 3;
    const int qs = nq - (s >> 2);
    const int4* xr = x + r * nq;
    int4* o = out + r * nq;
#pragma unroll 4
    for (int q = lane; q < nq; q += 32) {
      int4 v;
      if (kFourLoads) {
        const int32_t* xw = reinterpret_cast<const int32_t*>(xr);
        const int back = W - s;
        int w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * q + i;
          w[i] = __ldg(xw + (c < back ? c + W - back : c - back));
        }
        v = make_int4(w[0], w[1], w[2], w[3]);
      } else {
        const int q0 = q < qs ? q + nq - qs : q - qs;
        const int4 lo = __ldg(xr + q0);
        v = lo;
        if (m) {
          const int4 hi = __ldg(xr + (q0 + 1 == nq ? 0 : q0 + 1));
          v = m == 1 ? make_int4(lo.y, lo.z, lo.w, hi.x)
            : m == 2 ? make_int4(lo.z, lo.w, hi.x, hi.y)
                     : make_int4(lo.w, hi.x, hi.y, hi.z);
        }
      }
      if (kStream) {
        __stcs(o + q, v);
      } else {
        o[q] = v;
      }
    }
  }
}

unsigned roll_grid(int64_t R) {
  const int64_t blocks = (R + kRollWarps - 1) / kRollWarps;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int kv_old_counts_matrix(const uint8_t* grid, long long S, long long L, int k,
                                    int canonical, int bins, int32_t* out, void* stream) {
  if (S <= 0) return 0;
  const int chunk = bins < kOldChunkBins ? bins : kOldChunkBins;
  const dim3 blocks(static_cast<unsigned>(S), (bins + chunk - 1) / chunk);
  old_counts_kernel<<<blocks, kOldThreads, chunk * sizeof(int32_t),
                      static_cast<cudaStream_t>(stream)>>>(grid, L, k, canonical, bins, chunk,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_old_row_roll(const void* x, const void* shift, long long R, int W, void* out,
                               void* stream) {
  const int64_t tiles = (W + kThreads - 1) / kThreads;
  old_row_roll_kernel<<<static_cast<unsigned>(R * tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(shift), tiles, W,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_roll_quads(const void* x, const void* shift, long long R, int W, void* out,
                             void* stream) {
  roll_quads_variant<true, false><<<roll_grid(R), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<const int32_t*>(shift), R, W / 4,
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_roll_quads_two(const void* x, const void* shift, long long R, int W,
                                 void* out, void* stream) {
  roll_quads_variant<false, false><<<roll_grid(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<const int32_t*>(shift), R, W / 4,
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_roll_quads_stream(const void* x, const void* shift, long long R, int W,
                                    void* out, void* stream) {
  roll_quads_variant<true, true><<<roll_grid(R), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<const int32_t*>(shift), R, W / 4,
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
