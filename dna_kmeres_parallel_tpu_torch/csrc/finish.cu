// The float32 finish of the k-mer distances for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package finishes on the host
// (dna_kmeres_parallel_tpu/ops/distance.py, finish_distances), because
// XLA's float32 divide is 1 ulp off IEEE on some backends, and the
// distances must carry the bits of the reference program, which divided
// with correct rounding (x86 divss, CUDA's prec-div: main.cu:614,
// kernels.h:105). On this card __fdiv_rn is correctly rounded, and the
// library is built without --use_fast_math (ops/kernels.py), so the finish
// runs here with the host's bits, and only the packed float32 triangle
// crosses to the host: half the bytes of the int32 [S, S] square, and no
// host pass over them.
//
// out[p] = 1 - s / (min(L_i, L_j) - k + 1) over the strict upper triangle
// of a panel of int32 min-sums, in the packed order of
// ops/distance.finish_upper: row i of the panel is sequence r0 + i, column
// j is sequence base + j, and row i keeps the columns
// j >= i + r0 + 1 - base (clamped to [0, C]), one row after another. Each
// value is
//   __fsub_rn(1, __fdiv_rn(__int2float_rn(s), __ll2float_rn(min(L_i, L_j) - k + 1)))
// and a NaN (0 / 0, where the shorter record holds no k-mer: min(L) =
// k - 1) is written with NumPy's bits on x86, 0xFFC00000: the CSV writer's
// %f prints "-nan" for it, and "nan" for CUDA's own 0x7FFFFFFF.
//
// What bounds it on this card: bytes. Each kept int32 is read once and one
// float32 written: at 54,018 records 1.46e9 pairs, 11.7 GB, 3.5 ms at
// 3.35 TB/s. The lengths, 8 bytes a column that every row reads again,
// stay in L1 and L2 (432 KB at 54,018 records).
//
// What the design does about it. A block takes one row at a time (a
// grid-stride loop over the rows, so no grid dimension limits R), and its
// threads take neighbouring groups of four columns of the row's tail.
// Where the row starts in the output is closed-form prefix arithmetic in
// 64 bits (the output holds 1.46e9 elements), not a table from the host.
// Stores are 16 bytes, aligned: a scalar head brings the row to a 16-byte
// boundary of the output and a scalar tail ends it. Loads are 16 bytes
// too: where the input's alignment differs from the output's (the rows
// start at i * ld + f), a thread reads the two aligned 16-byte words that
// hold its four values and selects; its neighbour reads the second word as
// well, from L1, so device memory still sees each byte once. The output,
// never read again here, is written with streaming stores.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// blocks a launch starts at most; each walks rows with a grid stride
constexpr long long kMaxBlocks = 1LL << 30;
// NumPy's float32 NaN on x86 (0 / 0 gives the default NaN, sign set)
constexpr unsigned kNumpyNan = 0xFFC00000u;

// Sum over u = 0 .. x - 1 of min(u, C), 0 for x <= 0: the columns that
// the rows before a row leave out, when row t leaves out clamp(t + d, 0, C)
// of them (rows 0 .. i - 1 leave out skipped(i + d) - skipped(d)).
__device__ __forceinline__ long long skipped(long long x, long long C) {
  if (x <= 0) return 0;
  if (x <= C + 1) return x * (x - 1) / 2;
  return C * (C + 1) / 2 + (x - C - 1) * C;
}

// One distance: a = L_i - k + 1 of the row, b = L_j - k + 1 of the
// column (min(a, b) = min(L_i, L_j) - k + 1).
__device__ __forceinline__ float finish_one(int32_t s, long long a, long long b) {
  const float q = __fdiv_rn(__int2float_rn(s), __ll2float_rn(a < b ? a : b));
  const float d = __fsub_rn(1.0f, q);
  return d != d ? __uint_as_float(kNumpyNan) : d;  // NaN
}

// The four values that start m (1..3) places into the two aligned words
// lo, hi.
__device__ __forceinline__ int4 shifted(const int4 lo, const int4 hi, unsigned m) {
  if (m == 1) return make_int4(lo.y, lo.z, lo.w, hi.x);
  if (m == 2) return make_int4(lo.z, lo.w, hi.x, hi.y);
  return make_int4(lo.w, hi.x, hi.y, hi.z);
}

__global__ void __launch_bounds__(kThreads)
finish_upper_kernel(const int32_t* __restrict__ sums, long long R, long long C,
                    long long ld, const long long* __restrict__ len_rows,
                    const long long* __restrict__ len_cols, long long k, long long d,
                    float* __restrict__ out) {
  const long long k1 = k - 1;
  const long long skipped0 = skipped(d, C);
  for (long long i = blockIdx.x; i < R; i += gridDim.x) {
    const long long f = min(max(i + d, 0LL), C);  // the row's first column
    const long long n = C - f;
    if (n == 0) continue;
    const int32_t* src = sums + i * ld + f;
    const long long* lc = len_cols + f;
    float* dst = out + (i * C - (skipped(i + d, C) - skipped0));
    const long long a = len_rows[i] - k1;
    // scalars up to the output's next 16-byte boundary
    const long long head =
        min(static_cast<long long>((0u - static_cast<unsigned>(
                                        reinterpret_cast<uintptr_t>(dst) >> 2)) & 3u),
            n);
    for (long long j = threadIdx.x; j < head; j += kThreads)
      dst[j] = finish_one(src[j], a, lc[j] - k1);
    const long long body = (n - head) >> 2;
    const int32_t* s = src + head;
    const long long* l = lc + head;
    float4* o = reinterpret_cast<float4*>(dst + head);
    const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(s) >> 2) & 3u;
    const int4* w = reinterpret_cast<const int4*>(s - mis);
    for (long long v = threadIdx.x; v < body; v += kThreads) {
      // mis is the row's: every thread of the block takes the same branch
      const int4 x = mis == 0 ? w[v] : shifted(w[v], w[v + 1], mis);
      const long long* lj = l + 4 * v;
      float4 y;
      y.x = finish_one(x.x, a, lj[0] - k1);
      y.y = finish_one(x.y, a, lj[1] - k1);
      y.z = finish_one(x.z, a, lj[2] - k1);
      y.w = finish_one(x.w, a, lj[3] - k1);
      __stcs(o + v, y);
    }
    for (long long j = head + 4 * body + threadIdx.x; j < n; j += kThreads)
      dst[j] = finish_one(src[j], a, lc[j] - k1);
  }
}

}  // namespace

// sums int32 [R, C] with row stride ld (elements; columns contiguous),
// lengths_rows int64 [R], lengths_cols int64 [C] -> out float32, the
// packed strict upper triangle (ops/distance.packed_upper_size(R, C, r0,
// base) elements), on ``stream``. Allocates nothing. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a negative size or
// a row stride below C).
extern "C" int kp_finish_upper(const int32_t* sums, long long R, long long C, long long ld,
                               const long long* lengths_rows,
                               const long long* lengths_cols, long long k, long long r0,
                               long long base, float* out, void* stream) {
  if (R < 0 || C < 0 || (R > 1 && ld < C)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || C == 0) return 0;
  const long long blocks = R < kMaxBlocks ? R : kMaxBlocks;
  finish_upper_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      sums, R, C, ld, lengths_rows, lengths_cols, k, r0 + 1 - base, out);
  return static_cast<int>(cudaGetLastError());
}
