// u8-stream window encoder (K9) for Hopper, sm_90a.
//
// Replaces the TPU kernel
//   dna_kmeres_parallel_tpu/ops/encode_pallas.py::rolling_codes_split_pallas
//   (body _make_encode_kernel), without its benchmark hooks (salt, sig).
//
// Input: a u8 base stream of T bases (0..3 = A, C, G, T; any other byte is
// invalid, 0xFF separates records) and n_own.
// Output, for every window start p in [0, T), in stream order:
//   lo  int32: the last min(k, 16) bases of the window's 2k-bit code;
//   hi  int16 (16 <= k <= 23) or int32 (k >= 24): the first k - 16 bases;
//       no hi plane for k <= 15.
// A window is valid iff p < n_own, p + k <= T and none of its k bases is
// invalid; an invalid window holds all-ones in every plane, so the last
// k - 1 slots are always sentinels. With canonical set, the code is the
// smaller of the window and its reverse complement (the lexicographic min
// of (hi, lo), since the split preserves order). The TPU kernel returns
// T rounded up to its tile span; the extra slots there are all sentinels.
//
// Design: a block owns kTile consecutive window starts. It stages its
// bases plus a 32-base halo in shared memory with 16-byte loads, bytes past
// T reading as invalid. Thread t owns the kPerThread consecutive windows
// that start at 8t of the tile: it rolls the forward code and the reverse
// complement over bases [8t, 8t + k + 7), k + 7 steps for 8 windows (one
// 8-byte shared load per 8 bases), and counts the run of valid bases: a
// window is valid when its last base ends a run of k. The codes go through
// a shared-memory stage (a row of 9 words per thread, so the stride-8
// writes miss each other's banks) and leave in stream order, neighbouring
// threads storing to neighbouring addresses.
//
// Bound: the stores. A window costs 1 B read and 4 B of output for
// k <= 15, 6 B for 16-23 and 8 B for k >= 24, so the kernel is a
// streaming write at device-memory bandwidth. The TPU body's doubling
// ladder of lane rolls is a layout device of the TPU's vector unit and has
// no counterpart here.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // window starts per block
// Bases a thread reads past its first: k + 7 <= 38, in five 8-byte words,
// so the last thread reads up to kTile + 32.
constexpr int kHalo = 32;
constexpr int kRow = kPerThread + 1;  // staged words per thread

template <int HI_BYTES>
__global__ void __launch_bounds__(kThreads)
encode_stream_kernel(const uint8_t* __restrict__ bases, int64_t T,
                     int64_t n_own, int k, bool canonical,
                     int32_t* __restrict__ lo_out, void* __restrict__ hi_out) {
  // k <= 15 fits 32-bit codes; longer windows need 64.
  using Code = std::conditional_t<HI_BYTES == 0, uint32_t, uint64_t>;
  __shared__ __align__(16) uint8_t tile[kTile + kHalo];
  __shared__ int32_t lo_s[kThreads * kRow];
  __shared__ int32_t hi_s[HI_BYTES ? kThreads * kRow : 1];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const bool aligned = (reinterpret_cast<uintptr_t>(bases) & 15) == 0;
  for (int v = threadIdx.x; v < (kTile + kHalo) / 16; v += kThreads) {
    const int64_t g = t0 + 16 * static_cast<int64_t>(v);
    uint4 w;
    if (aligned && g + 16 <= T) {
      w = __ldg(reinterpret_cast<const uint4*>(bases + g));
    } else {
      uint32_t word[4];
      for (int q = 0; q < 4; q++) {
        uint32_t x = 0;
        for (int i = 0; i < 4; i++) {
          const int64_t at = g + 4 * q + i;
          const uint32_t b = at < T ? bases[at] : 0xFFu;
          x |= b << (8 * i);
        }
        word[q] = x;
      }
      w = make_uint4(word[0], word[1], word[2], word[3]);
    }
    reinterpret_cast<uint4*>(tile)[v] = w;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int64_t first = t0 + kPerThread * t;  // this thread's first window
  const Code mask =
      static_cast<Code>((static_cast<uint64_t>(1) << (2 * k)) - 1);
  const int rc_shift = 2 * (k - 1);
  const int steps = k + kPerThread - 1;
  const uint64_t* row = reinterpret_cast<const uint64_t*>(tile) + t;
  Code fwd = 0, rc = 0;
  int run = 0;
  for (int w = 0; 8 * w < steps; w++) {
    const uint64_t word = row[w];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const int s = 8 * w + i;
      if (s < steps) {
        const uint32_t b = static_cast<uint32_t>(word >> (8 * i)) & 0xFFu;
        const Code d = b & 3u;
        fwd = ((fwd << 2) | d) & mask;
        rc = (rc >> 2) | ((3 - d) << rc_shift);
        run = b < 4 ? run + 1 : 0;
        const int j = s - (k - 1);  // the window this base completes
        if (j >= 0) {
          const bool valid = run >= k && first + j < n_own;
          const Code code = canonical && rc < fwd ? rc : fwd;
          lo_s[kRow * t + j] =
              valid ? static_cast<int32_t>(static_cast<uint32_t>(code)) : -1;
          if constexpr (HI_BYTES != 0) {
            hi_s[kRow * t + j] =
                valid ? static_cast<int32_t>(static_cast<uint64_t>(code) >> 32)
                      : -1;
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = 0; i < kPerThread; i++) {
    const int c = i * kThreads + t;
    const int64_t p = t0 + c;
    if (p >= T) break;
    const int at = kRow * (c / kPerThread) + c % kPerThread;
    lo_out[p] = lo_s[at];
    if constexpr (HI_BYTES == 2) {
      static_cast<int16_t*>(hi_out)[p] = static_cast<int16_t>(hi_s[at]);
    } else if constexpr (HI_BYTES == 4) {
      static_cast<int32_t*>(hi_out)[p] = hi_s[at];
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// hi_bytes must be 0 for k <= 15, 2 for 16 <= k <= 23 and 4 for k >= 24;
// lo (and hi) hold T slots.
extern "C" int kp_encode_stream(const void* bases, long long T,
                                long long n_own, int k, int canonical,
                                void* lo, void* hi, int hi_bytes,
                                void* stream) {
  const int want_hi = k <= 15 ? 0 : (k <= 23 ? 2 : 4);
  if (k < 1 || k > 31 || T <= 0 || hi_bytes != want_hi ||
      (hi_bytes && hi == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks64 = (static_cast<int64_t>(T) + kTile - 1) / kTile;
  if (blocks64 > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(blocks64);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint8_t*>(bases);
  auto lo32 = static_cast<int32_t*>(lo);
  const bool c = canonical != 0;
  switch (hi_bytes) {
    case 0:
      encode_stream_kernel<0><<<blocks, kThreads, 0, s>>>(b, T, n_own, k, c,
                                                          lo32, hi);
      break;
    case 2:
      encode_stream_kernel<2><<<blocks, kThreads, 0, s>>>(b, T, n_own, k, c,
                                                          lo32, hi);
      break;
    default:
      encode_stream_kernel<4><<<blocks, kThreads, 0, s>>>(b, T, n_own, k, c,
                                                          lo32, hi);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
