// Device helpers for the u32 plane pair that K1/K1m (encode_packed.cu) and
// K5 (histogram.cu) read: words_le holds base j of a word at bits 2j;
// inval_be holds digit 11 at bits 30-2j where base j is invalid.
//
// Included by the sources that use it; ops/kernels.library_path hashes it
// with them.

#pragma once

#include <cstdint>

namespace {

// Reverse the 16 2-bit digits of x.
__device__ __forceinline__ uint32_t digit_rev32(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* __restrict__ p,
                                                 int64_t i, int64_t n) {
  return i < n ? __ldg(p + i) : 0u;
}

// The validity bits of 16 bases from their inval_be plane word (digit 11 at
// bits 30-2j where base j is invalid): bit j set where base j is valid.
__device__ __forceinline__ uint32_t valid16(uint32_t inval_be) {
  uint32_t x = digit_rev32(inval_be);  // base j at bits 2j
  x = (x | (x >> 1)) & 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return ~x & 0xFFFFu;
}

}  // namespace
