// The level-1 bitmap's index math and word load, shared by the probe
// kernels (csrc/probe.cu) and K2, which probes its walk keys as it emits
// them (csrc/pwalk.cu). Index math is filter/bitmap.py's, bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace kh {

// One filter word through the read-only path; with NO_L1 not kept in L1
// (the reads have no reuse: the fused form at 4,194,304 keys ran 2.6 %
// faster so, but the mask form at 131,088 keys 40 % slower, so it keeps
// __ldg; scripts/torch_probe_shapes.py times both).
template <bool NO_L1>
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  if constexpr (NO_L1) {
    uint32_t v;
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
  } else {
    return __ldg(p);
  }
}

// Word and bit of bit (ext:h) mod 2^bits: word = low bits of ext:h >> 5,
// bit = h & 31 (bitmap.py _low_bits_index). The level-1 bitmap takes h =
// the key's low word, ext = its high word.
__device__ __forceinline__ unsigned long long word_of(uint32_t h, uint32_t ext, int bits) {
  if (bits > 32) {
    const uint32_t emask = (1u << (bits - 32)) - 1u;
    return (unsigned long long)(h >> 5) | ((unsigned long long)(ext & emask) << 27);
  }
  return (bits == 32 ? h : (h & ((1u << bits) - 1u))) >> 5;
}

}  // namespace kh
