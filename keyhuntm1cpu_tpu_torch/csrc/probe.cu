// Filter probe for Hopper (sm_90a):
//   kh_probe  replaces keyhuntm1cpu_tpu/filter/bitmap.py _dma_gather_kernel / dma_gather
//             (words[idx]) fused with the bit test of probe / probe_bloom2
// Wrappers and plain torch versions: keyhuntm1cpu_tpu_torch/filter/bitmap.py.
//
// For each 64-bit key (qhi, qlo) it reads the filter word(s) the key maps
// to and writes one mask byte: set when the key's bit is set (the level-1
// direct-address bitmap: the key's low bits_log2 bits), or, in bloom2 form,
// when both of its k = 2 hashed bits are set (fmix32 mixes of the key, with
// index-extension mixes past 2^32 bits). Index math is bitmap.py's, bit for
// bit.
//
// Bound on the H100: memory. Each probe reads one random word of a filter
// that is far larger than the 50 MB L2 at the sizes the engines use (2^34
// and 2^35 bits: 2 and 4 GiB), and DRAM serves at least one 32-byte sector
// per random read, so a probe moves 32 B (64 B in bloom2 form) plus its 8 B
// key and 1 B mask. The TPU kernel issued one 4-byte DMA per query from a
// scalar loop to keep many reads in flight; on Hopper the memory-level
// parallelism comes from threads: one thread per query, the key loads
// coalesced, the word read through the read-only path (__ldg), thousands of
// independent reads in flight. Word offsets are 64-bit (a 2^35-bit filter
// has 2^30 words).
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Bit (ext:h) mod 2^bits of the filter: word = low bits of ext:h >> 5,
// bit = h & 31 (bitmap.py _low_bits_index).
__device__ __forceinline__ bool test_bit(const uint32_t* __restrict__ words, uint32_t h,
                                         uint32_t ext, int bits) {
  unsigned long long word;
  uint32_t bit;
  if (bits > 32) {
    const uint32_t emask = (1u << (bits - 32)) - 1u;
    word = (unsigned long long)(h >> 5) | ((unsigned long long)(ext & emask) << 27);
    bit = h & 31u;
  } else {
    const uint32_t idx = bits == 32 ? h : (h & ((1u << bits) - 1u));
    word = idx >> 5;
    bit = idx & 31u;
  }
  return (__ldg(words + word) >> bit) & 1u;
}

template <bool BLOOM2>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ qhi,
             const uint32_t* __restrict__ qlo, uint8_t* __restrict__ mask, long long n,
             int bits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t hi = qhi[i], lo = qlo[i];
  bool hit;
  if constexpr (BLOOM2) {
    const uint32_t h1 = fmix32(lo ^ (hi * 0x9E3779B1u) ^ 0x2545F491u);
    const uint32_t h2 = fmix32(hi ^ (lo * 0x85EBCA77u) ^ 0x633D9ABDu);
    uint32_t e1 = 0, e2 = 0;
    if (bits > 32) {  // index-extension mixes (bitmap.bloom2_ext_hashes)
      e1 = fmix32(hi ^ (lo * 0xC2B2AE3Du) ^ 0x27D4EB2Fu);
      e2 = fmix32(lo ^ (hi * 0x165667B1u) ^ 0x9E3779B9u);
    }
    // both reads are issued before either result is needed
    const bool b1 = test_bit(words, h1, e1, bits);
    const bool b2 = test_bit(words, h2, e2, bits);
    hit = b1 && b2;
  } else {
    hit = test_bit(words, lo, hi, bits);  // direct address: the key's low bits
  }
  mask[i] = hit ? 1 : 0;
}

}  // namespace

extern "C" int kh_probe(const void* words, const void* qhi, const void* qlo, void* mask,
                        long long n, int bits, int bloom2, void* stream) {
  if (n < 1 || bits < 5 || bits > 35) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (bloom2) {
    probe_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo, (uint8_t*)mask, n,
        bits);
  } else {
    probe_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const uint32_t*)words, (const uint32_t*)qhi, (const uint32_t*)qlo, (uint8_t*)mask, n,
        bits);
  }
  return (int)cudaGetLastError();
}
