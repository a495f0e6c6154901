// K3 kh_insert_keys: OR keys into the BSGS bitmap and level-2 bloom.
//
// Replaces the XLA composition in keyhuntm1cpu_tpu/engine/bsgs.py
// _filters_stream_impl (bitmap_bit_planes + bloom2_bit_planes +
// or_bits_into, filter/bitmap.py). That composition sorts each batch and
// runs a Hillis-Steele segmented OR because XLA has no scatter-OR; Hopper
// has atomicOr, so the kernel is elementwise over the keys and needs no
// sort. Index math is filter/bitmap.py's, bit for bit; plain torch version:
// keyhuntm1cpu_tpu_torch/filter/bitmap.py insert_keys_ref.
//
// Bound on the H100: random 4-byte atomics into 4 GiB arrays (3 per kept
// key, each a DRAM sector read-modify-write in L2). The design issues all
// three atomics of a key from one thread with no other memory traffic
// beyond the coalesced key loads; word addresses are 64-bit (2^30 words =
// 4 GiB, so byte offsets pass 2^32).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Set bit (ext:h) mod 2^bits: word = low bits of ext:h >> 5, bit = h & 31.
__device__ __forceinline__ void set_bit(uint32_t* words, uint32_t h, uint32_t ext,
                                        int bits) {
  unsigned long long word;
  uint32_t bit;
  if (bits > 32) {
    uint32_t emask = (1u << (bits - 32)) - 1u;
    word = (unsigned long long)(h >> 5) | ((unsigned long long)(ext & emask) << 27);
    bit = h & 31u;
  } else {
    uint32_t idx = bits == 32 ? h : (h & ((1u << bits) - 1u));
    word = idx >> 5;
    bit = idx & 31u;
  }
  atomicOr(words + word, 1u << bit);
}

__global__ void insert_keys_kernel(uint32_t* __restrict__ w1, uint32_t* __restrict__ w2,
                                   const uint32_t* __restrict__ qhi,
                                   const uint32_t* __restrict__ qlo,
                                   const uint8_t* __restrict__ keep, long long n,
                                   int bits, int b2bits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!keep[i]) continue;
    const uint32_t hi = qhi[i], lo = qlo[i];
    set_bit(w1, lo, hi, bits);  // direct-address bitmap: the key's low bits
    const uint32_t h1 = fmix32(lo ^ (hi * 0x9E3779B1u) ^ 0x2545F491u);
    const uint32_t h2 = fmix32(hi ^ (lo * 0x85EBCA77u) ^ 0x633D9ABDu);
    uint32_t e1 = 0, e2 = 0;
    if (b2bits > 32) {  // index-extension mixes (bitmap.bloom2_ext_hashes)
      e1 = fmix32(hi ^ (lo * 0xC2B2AE3Du) ^ 0x27D4EB2Fu);
      e2 = fmix32(lo ^ (hi * 0x165667B1u) ^ 0x9E3779B9u);
    }
    set_bit(w2, h1, e1, b2bits);
    set_bit(w2, h2, e2, b2bits);
  }
}

}  // namespace

extern "C" int kh_insert_keys(void* words1, void* words2, const void* qhi,
                              const void* qlo, const void* keep, long long n,
                              int bits, int b2bits, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride past 64 blocks/SM
  insert_keys_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)words1, (uint32_t*)words2, (const uint32_t*)qhi,
      (const uint32_t*)qlo, (const uint8_t*)keep, n, bits, b2bits);
  return (int)cudaGetLastError();
}
