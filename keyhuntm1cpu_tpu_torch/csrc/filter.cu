// K3 kh_insert_keys: OR keys into the BSGS bitmap and level-2 bloom, into
// a brute target bitmap alone, or into a level-2 bloom alone.
//
// Replaces the XLA composition in keyhuntm1cpu_tpu/engine/bsgs.py
// _filters_stream_impl (bitmap_bit_planes + bloom2_bit_planes +
// or_bits_into, filter/bitmap.py) and the on-device bitmap build of
// filter/bitmap.py build_bitmap (np.unique, then _scatter_bits). Those sort
// each batch and run a segmented OR, or deduplicate first, because XLA has
// no scatter-OR; Hopper has atomicOr, so the kernel is elementwise over the
// keys and needs neither a sort nor a deduplication (an OR of a bit that is
// set already changes nothing). Index math is filter/bitmap.py's, bit for
// bit; plain torch version: keyhuntm1cpu_tpu_torch/filter/bitmap.py
// insert_keys_ref.
//
// Forms, one kernel: the first n_keep keys are inserted (the streaming
// build's last step keeps a prefix, so a count replaces a mask); words2 may
// be null (the bitmap alone: a brute target set, 8 bytes a target
// uploaded instead of the whole bitmap, or a device-resolve table's
// bitmap), or words1 (the bloom alone: a device-resolve table's level-2
// bloom, filter/bitmap.py build_bloom2_device, which the JAX package
// builds by a sort and a scatter-add, _build_bloom2_words); with a `bad`
// counter the kernel
// also counts the walk's degenerate lanes among the kept keys and the
// advance flags (one ballot a warp, one atomicAdd a warp that saw one), so
// the build step's check needs no torch ops.
//
// Bound on the H100: random 4-byte atomics into filters far larger than the
// 50 MB L2 (3 per kept key into 4 GiB arrays on the main path), each a DRAM
// sector read and written back. The atomics' results are unused, so they
// compile to fire-and-forget reductions (RED.E.OR) and a thread issues all
// three of a key before it moves on. scripts/torch_filter_shapes.py measures
// the card's random read-modify-write ceiling and the other shapes (a thread
// an atomic, one wave of resident blocks, 512-thread blocks, inline
// red.global.or.b32). Word addresses are 64-bit (2^30 words = 4 GiB, so byte
// offsets pass 2^32).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSM = 64;  // grid-stride past this many blocks an SM

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

// The key's three bits: the bitmap's (its low bits), and with w2 the two
// bloom2 bits.
__device__ __forceinline__ void insert_key(uint32_t* __restrict__ w1, uint32_t* __restrict__ w2,
                                           uint32_t hi, uint32_t lo, int bits, int b2bits) {
  if (w1 != nullptr) set_bit(w1, lo, hi, bits);  // direct-address bitmap: the key's low bits
  if (w2 == nullptr) return;
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

// One warp's count of set flags, added to *bad by lane 0 when non-zero.
__device__ __forceinline__ void count_flags(bool flag, unsigned long long* bad) {
  const uint32_t b = __ballot_sync(0xFFFFFFFFu, flag);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(bad, (unsigned long long)__popc(b));
}

// The warps stride over the keys together (every lane of a warp takes the
// same trips, so the ballot sees the whole warp).
__global__ void __launch_bounds__(kThreads)
insert_keys_kernel(uint32_t* __restrict__ w1, uint32_t* __restrict__ w2,
                   const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
                   long long n, const uint8_t* __restrict__ deg,
                   const uint8_t* __restrict__ adeg, int n_adeg,
                   unsigned long long* __restrict__ bad, int bits, int b2bits) {
  const long long stride = (long long)gridDim.x * kThreads;
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31); base < n;
       base += stride) {
    const long long i = base + lane;
    const bool in = i < n;
    if (in) insert_key(w1, w2, __ldg(qhi + i), __ldg(qlo + i), bits, b2bits);
    if (bad != nullptr) count_flags(in && deg[i], bad);
  }
  if (bad != nullptr && blockIdx.x == 0 && threadIdx.x < 32) {
    for (int j0 = 0; j0 < n_adeg; j0 += 32) count_flags(j0 + lane < n_adeg && adeg[j0 + lane], bad);
  }
}

}  // namespace

// Either words1 or words2 may be null, and deg, adeg and bad (together).
extern "C" int kh_insert_keys(void* words1, void* words2, const void* qhi, const void* qlo,
                              long long n_keep, const void* deg, const void* adeg, int n_adeg,
                              void* bad, int bits, int b2bits, void* stream) {
  if (n_keep < 0 || n_adeg < 0 || (words1 == nullptr && words2 == nullptr) ||
      (words1 != nullptr && (bits < 5 || bits > 35)) ||
      (words2 != nullptr && (b2bits < 5 || b2bits > 35)) ||
      (bad != nullptr && (deg == nullptr || (n_adeg > 0 && adeg == nullptr))))
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  long long blocks = (n_keep + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kMaxBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // the advance flags are counted even with no key kept
  insert_keys_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)words1, (uint32_t*)words2, (const uint32_t*)qhi, (const uint32_t*)qlo, n_keep,
      (const uint8_t*)deg, (const uint8_t*)adeg, n_adeg, (unsigned long long*)bad, bits,
      b2bits);
  return (int)cudaGetLastError();
}
