// Standalone hash kernels for Hopper (sm_90a):
//   K7 kh_hash160_x2  replaces keyhuntm1cpu_tpu/hash/phash.py _hash160x2_kernel
//   K8 kh_hash160_u   replaces keyhuntm1cpu_tpu/hash/phash.py _hash160_u_kernel
//   kh_keccak_eth     replaces keyhuntm1cpu_tpu/hash/phash.py _keccak_pubkey_kernel
// Wrappers and plain torch versions: keyhuntm1cpu_tpu_torch/hash/phash.py.
//
// One thread per point, a thin loop over hash.cuh's per-point word
// functions (the same ones the brute walk kernel calls): K7 hashes both
// compressed parities, hash160(02 || X) and hash160(03 || X); K8 hashes the
// uncompressed key 04 || X || Y (two chained SHA-256 blocks). Each returns
// the 64-bit truncation (lo, hi) = digest bytes 0..3 and 4..7 as
// little-endian words. kh_keccak_eth hashes X || Y with Keccak-256 (the ETH
// address) and returns digest bytes 12..15 and 16..19 as little-endian
// words, the first 8 bytes of the address. hash.cuh runs Keccak on native
// 64-bit lanes where the TPU kernel pairs 32-bit halves; the byte order is
// the one the brute walk kernel (K4) already uses in eth mode.
//
// Bound on the H100: 32-bit integer issue (two SHA-256 + two RIPEMD-160
// compressions per point in K7, two SHA-256 + one RIPEMD-160 in K8, 24
// Keccak-f rounds in kh_keccak_eth); the 32 or 64 bytes read and 16 or 8
// bytes written per point are far below the memory rate. Neighbouring threads read neighbouring columns of the
// limb-major input, so every load and store coalesces.
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_limbs(const uint32_t* __restrict__ p, int n, int i,
                                           uint32_t (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) v[j] = p[(long long)j * n + i];
}

__global__ void __launch_bounds__(kThreads)
hash160_x2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ lo_e,
                  uint32_t* __restrict__ hi_e, uint32_t* __restrict__ lo_o,
                  uint32_t* __restrict__ hi_o, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t xl[8];
  load_limbs(x, n, i, xl);
  const uint2 e = kh::hash160_parity_words(xl, 2u);
  const uint2 o = kh::hash160_parity_words(xl, 3u);
  lo_e[i] = e.x;
  hi_e[i] = e.y;
  lo_o[i] = o.x;
  hi_o[i] = o.y;
}

__global__ void __launch_bounds__(kThreads)
hash160_u_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                 uint32_t* __restrict__ lo, uint32_t* __restrict__ hi, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t xl[8], yl[8];
  load_limbs(x, n, i, xl);
  load_limbs(y, n, i, yl);
  const uint2 d = kh::hash160_u_words(xl, yl);
  lo[i] = d.x;
  hi[i] = d.y;
}

__global__ void __launch_bounds__(kThreads)
keccak_eth_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                  uint32_t* __restrict__ lo, uint32_t* __restrict__ hi, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t xl[8], yl[8];
  load_limbs(x, n, i, xl);
  load_limbs(y, n, i, yl);
  const uint2 d = kh::keccak_eth_words(xl, yl);
  lo[i] = d.x;
  hi[i] = d.y;
}

}  // namespace

extern "C" int kh_hash160_x2(const void* x, void* lo_e, void* hi_e, void* lo_o, void* hi_o,
                             int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  hash160_x2_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)lo_e, (uint32_t*)hi_e, (uint32_t*)lo_o, (uint32_t*)hi_o, n);
  return (int)cudaGetLastError();
}

extern "C" int kh_hash160_u(const void* x, const void* y, void* lo, void* hi, int n,
                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  hash160_u_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)lo, (uint32_t*)hi, n);
  return (int)cudaGetLastError();
}

extern "C" int kh_keccak_eth(const void* x, const void* y, void* lo, void* hi, int n,
                             void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  keccak_eth_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)lo, (uint32_t*)hi, n);
  return (int)cudaGetLastError();
}
