// Elementwise modular inverse for Hopper (sm_90a):
//   kh_inv_batch  replaces keyhuntm1cpu_tpu/field/pinv.py _inv_kernel / inv_batch
// Wrapper and plain torch version: keyhuntm1cpu_tpu_torch/field/pinv.py.
//
// a^(p-2) mod p for every column of a limb-major (8, n) u32 array, by the
// secp256k1 addition chain of fe.cuh's fe_inv (255 squarings, 15
// multiplies); 0 maps to 0. The walker walk (walk.cu) calls it once per
// step on the chain totals of its batched inversion.
//
// Bound on the H100: 32-bit integer issue, ~270 field products per element
// (the 64 bytes moved per element are nothing next to that). The design is
// one thread per element: neighbouring threads read neighbouring columns,
// so every limb load and store coalesces, and the chain is straight-line
// register code. At the walk's width (~1,025 totals per step) that is 9
// blocks on 132 SMs, so the launch is latency-bound, not issue-bound; a
// larger batch fills the card.
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fe.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
inv_batch_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  kh::fe_store_lm(out, n, i, kh::fe_inv(kh::fe_load_lm(a, n, i)));
}

}  // namespace

extern "C" int kh_inv_batch(const void* a, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  inv_batch_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
