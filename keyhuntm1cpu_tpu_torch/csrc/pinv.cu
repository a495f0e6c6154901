// Elementwise modular inverse for Hopper (sm_90a):
//   kh_inv_batch  replaces keyhuntm1cpu_tpu/field/pinv.py _inv_kernel / inv_batch
// Wrapper and plain torch version: keyhuntm1cpu_tpu_torch/field/pinv.py.
//
// a^-1 mod p for every column of a limb-major (8, n) u32 array, 0 mapped
// to 0. The walker walk (walk.cu) calls it once per step on the chain
// totals of its batched inversion: n = 1,025 at the JAX CLI's shape.
//
// Bound on the H100: latency. At n = 1,025 the launch is 9 blocks on 132
// SMs, one warp per scheduler, so it lasts as long as one thread's
// inversion. The secp256k1 addition chain (255 squarings and 15 products,
// each product a few hundred dependent instructions) took ~0.096 ms. Here
// each thread inverts by a fixed count of safegcd divsteps (fe.cuh
// fe_inv_const: 20 batches of 30 branch-free divsteps on 30-bit limbs), a
// chain of a few dependent logic operations per divstep; the same
// instructions for every input, so the lanes of a warp stay together
// where the variable-time divsteps (fe_inv_var) would diverge.
// scripts/torch_pinv_shapes.py times this design against the addition
// chain, the variable-time divsteps and one inversion per block (a product
// tree), at n = 1, 1,025 and 65,536. One thread per column: neighbouring
// threads read neighbouring columns, so every limb load and store
// coalesces.
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
  kh::fe_store_lm(out, n, i, kh::fe_inv_const(kh::fe_load_lm(a, n, i)));
}

}  // namespace

extern "C" int kh_inv_batch(const void* a, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  inv_batch_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
