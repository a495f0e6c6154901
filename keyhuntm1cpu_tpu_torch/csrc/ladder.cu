// Scalar-mult ladder for Hopper (sm_90a):
//   K6 kh_scalar_mult  replaces keyhuntm1cpu_tpu/curve/pladder.py _ladder_kernel
// Wrapper and plain torch version: keyhuntm1cpu_tpu_torch/curve/pladder.py.
//
// k*G for arbitrary 256-bit k (minikey private keys are SHA-256 outputs, so
// there is no incremental structure): byte w of k selects the table point
// gtable[w][byte] = (byte * 2^(8w)) * G, and the accumulator starts at
// infinity. A zero byte keeps the accumulator (the table's b = 0 entry is
// zero-filled and never read); the first non-zero byte loads its point;
// every later one is a Jacobian + affine mixed add (madd-2007-bl) without a
// doubling fallback: h == 0 lanes (doubling or cancellation) set h = 1,
// carry on and are flagged irregular, for the caller's exact host check
// (pladder.py:141-156). Then Z goes to affine by one inversion per block.
//
// Bound on the H100: 32-bit integer multiply issue (~31 mixed adds of 8
// products, 3 squarings and 6 subtractions per lane). The table (2 x 256 KiB)
// stays in L2 and is read through the read-only path, 2 x 16 B per load; the
// TPU's one-hot MXU gather and window-major slabs have no counterpart. The
// inversion is shared: a product tree over the block's 128 Z values in
// shared memory (127 products up, 254 down), one fe_inv on thread 0, so a
// lane pays ~3 products and 1/128 of an inversion instead of a whole one.
// Layouts: k, x, y limb-major (8, V) u32; tables (32, 256, 8) row-major; the
// flags (V,) bytes. Each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fe.cuh"

using kh::Fe;

namespace {

constexpr int kLadderBlock = 128;

__device__ __forceinline__ Fe table_point(const uint32_t* __restrict__ tab, int w, uint32_t b) {
  const uint4* q = reinterpret_cast<const uint4*>(tab + ((long long)w * 256 + b) * 8);
  const uint4 a = __ldg(q), c = __ldg(q + 1);
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = c.x; r.v[5] = c.y; r.v[6] = c.z; r.v[7] = c.w;
  return r;
}

// P + Q, Jacobian P, affine Q, no doubling fallback (pladder._madd_flag).
// Returns h == 0.
__device__ __forceinline__ bool madd_flag(Fe& X, Fe& Y, Fe& Z, const Fe& qx, const Fe& qy) {
  const Fe z2 = kh::fe_sqr(Z);
  const Fe u2 = kh::fe_mul(qx, z2);
  const Fe s2 = kh::fe_mul(qy, kh::fe_mul(Z, z2));
  Fe h = kh::fe_sub(u2, X);
  const Fe r = kh::fe_sub(s2, Y);
  const bool h_zero = kh::fe_is_zero(h);
  if (h_zero) h = kh::fe_one();
  const Fe hh = kh::fe_sqr(h);
  const Fe v = kh::fe_mul(X, hh);
  const Fe hhh = kh::fe_mul(h, hh);
  const Fe x3 = kh::fe_sub(kh::fe_sub(kh::fe_sqr(r), hhh), kh::fe_dbl(v));
  const Fe y3 = kh::fe_sub(kh::fe_mul(r, kh::fe_sub(v, x3)), kh::fe_mul(Y, hhh));
  Z = kh::fe_mul(Z, h);
  X = x3;
  Y = y3;
  return h_zero;
}

__global__ void __launch_bounds__(kLadderBlock)
scalar_mult_kernel(const uint32_t* __restrict__ k, const uint32_t* __restrict__ gtx,
                   const uint32_t* __restrict__ gty, uint32_t* __restrict__ ax,
                   uint32_t* __restrict__ ay, uint8_t* __restrict__ inf_out,
                   uint8_t* __restrict__ irr_out, int V) {
  // heap-ordered product tree: leaves at [kLadderBlock, 2 * kLadderBlock),
  // node n = node 2n * node 2n+1, root at 1
  __shared__ Fe tree[2 * kLadderBlock];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kLadderBlock + t;
  const bool live = i < V;
  const Fe one = kh::fe_one();
  Fe X, Y, Z = one;
#pragma unroll
  for (int j = 0; j < 8; j++) X.v[j] = Y.v[j] = 0;
  bool inf = true, irr = false;
  if (live) {
    const Fe kk = kh::fe_load_lm(k, V, i);
#pragma unroll 1
    for (int w = 0; w < 32; w++) {
      uint32_t limb = kk.v[0];
#pragma unroll
      for (int j = 1; j < 8; j++) {
        if ((w >> 2) == j) limb = kk.v[j];
      }
      const uint32_t b = (limb >> (8 * (w & 3))) & 0xFFu;
      if (b == 0) continue;
      const Fe qx = table_point(gtx, w, b);
      const Fe qy = table_point(gty, w, b);
      if (inf) {
        X = qx;
        Y = qy;
        Z = one;
        inf = false;
      } else {
        irr |= madd_flag(X, Y, Z, qx, qy);
      }
    }
  }
  // z_safe: infinity and padding lanes invert 1 (pladder.py:165)
  tree[kLadderBlock + t] = (inf || kh::fe_is_zero(Z)) ? one : Z;
  __syncthreads();
  for (int s = kLadderBlock / 2; s >= 1; s >>= 1) {
    if (t < s) tree[s + t] = kh::fe_mul(tree[2 * (s + t)], tree[2 * (s + t) + 1]);
    __syncthreads();
  }
  if (t == 0) tree[1] = kh::fe_inv(tree[1]);
  __syncthreads();
  for (int s = 1; s < kLadderBlock; s <<= 1) {
    if (t < s) {
      const int n = s + t;
      const Fe inv = tree[n], a = tree[2 * n], b = tree[2 * n + 1];
      tree[2 * n] = kh::fe_mul(inv, b);
      tree[2 * n + 1] = kh::fe_mul(inv, a);
    }
    __syncthreads();
  }
  if (!live) return;
  const Fe zi = tree[kLadderBlock + t];
  const Fe zi2 = kh::fe_sqr(zi);
  kh::fe_store_lm(ax, V, i, kh::fe_mul(X, zi2));
  kh::fe_store_lm(ay, V, i, kh::fe_mul(Y, kh::fe_mul(zi, zi2)));
  inf_out[i] = inf ? 1 : 0;
  irr_out[i] = irr ? 1 : 0;
}

}  // namespace

extern "C" int kh_scalar_mult(const void* k, const void* gtx, const void* gty, void* ax,
                              void* ay, void* inf, void* irr, int V, void* stream) {
  if (V < 1) return (int)cudaErrorInvalidValue;
  scalar_mult_kernel<<<(V + kLadderBlock - 1) / kLadderBlock, kLadderBlock, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)k, (const uint32_t*)gtx, (const uint32_t*)gty, (uint32_t*)ax,
      (uint32_t*)ay, (uint8_t*)inf, (uint8_t*)irr, V);
  return (int)cudaGetLastError();
}
