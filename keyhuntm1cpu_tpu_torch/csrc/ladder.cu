// Scalar-mult ladder for Hopper (sm_90a):
//   K6 kh_ladder_jac + kh_ladder_affine  replace keyhuntm1cpu_tpu/curve/pladder.py _ladder_kernel
// Wrapper and plain torch versions: keyhuntm1cpu_tpu_torch/curve/pladder.py
// (scalar_mult_split_ref is these kernels' own order).
//
// k*G for arbitrary 256-bit k (minikey private keys are SHA-256 outputs, so
// there is no incremental structure): byte w of k selects the table point
// gtable[w][byte] = (byte * 2^(8w)) * G.
//
// 1. kh_ladder_jac: S adjacent lanes of a warp share a scalar (S =
//    kLadderSplit, one of 1, 2, 4, 8). Lane s takes the 32/S contiguous windows from s*32/S and
//    runs the sequential ladder over them: from infinity, a zero byte keeps
//    the partial sum, the first non-zero byte loads its point, every later
//    one is a Jacobian + affine mixed add (madd-2007-bl) without a doubling
//    fallback: h == 0 (a doubling or a cancellation) sets h = 1, carries on
//    and flags the lane irregular. Then log2(S) levels of __shfl_xor_sync
//    merge the partial sums with Jacobian + Jacobian adds (add-2007-bl): at
//    level m both lanes of the pair (s, s ^ m) compute lower + upper, so
//    they hold the same sum; an infinite partial passes through, h == 0 sets
//    h = 1 and flags (k = N cancels in the last merge). A lane left
//    unflagged is k*G exactly; the flagged set may differ from the
//    sequential ladder's, and the caller checks every flagged lane exactly
//    on the host (engine/minikeys.py). Out: Jacobian X, Y, Z and the flags.
// 2. kh_ladder_affine: one inversion per group of G = kAffineGroup scalars
//    (one block): a
//    product tree over the group's Z in shared memory (G-1 products up,
//    2(G-1) down), one fe_inv_const (safegcd divsteps) on thread 0, then
//    x = X/Z^2, y = Y/Z^3.
//
// Bound on the H100: 32-bit integer multiply issue (~31 mixed adds of 8
// products, 3 squarings and 6 subtractions per scalar). The sequential
// form, one thread per scalar and every product inlined, ran at ~2 warps
// per scheduler; more warps alone (S = 2, 4) did not help it, and calling
// the product and the square instead of inlining them (a loop that fits
// the instruction cache) did: the shapes script's sweep on the H100 picked
// S = 2, calls, 128 threads and 5 blocks an SM (96 registers, one wave of
// 544 blocks). The inversion is its own launch (one thread's inversion
// stalls its block, and the ladder launch then needs no barrier), and it
// is paid once a call, as latency: the addition chain a^(p-2), 270
// dependent products, took the launch 0.116 ms; divsteps took it to 0.045
// (fe_inv_var) and to 0.036 (fe_inv_const, a fixed count of branch-free
// divsteps, the one used). The table (2 x 256 KiB) stays in L2 and is read through
// the read-only path, 2 x 16 B per load; the TPU's one-hot MXU gather and
// window-major slabs have no counterpart.
// Layouts: k, x, y limb-major (8, V) u32; Jacobian (3, 8, V) u32 (X, Y, Z);
// tables (32, 256, 8) row-major; the flags (V,) bytes. Each entry point
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "fe.cuh"

using kh::Fe;

namespace {

// K6's shape: lanes per scalar (pladder.SPLIT must match), the ladder
// launch's block and the blocks an SM must hold (a register cap of 65536 /
// (threads * blocks)), scalars per inversion; scripts/torch_ladder_shapes.py
// builds other values
constexpr int kLadderSplit = 2;
constexpr int kLadderThreads = 128;
constexpr int kLadderMinBlocks = 5;
constexpr int kAffineGroup = 128;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
static_assert(kLadderSplit == 1 || kLadderSplit == 2 || kLadderSplit == 4 || kLadderSplit == 8,
              "a scalar's lanes share a warp and its limbs");
static_assert(kLadderThreads % 32 == 0, "whole warps");
static_assert(kAffineGroup >= 32 && kAffineGroup <= 512 && !(kAffineGroup & (kAffineGroup - 1)),
              "a power-of-two group of whole warps");

// How the ladder's adds take the field product and square: as calls (one
// body each, so the loop fits the instruction cache) or inlined (each
// mixed add ~3,300 SASS instructions of loop body, ~53 KB); the shapes
// script builds both.
#define KH_LADDER_FE __noinline__

__device__ KH_LADDER_FE Fe lmul(Fe a, Fe b) { return kh::fe_mul(a, b); }
__device__ KH_LADDER_FE Fe lsqr(Fe a) { return kh::fe_sqr(a); }

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
  const Fe z2 = lsqr(Z);
  const Fe u2 = lmul(qx, z2);
  const Fe s2 = lmul(qy, lmul(Z, z2));
  Fe h = kh::fe_sub(u2, X);
  const Fe r = kh::fe_sub(s2, Y);
  const bool h_zero = kh::fe_is_zero(h);
  if (h_zero) h = kh::fe_one();
  const Fe hh = lsqr(h);
  const Fe v = lmul(X, hh);
  const Fe hhh = lmul(h, hh);
  const Fe x3 = kh::fe_sub(kh::fe_sub(lsqr(r), hhh), kh::fe_dbl(v));
  const Fe y3 = kh::fe_sub(lmul(r, kh::fe_sub(v, x3)), lmul(Y, hhh));
  Z = lmul(Z, h);
  X = x3;
  Y = y3;
  return h_zero;
}

// P1 + P2, both Jacobian (add-2007-bl, pladder._jadd_flag), no doubling
// fallback; the sum lands in P1. Returns h == 0.
__device__ __forceinline__ bool jadd_flag(Fe& X1, Fe& Y1, Fe& Z1, const Fe& X2, const Fe& Y2,
                                          const Fe& Z2) {
  const Fe z1z1 = lsqr(Z1);
  const Fe z2z2 = lsqr(Z2);
  const Fe u1 = lmul(X1, z2z2);
  const Fe u2 = lmul(X2, z1z1);
  const Fe s1 = lmul(Y1, lmul(Z2, z2z2));
  const Fe s2 = lmul(Y2, lmul(Z1, z1z1));
  Fe h = kh::fe_sub(u2, u1);
  const bool h_zero = kh::fe_is_zero(h);
  if (h_zero) h = kh::fe_one();
  const Fe i = lsqr(kh::fe_dbl(h));
  const Fe j = lmul(h, i);
  const Fe r = kh::fe_dbl(kh::fe_sub(s2, s1));
  const Fe v = lmul(u1, i);
  const Fe x3 = kh::fe_sub(kh::fe_sub(lsqr(r), j), kh::fe_dbl(v));
  const Fe y3 = kh::fe_sub(lmul(r, kh::fe_sub(v, x3)), kh::fe_dbl(lmul(s1, j)));
  Z1 = lmul(kh::fe_sub(kh::fe_sub(lsqr(kh::fe_add(Z1, Z2)), z1z1), z2z2), h);
  X1 = x3;
  Y1 = y3;
  return h_zero;
}

__device__ __forceinline__ Fe shfl_xor_fe(const Fe& a, int m) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = __shfl_xor_sync(kFullMask, a.v[j], m);
  return r;
}

__global__ void __launch_bounds__(kLadderThreads, kLadderMinBlocks)
ladder_jac_kernel(const uint32_t* __restrict__ k, const uint32_t* __restrict__ gtx,
                  const uint32_t* __restrict__ gty, uint32_t* __restrict__ jac,
                  uint8_t* __restrict__ inf_out, uint8_t* __restrict__ irr_out, int V) {
  constexpr int S = kLadderSplit;
  constexpr int kWindows = 32 / S;  // windows per lane
  constexpr int kLimbs = kWindows / 4;  // scalar limbs per lane
  const long long tid = (long long)blockIdx.x * kLadderThreads + threadIdx.x;
  const int i = (int)(tid / S);  // the scalar
  const int s = (int)(tid % S);  // its window group
  const bool live = i < V;
  const Fe one = kh::fe_one();
  Fe X, Y, Z = one;
#pragma unroll
  for (int j = 0; j < 8; j++) X.v[j] = Y.v[j] = 0;
  bool inf = true, irr = false;
  if (live) {
    uint32_t kl[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; j++) kl[j] = k[(long long)(s * kLimbs + j) * V + i];
#pragma unroll 1
    for (int t = 0; t < kWindows; t++) {
      uint32_t limb = kl[0];
#pragma unroll
      for (int j = 1; j < kLimbs; j++) {
        if ((t >> 2) == j) limb = kl[j];
      }
      const uint32_t b = (limb >> (8 * (t & 3))) & 0xFFu;
      if (b == 0) continue;
      const int w = s * kWindows + t;
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
  // every lane of the warp takes part in the shuffles (S divides 32, and
  // blockDim is a multiple of 32, so a scalar's lanes share a warp)
#pragma unroll
  for (int m = 1; m < S; m <<= 1) {
    const Fe oX = shfl_xor_fe(X, m), oY = shfl_xor_fe(Y, m), oZ = shfl_xor_fe(Z, m);
    const bool o_inf = __shfl_xor_sync(kFullMask, (int)inf, m) != 0;
    const bool o_irr = __shfl_xor_sync(kFullMask, (int)irr, m) != 0;
    const bool upper = (s & m) != 0;
    // P1 = the lower lane's partial, P2 = the upper lane's (limb by limb:
    // a select of whole structs goes through local memory)
    Fe X1, Y1, Z1, X2, Y2, Z2;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      X1.v[j] = upper ? oX.v[j] : X.v[j];
      Y1.v[j] = upper ? oY.v[j] : Y.v[j];
      Z1.v[j] = upper ? oZ.v[j] : Z.v[j];
      X2.v[j] = upper ? X.v[j] : oX.v[j];
      Y2.v[j] = upper ? Y.v[j] : oY.v[j];
      Z2.v[j] = upper ? Z.v[j] : oZ.v[j];
    }
    const bool inf1 = upper ? o_inf : inf, inf2 = upper ? inf : o_inf;
    if (inf1) {
      X1 = X2;
      Y1 = Y2;
      Z1 = Z2;
    } else if (!inf2) {
      irr |= jadd_flag(X1, Y1, Z1, X2, Y2, Z2);
    }
    X = X1;
    Y = Y1;
    Z = Z1;
    inf = inf1 && inf2;
    irr |= o_irr;
  }
  if (!live || s != 0) return;
  kh::fe_store_lm(jac, V, i, X);
  kh::fe_store_lm(jac + 8LL * V, V, i, Y);
  kh::fe_store_lm(jac + 16LL * V, V, i, Z);
  inf_out[i] = inf ? 1 : 0;
  irr_out[i] = irr ? 1 : 0;
}

__global__ void __launch_bounds__(kAffineGroup)
ladder_affine_kernel(const uint32_t* __restrict__ jac, const uint8_t* __restrict__ inf,
                     uint32_t* __restrict__ ax, uint32_t* __restrict__ ay, int V) {
  // heap-ordered product tree: leaves at [G, 2G), node n = node 2n * node
  // 2n+1, root at 1
  constexpr int G = kAffineGroup;
  __shared__ Fe tree[2 * G];
  const int t = threadIdx.x;
  const int i = blockIdx.x * G + t;
  const bool live = i < V;
  const Fe one = kh::fe_one();
  Fe X = one, Y = one, Z = one;
  if (live) {
    X = kh::fe_load_lm(jac, V, i);
    Y = kh::fe_load_lm(jac + 8LL * V, V, i);
    Z = kh::fe_load_lm(jac + 16LL * V, V, i);
  }
  // z_safe: infinity and padding lanes invert 1 (pladder.py:165)
  tree[G + t] = (!live || inf[i] || kh::fe_is_zero(Z)) ? one : Z;
  __syncthreads();
  for (int s = G / 2; s >= 1; s >>= 1) {
    if (t < s) tree[s + t] = kh::fe_mul(tree[2 * (s + t)], tree[2 * (s + t) + 1]);
    __syncthreads();
  }
  if (t == 0) tree[1] = kh::fe_inv_const(tree[1]);
  __syncthreads();
  for (int s = 1; s < G; s <<= 1) {
    if (t < s) {
      const int n = s + t;
      const Fe inv = tree[n], a = tree[2 * n], b = tree[2 * n + 1];
      tree[2 * n] = kh::fe_mul(inv, b);
      tree[2 * n + 1] = kh::fe_mul(inv, a);
    }
    __syncthreads();
  }
  if (!live) return;
  const Fe zi = tree[G + t];
  const Fe zi2 = kh::fe_sqr(zi);
  kh::fe_store_lm(ax, V, i, kh::fe_mul(X, zi2));
  kh::fe_store_lm(ay, V, i, kh::fe_mul(Y, kh::fe_mul(zi, zi2)));
}

}  // namespace

extern "C" int kh_ladder_jac(const void* k, const void* gtx, const void* gty, void* jac,
                             void* inf, void* irr, int V, void* stream) {
  if (V < 1) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)V * kLadderSplit;
  ladder_jac_kernel<<<(unsigned)((lanes + kLadderThreads - 1) / kLadderThreads), kLadderThreads,
                      0, (cudaStream_t)stream>>>(
      (const uint32_t*)k, (const uint32_t*)gtx, (const uint32_t*)gty, (uint32_t*)jac,
      (uint8_t*)inf, (uint8_t*)irr, V);
  return (int)cudaGetLastError();
}

extern "C" int kh_ladder_affine(const void* jac, const void* inf, void* ax, void* ay, int V,
                                void* stream) {
  if (V < 1) return (int)cudaErrorInvalidValue;
  ladder_affine_kernel<<<(V + kAffineGroup - 1) / kAffineGroup, kAffineGroup, 0,
                         (cudaStream_t)stream>>>((const uint32_t*)jac, (const uint8_t*)inf,
                                                 (uint32_t*)ax, (uint32_t*)ay, V);
  return (int)cudaGetLastError();
}
