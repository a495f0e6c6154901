// BSGS giant-step walk kernels for Hopper (sm_90a):
//   K1 kh_advance_chain  replaces keyhuntm1cpu_tpu/curve/pwalk.py _advance_kernel
//   K2 kh_walk_blocks    replaces keyhuntm1cpu_tpu/curve/pwalk.py _walk_kernel
// Wrappers and plain torch versions: keyhuntm1cpu_tpu_torch/curve/pwalk.py.
// Layouts: field elements limb-major (8, n) u32; bases (8, T*K) with column
// t*K + s; qlo/qhi/deg (R, U) row-major. Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fe.cuh"

using kh::Fe;

namespace {

// Jacobian P + affine Q (madd-2007-bl) with the doubling fallback
// (dbl-2009-l, a = 0) for P == Q, as pwalk._mixed_add. Returns true when
// P == -Q (the result is garbage; the caller flags the lane). The TPU code
// evaluates both lanes and selects; here only the taken lane runs, with the
// same arithmetic, so the results are identical.
__device__ bool mixed_add(Fe& X, Fe& Y, Fe& Z, const Fe& qx, const Fe& qy) {
  Fe z2 = kh::fe_sqr(Z);
  Fe u2 = kh::fe_mul(qx, z2);
  Fe s2 = kh::fe_mul(qy, kh::fe_mul(Z, z2));
  Fe h = kh::fe_sub(u2, X);
  Fe r = kh::fe_sub(s2, Y);
  bool h_zero = kh::fe_is_zero(h);
  if (h_zero && kh::fe_eq(s2, Y)) {  // P == Q: doubling
    Fe a_ = kh::fe_sqr(X);
    Fe b_ = kh::fe_sqr(Y);
    Fe c_ = kh::fe_sqr(b_);
    Fe t = kh::fe_sqr(kh::fe_add(X, b_));
    Fe d_ = kh::fe_dbl(kh::fe_sub(kh::fe_sub(t, a_), c_));
    Fe e_ = kh::fe_add(kh::fe_dbl(a_), a_);
    Fe xd = kh::fe_sub(kh::fe_sqr(e_), kh::fe_dbl(d_));
    Fe yd = kh::fe_sub(kh::fe_mul(e_, kh::fe_sub(d_, xd)),
                       kh::fe_dbl(kh::fe_dbl(kh::fe_dbl(c_))));
    Fe zd = kh::fe_dbl(kh::fe_mul(Y, Z));
    X = xd;
    Y = yd;
    Z = zd;
    return false;
  }
  if (h_zero) h = kh::fe_one();  // P == -Q: keep going on garbage, flagged
  Fe hh = kh::fe_sqr(h);
  Fe v = kh::fe_mul(X, hh);
  Fe hhh = kh::fe_mul(h, hh);
  Fe x3 = kh::fe_sub(kh::fe_sub(kh::fe_sqr(r), hhh), kh::fe_dbl(v));
  Fe y3 = kh::fe_sub(kh::fe_mul(r, kh::fe_sub(v, x3)), kh::fe_mul(Y, hhh));
  Z = kh::fe_mul(Z, h);
  X = x3;
  Y = y3;
  return h_zero;
}

// K1: one thread per target chain, serial over the K steps.
//
// Bound on the H100: latency. With T = 1 (the flagship single-target run)
// one thread runs ~16 dependent field multiplies per step, K steps, then
// one inversion (~270 multiplies) and 3 multiplies per point to normalise:
// the card is idle but for one warp. The design keeps the chain in Jacobian
// coordinates (no inversion per step) and normalises all K points with ONE
// Montgomery batch inversion; the Jacobian points and prefix products go to
// a global scratch buffer (4 x T*K rows of 32 B, L1/L2 resident). A later
// change can compute the K bases as P + s*ADV in parallel (ADV is constant,
// so s*ADV is a table), which removes the serial chain.
__global__ void advance_chain_kernel(const uint32_t* __restrict__ px,
                                     const uint32_t* __restrict__ py,
                                     const uint32_t* __restrict__ ax,
                                     const uint32_t* __restrict__ ay,
                                     uint32_t* __restrict__ bx,
                                     uint32_t* __restrict__ by,
                                     uint32_t* __restrict__ nx,
                                     uint32_t* __restrict__ ny,
                                     uint8_t* __restrict__ adeg,
                                     uint32_t* __restrict__ scratch, int T, int K) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const long long TK = (long long)T * K;
  uint32_t* sx = scratch;
  uint32_t* sy = scratch + TK * 8;
  uint32_t* sz = scratch + 2 * TK * 8;
  uint32_t* pref = scratch + 3 * TK * 8;
  const Fe qx = kh::fe_load_lm(ax, 1, 0);
  const Fe qy = kh::fe_load_lm(ay, 1, 0);
  const Fe p0x = kh::fe_load_lm(px, T, t);
  const Fe p0y = kh::fe_load_lm(py, T, t);
  const long long row0 = (long long)t * K;

  Fe X = p0x, Y = p0y, Z = kh::fe_one(), acc;
  for (int s = 0; s < K; s++) {
    adeg[row0 + s] = mixed_add(X, Y, Z, qx, qy) ? 1 : 0;
    if (kh::fe_is_zero(Z)) Z = kh::fe_one();  // keep Z invertible (pwalk.py:111)
    kh::fe_store_row(sx, row0 + s, X);
    kh::fe_store_row(sy, row0 + s, Y);
    kh::fe_store_row(sz, row0 + s, Z);
    acc = s ? kh::fe_mul(acc, Z) : Z;
    kh::fe_store_row(pref, row0 + s, acc);
  }
  Fe inv = kh::fe_inv(acc);
  for (int s = K - 1; s >= 0; s--) {
    Fe zi = inv;
    if (s > 0) {
      zi = kh::fe_mul(inv, kh::fe_load_row(pref, row0 + s - 1));
      inv = kh::fe_mul(inv, kh::fe_load_row(sz, row0 + s));
    }
    Fe zi2 = kh::fe_sqr(zi);
    Fe x = kh::fe_mul(kh::fe_load_row(sx, row0 + s), zi2);
    Fe y = kh::fe_mul(kh::fe_load_row(sy, row0 + s), kh::fe_mul(zi, zi2));
    // chain point s+1 is walk base s+1, or the next state after the last
    if (s + 1 < K) {
      kh::fe_store_lm(bx, TK, row0 + s + 1, x);
      kh::fe_store_lm(by, TK, row0 + s + 1, y);
    } else {
      kh::fe_store_lm(nx, T, t, x);
      kh::fe_store_lm(ny, T, t, y);
    }
  }
  kh::fe_store_lm(bx, TK, row0, p0x);
  kh::fe_store_lm(by, TK, row0, p0y);
}

// K2: thread = one offset column u and kWalkGroup = G consecutive base rows.
//
// Bound on the H100: 32-bit integer multiply throughput (~5 field multiplies
// per point plus 1/G of an inversion; each field multiply is 64 IMAD.WIDE
// plus the fold). The design gives every thread its own Montgomery chain of
// G denominators (prefix products in local memory, ONE inversion per thread,
// dx recomputed in the backward pass instead of stored), so no thread waits
// on another and the inversion is amortised over G points. Neighbouring
// threads own neighbouring u: table loads and qlo/qhi/deg stores coalesce;
// the G base rows are warp-uniform broadcast loads. G = 32 was chosen on an
// H100 (700 W) at 256 x 16384 points: 1.03 ms, against 1.54 ms at G = 16
// and 2.60 ms at G = 8.
constexpr int kWalkGroup = 32;

__global__ void walk_blocks_kernel(const uint32_t* __restrict__ bx,
                                   const uint32_t* __restrict__ by,
                                   const uint32_t* __restrict__ tx,
                                   const uint32_t* __restrict__ ty,
                                   uint32_t* __restrict__ qlo,
                                   uint32_t* __restrict__ qhi,
                                   uint8_t* __restrict__ deg, long long R, int U) {
  const int u = blockIdx.y * blockDim.x + threadIdx.x;
  if (u >= U) return;
  constexpr int G = kWalkGroup;
  const long long r0 = (long long)blockIdx.x * G;
  const int n = (int)min((long long)G, R - r0);
  const Fe tX = kh::fe_load_lm(tx, U, u);
  const Fe tY = kh::fe_load_lm(ty, U, u);
  const Fe one = kh::fe_one();
  Fe pref[G];
  Fe acc;
  for (int j = 0; j < n; j++) {
    Fe dx = kh::fe_sub(tX, kh::fe_load_lm(bx, R, r0 + j));
    bool z = kh::fe_is_zero(dx);
    deg[(r0 + j) * U + u] = z ? 1 : 0;
    if (z) dx = one;  // flagged lane: invert 1 instead of 0
    acc = j ? kh::fe_mul(acc, dx) : dx;
    pref[j] = acc;
  }
  Fe inv = kh::fe_inv(acc);
  for (int j = n - 1; j >= 0; j--) {
    const Fe bX = kh::fe_load_lm(bx, R, r0 + j);
    const Fe bY = kh::fe_load_lm(by, R, r0 + j);
    Fe inv_j = inv;
    if (j > 0) {
      Fe dx = kh::fe_sub(tX, bX);
      if (kh::fe_is_zero(dx)) dx = one;
      inv_j = kh::fe_mul(inv, pref[j - 1]);
      inv = kh::fe_mul(inv, dx);
    }
    Fe lam = kh::fe_mul(kh::fe_sub(tY, bY), inv_j);
    Fe x3 = kh::fe_sub(kh::fe_sub(kh::fe_sqr(lam), bX), tX);
    qlo[(r0 + j) * U + u] = x3.v[0];  // only the 64-bit truncation leaves
    qhi[(r0 + j) * U + u] = x3.v[1];
  }
}

}  // namespace

extern "C" int kh_advance_chain(const void* px, const void* py, const void* ax,
                                const void* ay, void* bx, void* by, void* nx,
                                void* ny, void* adeg, void* scratch, int T, int K,
                                void* stream) {
  const int threads = 32;
  advance_chain_kernel<<<(T + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)ax,
      (const uint32_t*)ay, (uint32_t*)bx, (uint32_t*)by, (uint32_t*)nx,
      (uint32_t*)ny, (uint8_t*)adeg, (uint32_t*)scratch, T, K);
  return (int)cudaGetLastError();
}

extern "C" int kh_walk_blocks(const void* bx, const void* by, const void* tx,
                              const void* ty, void* qlo, void* qhi, void* deg,
                              long long R, int U, void* stream) {
  const int threads = 128;
  dim3 grid((unsigned)((R + kWalkGroup - 1) / kWalkGroup),
            (unsigned)((U + threads - 1) / threads));
  walk_blocks_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
      (const uint32_t*)ty, (uint32_t*)qlo, (uint32_t*)qhi, (uint8_t*)deg, R, U);
  return (int)cudaGetLastError();
}
