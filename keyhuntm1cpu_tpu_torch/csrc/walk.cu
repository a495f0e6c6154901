// Walker group walk with the fused block advance for Hopper (sm_90a):
//   kh_walk_prefix + kh_walk_emit  replace the XLA walk of
//   keyhuntm1cpu_tpu/curve/walk.py walk_fused (with fe.batch_inv_mod_p),
//   the hot loop of keyhuntm1cpu_tpu/engine/brute.py _brute_chunk_impl.
// Wrapper and plain torch version: keyhuntm1cpu_tpu_torch/curve/walk.py.
//
// Each of W walkers sits at a center C_w. One device step computes the
// points C_w + u*S and C_w - u*S (u = 1..U, S the stride point) and the
// next center C_w + ADV, with ONE batched inversion of all W*(U+2)
// denominators by the chunked Montgomery trick, in three launches:
//   1. kh_walk_prefix: one warp per chain c of L = chain_len elements
//      (element i = l*C + c, C = ceil(W*(U+2)/L) chains: the JAX chunking,
//      so the chain totals have the JAX width). The chain's elements go in
//      segments of 32 from the bottom; lane j forms the denominator of
//      element l = lo + j (tx_u - cx for the U table lanes, with zeros set
//      to 1; 1 past the chain's end), a warp prefix scan (5 shuffle levels
//      of fe_mul) gives the segment's inclusive prefix products, each is
//      multiplied by the product of the segments below (carried up from
//      segment to segment) and stored, staged in shared memory so that the
//      block's 4 chains (neighbouring columns) write together; the last is
//      the chain total.
//   2. kh_inv_batch (pinv.cu) inverts the C chain totals.
//   3. kh_walk_emit: one warp per chain. The chain's L elements go in
//      segments of 32 from the top; lane j takes element l = lo + j of the
//      segment [lo, hi), recomputes its denominator, and a warp suffix scan
//      (5 shuffle levels of fe_mul) gives the product of the segment's
//      denominators above it. Its inverse is running * that product *
//      prefix[l-1], where running is the inverted total times every
//      denominator above the segment (carried down from segment to
//      segment). Then every lane emits its element: lambda, x3 (and y3 when
//      need_y) for the + and - lanes, the GLV variants x*beta and x*beta^2
//      with the endomorphism, and the degenerate flags.
// The advance lane needs two inverses, 1/(ADVx - cx) and 1/(2*cy) (the
// doubling fallback for C == ADV). Its element is their product, so one
// thread owns both: 1/dx = inv*2cy and 1/2cy = inv*dx. The JAX batch's
// second slot of the walker is a 1 here, which keeps the element count and
// so the chain width. The inverses are exact, so every output equals
// walk_fused's bit for bit, degenerate lanes' garbage included.
//
// Bound on the H100: 32-bit integer issue, ~7 field products per point
// and the inversion shared out (chip_smoke.walk_point_ops). The C ~ 1,025
// chains of a W = 8, U = 4096 step would be 9 blocks of 128 threads as a
// thread per chain, L = 32 dependent products a thread on 9 of the 132
// SMs: latency, not arithmetic, bounds such a kernel. A warp per chain
// puts the C chains on C warps (257 blocks) with ~7 dependent products a
// lane in walk_prefix and ~8 and one emit a lane in walk_emit, at the
// price of strided element columns (C*4 bytes apart; the 1 MB of
// prefixes stays in L2) and 5 scan products per element. walk_prefix's
// stores, a word a lane, took a third of its time until they went through
// shared memory (scripts/torch_walker_shapes.py).
//
// Layouts, limb-major u32: centers (8, W), table (8, U), ADV (8,),
// prefixes (8, L*C), totals (8, C), x out (n_endo, 8, W*npts) and y out
// (8, W*npts) with npts = 2U+1: lanes 0..U-1 =
// +u, U..2U-1 = -u, the last = the center; deg (W, U) and adv_deg (W,)
// bytes; next centers (8, W).
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fe.cuh"

using kh::Fe;

namespace {

constexpr int kThreads = 128;

struct WalkArgs {
  const uint32_t* cx;
  const uint32_t* cy;
  const uint32_t* tx;
  const uint32_t* ty;
  const uint32_t* ax;  // ADV
  const uint32_t* ay;
  int W, U, L;
  long long C;  // chains
};

__device__ __forceinline__ Fe fe_beta(int e) {
  // beta and beta^2 mod p, the GLV x multipliers of lambda and lambda^2
  Fe r;
  if (e == 1) {
    r.v[0] = 0x719501EEu; r.v[1] = 0xC1396C28u; r.v[2] = 0x12F58995u; r.v[3] = 0x9CF04975u;
    r.v[4] = 0xAC3434E9u; r.v[5] = 0x6E64479Eu; r.v[6] = 0x657C0710u; r.v[7] = 0x7AE96A2Bu;
  } else {
    r.v[0] = 0x8E6AFA40u; r.v[1] = 0x3EC693D6u; r.v[2] = 0xED0A766Au; r.v[3] = 0x630FB68Au;
    r.v[4] = 0x53CBCB16u; r.v[5] = 0x919BB861u; r.v[6] = 0x9A83F8EFu; r.v[7] = 0x851695D4u;
  }
  return r;
}

// 2cy with a zero set to 1, as the JAX batch masks every zero denominator
// (cy == 0 only for a center at infinity, whose lanes are garbage anyway)
__device__ __forceinline__ Fe two_cy_safe(const Fe& cy) {
  const Fe t = kh::fe_dbl(cy);
  return kh::fe_is_zero(t) ? kh::fe_one() : t;
}

// Denominator of element i (1 for padding): tx_j - cx_w for a table lane,
// (ADVx - cx_w) * 2cy_w for the advance lane, 1 for the walker's second slot.
__device__ __forceinline__ Fe denominator(const WalkArgs& a, long long i) {
  const long long D = (long long)a.W * (a.U + 2);
  if (i >= D) return kh::fe_one();
  const int w = (int)(i / (a.U + 2));
  const int j = (int)(i % (a.U + 2));
  if (j > a.U) return kh::fe_one();
  const Fe cx = kh::fe_load_lm(a.cx, a.W, w);
  const Fe tx = j < a.U ? kh::fe_load_lm(a.tx, a.U, j) : kh::fe_load_lm(a.ax, 1, 0);
  Fe dx = kh::fe_sub(tx, cx);
  if (kh::fe_is_zero(dx)) dx = kh::fe_one();
  if (j < a.U) return dx;
  return kh::fe_mul(dx, two_cy_safe(kh::fe_load_lm(a.cy, a.W, w)));
}

__device__ __forceinline__ Fe shfl_up_fe(const Fe& a, int d) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = __shfl_up_sync(0xFFFFFFFFu, a.v[j], d);
  return r;
}

__device__ __forceinline__ Fe shfl_down_fe(const Fe& a, int d) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = __shfl_down_sync(0xFFFFFFFFu, a.v[j], d);
  return r;
}

__device__ __forceinline__ Fe shfl_fe(const Fe& a, int src) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = __shfl_sync(0xFFFFFFFFu, a.v[j], src);
  return r;
}

// a block of WARPS warps owns WARPS consecutive chains: each segment's
// prefixes go through shared memory, so row l of each limb leaves as WARPS
// contiguous words in place of one word a lane C*4 bytes apart
template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
walk_prefix_kernel(WalkArgs a, uint32_t* __restrict__ pre, uint32_t* __restrict__ totals) {
  __shared__ uint32_t stage[8][32][WARPS + 1];  // [limb][l - lo][chain], padded
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c0 = (long long)blockIdx.x * WARPS, c = c0 + wid;
  const bool chain = c < a.C;  // no early exit: the block meets at barriers
  const long long n = a.C * a.L;
  Fe running = kh::fe_one();  // den(0) * ... * den(lo - 1)
  for (int lo = 0; lo < a.L; lo += 32) {
    const int l = lo + lane;
    // p = den(lo) * ... * den(l): inclusive prefix products of the segment
    Fe p = chain && l < a.L ? denominator(a, (long long)l * a.C + c) : kh::fe_one();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Fe below = shfl_up_fe(p, d);
      if (lane >= d) p = kh::fe_mul(below, p);
    }
    if (lo > 0) p = kh::fe_mul(running, p);
    if (chain && l == a.L - 1) kh::fe_store_lm(totals, a.C, c, p);
    running = shfl_fe(p, 31);  // lanes past the chain's end hold its total
#pragma unroll
    for (int j = 0; j < 8; j++) stage[j][lane][wid] = p.v[j];
    __syncthreads();
    for (int k = threadIdx.x; k < 8 * 32 * WARPS; k += 32 * WARPS) {
      const int j = k / (32 * WARPS), r = k % (32 * WARPS);
      const int l2 = lo + r / WARPS, cl = r % WARPS;
      if (c0 + cl < a.C && l2 < a.L)
        pre[j * n + (long long)l2 * a.C + c0 + cl] = stage[j][r / WARPS][cl];
    }
    __syncthreads();
  }
}

struct EmitOut {
  uint32_t* x;  // (n_endo, 8, W*npts)
  uint32_t* y;  // (8, W*npts) or null
  uint8_t* deg;  // (W, U)
  uint32_t* nx;  // (8, W)
  uint32_t* ny;
  uint8_t* adeg;  // (W,)
  int n_endo;
};

__device__ __forceinline__ void store_x(const EmitOut& o, long long npts_all, long long col,
                                        const Fe& x) {
  kh::fe_store_lm(o.x, npts_all, col, x);
  for (int e = 1; e < o.n_endo; e++)
    kh::fe_store_lm(o.x + (long long)e * 8 * npts_all, npts_all, col, kh::fe_mul(x, fe_beta(e)));
}

// lambda = num * inv; x3 = lambda^2 - cx - tx; y3 = lambda (cx - x3) - cy
__device__ __forceinline__ void emit_lane(const EmitOut& o, long long npts_all, long long col,
                                          const Fe& num, const Fe& inv, const Fe& cx,
                                          const Fe& cy, const Fe& tx) {
  const Fe lam = kh::fe_mul(num, inv);
  const Fe x3 = kh::fe_sub(kh::fe_sub(kh::fe_sqr(lam), cx), tx);
  store_x(o, npts_all, col, x3);
  if (o.y) kh::fe_store_lm(o.y, npts_all, col, kh::fe_sub(kh::fe_mul(lam, kh::fe_sub(cx, x3)), cy));
}

__device__ void emit(const WalkArgs& a, const EmitOut& o, long long i, const Fe& inv) {
  const int w = (int)(i / (a.U + 2));
  const int j = (int)(i % (a.U + 2));
  if (j > a.U) return;
  const int npts = 2 * a.U + 1;
  const long long npts_all = (long long)a.W * npts;
  const long long col0 = (long long)w * npts;
  const Fe cx = kh::fe_load_lm(a.cx, a.W, w);
  const Fe cy = kh::fe_load_lm(a.cy, a.W, w);
  if (j < a.U) {  // table lane u = j + 1: C + uS and C - uS share dx
    const Fe tx = kh::fe_load_lm(a.tx, a.U, j);
    const Fe ty = kh::fe_load_lm(a.ty, a.U, j);
    o.deg[(long long)w * a.U + j] = kh::fe_is_zero(kh::fe_sub(tx, cx));
    emit_lane(o, npts_all, col0 + j, kh::fe_sub(ty, cy), inv, cx, cy, tx);
    const Fe zero = {};  // -uS = (tx, -ty): lambda = -(ty + cy) / dx
    emit_lane(o, npts_all, col0 + a.U + j, kh::fe_sub(zero, kh::fe_add(ty, cy)), inv, cx, cy, tx);
    return;
  }
  // advance lane: inv = 1 / ((ADVx - cx) * 2cy), zero dx set to 1
  const Fe ax = kh::fe_load_lm(a.ax, 1, 0);
  const Fe ay = kh::fe_load_lm(a.ay, 1, 0);
  Fe dx = kh::fe_sub(ax, cx);
  const bool dx_zero = kh::fe_is_zero(dx);
  if (dx_zero) dx = kh::fe_one();
  const Fe two_cy = two_cy_safe(cy);
  const Fe inv_dx = kh::fe_mul(inv, two_cy);
  const Fe inv_2y = kh::fe_mul(inv, dx);
  const Fe lam = kh::fe_mul(kh::fe_sub(ay, cy), inv_dx);
  Fe nx = kh::fe_sub(kh::fe_sub(kh::fe_sqr(lam), cx), ax);
  Fe ny = kh::fe_sub(kh::fe_mul(lam, kh::fe_sub(cx, nx)), cy);
  // doubling fallback for C == ADV: lambda = 3 cx^2 / 2cy
  const Fe sq = kh::fe_sqr(cx);
  const Fe lam_d = kh::fe_mul(kh::fe_add(kh::fe_dbl(sq), sq), inv_2y);
  const Fe xd = kh::fe_sub(kh::fe_sub(kh::fe_sqr(lam_d), cx), cx);
  const Fe yd = kh::fe_sub(kh::fe_mul(lam_d, kh::fe_sub(cx, xd)), cy);
  const bool is_double = dx_zero && kh::fe_eq(cy, ay);
  if (is_double) {
    nx = xd;
    ny = yd;
  }
  kh::fe_store_lm(o.nx, a.W, w, nx);
  kh::fe_store_lm(o.ny, a.W, w, ny);
  o.adeg[w] = dx_zero && !is_double;  // C == -ADV: the sum is infinity
  // the center lane
  store_x(o, npts_all, col0 + npts - 1, cx);
  if (o.y) kh::fe_store_lm(o.y, npts_all, col0 + npts - 1, cy);
}

__global__ void __launch_bounds__(kThreads)
walk_emit_kernel(WalkArgs a, const uint32_t* __restrict__ pre,
                 const uint32_t* __restrict__ inv_totals, EmitOut o) {
  // the warp's chain (uniform across the warp, so whole warps leave here
  // and the shuffles below see all 32 lanes)
  const long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= a.C) return;
  const long long n = a.C * a.L;
  const long long D = (long long)a.W * (a.U + 2);
  Fe running = kh::fe_load_lm(inv_totals, a.C, c);  // 1 / the chain's total
  for (int hi = a.L; hi > 0; hi -= 32) {
    const int lo = hi > 32 ? hi - 32 : 0;
    const int l = lo + lane;
    const bool act = l < hi;
    const long long i = (long long)l * a.C + c;
    const Fe den = act ? denominator(a, i) : kh::fe_one();
    // suf = den(l) * ... * den(hi - 1): inclusive suffix products
    Fe suf = den;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Fe up = shfl_down_fe(suf, d);
      if (lane + d < 32) suf = kh::fe_mul(suf, up);
    }
    Fe above = shfl_down_fe(suf, 1);  // den(l+1) * ... * den(hi - 1)
    if (lane == 31) above = kh::fe_one();
    if (act) {
      // 1/den(l) = 1/total * den(l+1..L-1) * den(0..l-1)
      Fe inv = kh::fe_mul(running, above);
      if (l > 0) inv = kh::fe_mul(inv, kh::fe_load_lm(pre, n, i - a.C));
      if (i < D) emit(a, o, i, inv);
    }
    running = kh::fe_mul(running, shfl_fe(suf, 0));
  }
}

bool bad_shape(int W, int U, int L, long long C) {
  return W < 1 || U < 1 || L < 1 || C != ((long long)W * (U + 2) + L - 1) / L;
}

}  // namespace

extern "C" int kh_walk_prefix(const void* cx, const void* cy, const void* tx, const void* ty,
                              const void* ax, const void* ay, void* pre, void* totals, int W,
                              int U, int L, long long C, void* stream) {
  if (bad_shape(W, U, L, C)) return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  constexpr int kWarps = kThreads / 32;
  walk_prefix_kernel<kWarps><<<(unsigned)((C + kWarps - 1) / kWarps), kThreads, 0,
                               (cudaStream_t)stream>>>(a, (uint32_t*)pre, (uint32_t*)totals);
  return (int)cudaGetLastError();
}

extern "C" int kh_walk_emit(const void* cx, const void* cy, const void* tx, const void* ty,
                            const void* ax, const void* ay, const void* pre,
                            const void* inv_totals, void* x, void* y, void* deg, void* nx,
                            void* ny, void* adeg, int W, int U, int L, long long C, int n_endo,
                            void* stream) {
  if (bad_shape(W, U, L, C) || (n_endo != 1 && n_endo != 3)) return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  const EmitOut o{(uint32_t*)x, (uint32_t*)y, (uint8_t*)deg, (uint32_t*)nx, (uint32_t*)ny,
                  (uint8_t*)adeg, n_endo};
  walk_emit_kernel<<<(unsigned)((32 * C + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(a, (const uint32_t*)pre,
                                             (const uint32_t*)inv_totals, o);
  return (int)cudaGetLastError();
}
