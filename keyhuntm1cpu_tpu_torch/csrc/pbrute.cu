// Brute-force walk + hash + membership kernel for Hopper (sm_90a):
//   K4 kh_brute_walk_blocks  replaces keyhuntm1cpu_tpu/curve/pbrute.py _brute_kernel
// Wrapper and plain torch version: keyhuntm1cpu_tpu_torch/curve/pbrute.py.
//
// Every point base_s + tab_u (s < K walk bases from K1, u < U table
// offsets) becomes ONE u32 hit word: bit q is set when query set q (GLV
// power e major, then the mode's hashes) lies inside one of the T 64-bit
// big-endian intervals, or, with TB bucket rows, when its high word equals
// an entry of its lane bucket btab[r][b & 127]; a degenerate lane
// (dx == 0) gets 1 << 30 instead of any query bit. Nothing but the hit
// words leaves the kernel.
//
// Bound on the H100: 32-bit integer issue. In rmd160 mode a point costs
// ~5 field multiplies of the walk plus two SHA-256 compressions and two
// RIPEMD-160 double lines, ~6,000 integer instructions; the 4 B hit word
// per point is nothing next to that. The design is K2's (pwalk.cu): one
// thread owns one offset column u and G consecutive base rows with its
// own Montgomery chain of G denominators (prefix products in local
// memory, dx recomputed on the way back), and the chain totals of the
// block share ONE inversion (fe_inv_var, safegcd divsteps) through a
// shared-memory product tree (batch_inv.cuh), so a point pays 1/(G *
// threads) of an inversion and ~3/G tree products where a thread of its
// own paid 1/G. The shape is the block: on an H100 at 700 W, K = 256,
// U = 16384, 512 threads x 64 rows ran xpoint 0.510 ms, rmd160 1.603,
// eth 2.027, against 0.555 / 1.822 / 2.283 at 128 x 64 and 0.600 / 1.953
// / 2.360 at 128 x 32 (the design before, with an inversion a thread:
// 0.613 / 1.967 / 2.403; every shape in PERF.md,
// scripts/torch_pbrute_shapes.py). At 118 registers a 512-thread block
// fills an SM, and 128 blocks are one wave on 132 SMs. Why the larger
// block wins at the same occupancy is not measured; a guess: its 16 warps
// leave the barrier together and run the same hash code, which the
// instruction cache favours. The hashes are straight-line register code
// (hash.cuh) called once per query set. The T interval bounds are read by
// every thread at the same address, so they sit in shared memory
// (broadcast reads); the bucket table joins them there when it fits, else
// it is read from global memory through the read-only cache.
//
// Layouts: bases (8, K) and tables (8, U) limb-major u32; tgt (4, T) rows
// [lo_hi, lo_lo, hi_hi, hi_lo]; btab (TB, 128); hits (K, U) row-major.
// The entry point launches on the given stream, does not synchronise, and
// returns a cudaError_t.
#include <cuda_runtime.h>

#include "batch_inv.cuh"
#include "fe.cuh"
#include "hash.cuh"

using kh::block_batch_inv;
using kh::Fe;

namespace {

// pbrute.MODES order
enum Mode { kXpoint = 0, kRmd160 = 1, kEth = 2, kAddressU = 3, kRmd160Both = 4 };

constexpr int kBruteGroup = 64;  // base rows per thread
constexpr int kThreads = 512;    // offset columns per block
constexpr uint32_t kHitDegenerate = 1u << 30;
constexpr size_t kTreeBytes = 2 * kThreads * sizeof(Fe);  // the static product tree
// dynamic shared memory (targets, bucket table): the most a block may use
// on sm_90 and the most it may use without opting in, less the tree
constexpr size_t kSmemMax = 232448 - kTreeBytes;
constexpr size_t kSmemDefault = 48 * 1024 - kTreeBytes;

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

struct Members {
  const unsigned long long* lo;  // (T,) interval bounds, shared memory
  const unsigned long long* hi;
  int T;
  const uint32_t* btab;  // (TB, 128): shared memory, or global when btab_global
  int TB;
  bool btab_global;
};

// a = high 32 bits, b = low 32 bits of the query's 64-bit compare value
__device__ __forceinline__ uint32_t member(uint32_t a, uint32_t b, const Members& m) {
  const unsigned long long v = ((unsigned long long)a << 32) | b;
  bool hit = false;
  for (int t = 0; t < m.T; t++) hit |= (m.lo[t] <= v) & (v <= m.hi[t]);
  if (m.TB && !hit) {
    const uint32_t* col = m.btab + (b & 127u);
    for (int r = 0; r < m.TB; r++) {
      const uint32_t hv = m.btab_global ? __ldg(col + r * 128) : col[r * 128];
      if (hv == a) {
        hit = true;
        break;
      }
    }
  }
  return hit ? 1u : 0u;
}

// digest words are little-endian; intervals are byte-lexicographic, so
// the compare value is big-endian bytes 0..7
__device__ __forceinline__ uint32_t member_digest(uint2 w, const Members& m) {
  return member(kh::bswap32(w.x), kh::bswap32(w.y), m);
}

template <int MODE, int NENDO>
__device__ __forceinline__ uint32_t point_hits(const Fe& x3, const Fe& y3, const Members& m) {
  uint32_t hit = 0;
  int q = 0;
#pragma unroll
  for (int e = 0; e < NENDO; e++) {
    const Fe xv = e == 0 ? x3 : kh::fe_mul(x3, fe_beta(e));
    if constexpr (MODE == kXpoint) {
      hit |= member(xv.v[1], xv.v[0], m) << q++;
    }
    if constexpr (MODE == kRmd160 || MODE == kRmd160Both) {
      hit |= member_digest(kh::hash160_parity_words(xv.v, 2u), m) << q++;
      hit |= member_digest(kh::hash160_parity_words(xv.v, 3u), m) << q++;
    }
    if constexpr (MODE == kRmd160Both || MODE == kAddressU) {
      hit |= member_digest(kh::hash160_u_words(xv.v, y3.v), m) << q++;
    }
    if constexpr (MODE == kEth) {
      hit |= member_digest(kh::keccak_eth_words(xv.v, y3.v), m) << q++;
    }
  }
  return hit;
}

// K4: thread = one offset column u and kBruteGroup = G consecutive base
// rows; block = kThreads neighbouring columns. Every thread reaches the
// block's inversion: ragged columns (u >= U) and rows (K % G) and dx == 0
// lanes enter the chain as 1, so no zero poisons the block.
template <int MODE, int NENDO>
__global__ void __launch_bounds__(kThreads)
brute_walk_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                  const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                  const uint32_t* __restrict__ tgt, const uint32_t* __restrict__ btab,
                  uint32_t* __restrict__ hits, long long K, int U, int T, int TB,
                  int btab_smem) {
  extern __shared__ unsigned long long smem[];
  __shared__ Fe tree[2 * kThreads];
  unsigned long long* lo = smem;
  unsigned long long* hi = smem + T;
  uint32_t* sbtab = reinterpret_cast<uint32_t*>(smem + 2 * T);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    lo[i] = ((unsigned long long)tgt[i] << 32) | tgt[T + i];
    hi[i] = ((unsigned long long)tgt[2 * T + i] << 32) | tgt[3 * T + i];
  }
  if (btab_smem) {
    for (int i = threadIdx.x; i < TB * 128; i += blockDim.x) sbtab[i] = btab[i];
  }
  const Members m{lo, hi, T, btab_smem ? sbtab : btab, TB, !btab_smem};

  constexpr int G = kBruteGroup;
  constexpr bool kNeedsY = MODE == kEth || MODE == kAddressU || MODE == kRmd160Both;
  const int i = threadIdx.x;
  const int u = blockIdx.y * kThreads + i;
  const long long r0 = (long long)blockIdx.x * G;
  const int n = u < U ? (int)min((long long)G, K - r0) : 0;  // rows of this thread
  const Fe one = kh::fe_one();
  Fe tX = one, tY = one;
  if (n) {
    tX = kh::fe_load_lm(tx, U, u);
    tY = kh::fe_load_lm(ty, U, u);
  }
  Fe pref[G];
  Fe acc = one;
  for (int j = 0; j < n; j++) {
    Fe dx = kh::fe_sub(tX, kh::fe_load_lm(bx, K, r0 + j));
    if (kh::fe_is_zero(dx)) dx = one;  // degenerate lane: invert 1 instead of 0
    acc = j ? kh::fe_mul(acc, dx) : dx;
    pref[j] = acc;
  }
  tree[kThreads + i] = acc;
  block_batch_inv<kh::fe_inv_var>(tree);  // its first barrier also covers smem
  Fe inv = tree[kThreads + i];  // 1 / (this thread's chain total)
  for (int j = n - 1; j >= 0; j--) {
    const Fe bX = kh::fe_load_lm(bx, K, r0 + j);
    const Fe bY = kh::fe_load_lm(by, K, r0 + j);
    Fe dx = kh::fe_sub(tX, bX);
    const bool degenerate = kh::fe_is_zero(dx);
    if (degenerate) dx = one;
    Fe inv_j = inv;
    if (j > 0) {
      inv_j = kh::fe_mul(inv, pref[j - 1]);
      inv = kh::fe_mul(inv, dx);
    }
    uint32_t hit = kHitDegenerate;  // garbage x3: the host verifies this key
    if (!degenerate) {
      const Fe lam = kh::fe_mul(kh::fe_sub(tY, bY), inv_j);
      const Fe x3 = kh::fe_sub(kh::fe_sub(kh::fe_sqr(lam), bX), tX);
      Fe y3 = x3;
      if constexpr (kNeedsY) y3 = kh::fe_sub(kh::fe_mul(lam, kh::fe_sub(bX, x3)), bY);
      hit = point_hits<MODE, NENDO>(x3, y3, m);
    }
    hits[(r0 + j) * U + u] = hit;
  }
}

template <int MODE, int NENDO>
cudaError_t launch(const void* bx, const void* by, const void* tx, const void* ty,
                   const void* tgt, const void* btab, void* hits, long long K, int U, int T,
                   int TB, cudaStream_t stream) {
  const size_t tgt_bytes = 16 * (size_t)T;
  const size_t btab_bytes = (size_t)TB * 128 * 4;
  const int btab_smem = TB > 0 && tgt_bytes + btab_bytes <= kSmemMax;
  const size_t smem = tgt_bytes + (btab_smem ? btab_bytes : 0);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = brute_walk_kernel<MODE, NENDO>;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)((K + kBruteGroup - 1) / kBruteGroup),
            (unsigned)((U + kThreads - 1) / kThreads));
  kernel<<<grid, kThreads, smem, stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx, (const uint32_t*)ty,
      (const uint32_t*)tgt, (const uint32_t*)btab, (uint32_t*)hits, K, U, T, TB, btab_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kh_brute_walk_blocks(const void* bx, const void* by, const void* tx,
                                    const void* ty, const void* tgt, const void* btab,
                                    void* hits, long long K, int U, int T, int TB, int mode,
                                    int n_endo, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define KH_BRUTE_CASE(M, E) \
  if (mode == M && n_endo == E) return (int)launch<M, E>(bx, by, tx, ty, tgt, btab, hits, K, U, T, TB, s)
  KH_BRUTE_CASE(kXpoint, 1);
  KH_BRUTE_CASE(kXpoint, 3);
  KH_BRUTE_CASE(kRmd160, 1);
  KH_BRUTE_CASE(kRmd160, 3);
  KH_BRUTE_CASE(kEth, 1);
  KH_BRUTE_CASE(kAddressU, 1);
  KH_BRUTE_CASE(kRmd160Both, 1);
#undef KH_BRUTE_CASE
  return (int)cudaErrorInvalidValue;
}
