// BSGS giant-step walk kernels for Hopper (sm_90a):
//   K1 kh_advance_chain  replaces keyhuntm1cpu_tpu/curve/pwalk.py:96 _advance_kernel
//   K2 kh_walk_blocks    replaces keyhuntm1cpu_tpu/curve/pwalk.py:195 _walk_kernel
// Wrappers and plain torch versions: keyhuntm1cpu_tpu_torch/curve/pwalk.py.
// Layouts: field elements limb-major (8, n) u32; the ADV table (8, K) with
// column j - 1 = j*ADV; bases (8, T*K) with column t*K + s; adeg (T, K)
// bytes; qlo/qhi/deg (R, U) row-major; K2's survivor mask (R, ceil(U/32))
// u32; the paired walk's centre offsets (8, K), centres (8, T*K) and their
// flags (T*K) bytes, and its pair table (8, U/2). Each entry point launches
// on the given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "batch_inv.cuh"
#include "fe.cuh"
#include "fe_walk.cuh"
#include "probe.cuh"

using kh::block_batch_inv;
using kh::Fe;

namespace {

// K1: the K walk bases P + s*ADV, s < K, and the next state P + K*ADV, as
// K independent affine adds P + j*ADV (j = 1..K) from the table of j*ADV.
//
// The TPU kernel walks a serial chain of K Jacobian mixed adds per target
// (128 targets side by side in its lanes). On this card a chain is one
// thread: at T = 1 it ran ~4,600 dependent field products on one lane
// while the card idled (2.37 ms at K = 256). ADV is a constant of the
// engine, so the table j*ADV is built once on the host and every lane is
// independent: block = a tile of kAdvTile lanes of one target, thread = one
// lane. The tile's denominators x(j*ADV) - x(P) share one inversion
// through a shared-memory product tree. Bound on the H100: latency, one
// inversion plus 3*log2(tile) products of the tree, against ~4,600
// products for the serial chain. The inversion is fe_inv_const, 600
// branch-free divsteps (an H100 at 700 W: 0.030 ms at K = 256, where the
// addition chain a^(p-2) took 0.120 and fe_inv_var 0.038). A tile of one
// warp has the shortest tree; more tiles only add inversions that run side
// by side (with the addition chain: 0.117 ms at 32 lanes, 0.124 at 256).
//
// Lane j is a doubling when P == j*ADV (lambda = 3x^2 / 2y) and the point
// at infinity when P == -j*ADV: it is flagged, inverts 1 and emits
// garbage, the same garbage as the plain version.
//
// CENTRES (the paired walk's K1): as many tiles again compute the row
// centres P + ctab[s], ctab[s] = s*ADV + c*S (s < K), the same adds in the
// same launch, and flag a row whose centre is not base_s + c*S as K2 needs
// it: the centre at infinity, base s at infinity (its garbage is not a
// point) or P off the curve (a garbage walk state). K2 walks a flagged row
// one point at a time.
constexpr int kAdvTile = 32;

template <bool CENTRES>
__global__ void __launch_bounds__(kAdvTile)
advance_chain_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                     const uint32_t* __restrict__ tab_x, const uint32_t* __restrict__ tab_y,
                     const uint32_t* __restrict__ ctab_x, const uint32_t* __restrict__ ctab_y,
                     uint32_t* __restrict__ bx, uint32_t* __restrict__ by,
                     uint32_t* __restrict__ nx, uint32_t* __restrict__ ny,
                     uint8_t* __restrict__ adeg, uint32_t* __restrict__ cx,
                     uint32_t* __restrict__ cy, uint8_t* __restrict__ cflag, int T, int K) {
  __shared__ Fe tree[2 * kAdvTile];
  const int i = threadIdx.x, t = blockIdx.x;
  const int tiles = (K + kAdvTile - 1) / kAdvTile;
  const bool centre = CENTRES && (int)blockIdx.y >= tiles;
  // this lane computes P + j*ADV (j = 1..K), or the centre of row j (j < K)
  const int j = centre ? ((int)blockIdx.y - tiles) * kAdvTile + i
                       : (int)blockIdx.y * kAdvTile + i + 1;
  const bool live = centre ? j < K : j <= K;
  const long long TK = (long long)T * K, col0 = (long long)t * K;
  const Fe one = kh::fe_one();
  const Fe p_x = kh::fe_load_lm(px, T, t), p_y = kh::fe_load_lm(py, T, t);
  Fe q_x = p_x, num = one, den = one;
  bool inf = false;
  if (live) {
    q_x = centre ? kh::fe_load_lm(ctab_x, K, j) : kh::fe_load_lm(tab_x, K, j - 1);
    const Fe q_y = centre ? kh::fe_load_lm(ctab_y, K, j) : kh::fe_load_lm(tab_y, K, j - 1);
    den = kh::fe_sub(q_x, p_x);
    num = kh::fe_sub(q_y, p_y);
    if (kh::fe_is_zero(den)) {
      if (kh::fe_eq(q_y, p_y)) {  // P == j*ADV: tangent slope 3x^2 / 2y
        const Fe x2 = kh::fe_sqr(p_x);
        num = kh::fe_add(kh::fe_dbl(x2), x2);
        den = kh::fe_dbl(p_y);
      } else {  // P == -j*ADV: infinity, flagged; invert 1
        inf = true;
        den = one;
      }
    }
  }
  tree[kAdvTile + i] = den;
  block_batch_inv<kh::fe_inv_const>(tree);
  if (!live) return;
  const Fe lam = kh::fe_mul(num, tree[kAdvTile + i]);
  const Fe x3 = kh::fe_sub(kh::fe_sub(kh::fe_sqr(lam), p_x), q_x);
  const Fe y3 = kh::fe_sub(kh::fe_mul(lam, kh::fe_sub(p_x, x3)), p_y);
  if (centre) {
    bool bad = inf;
    if (j > 0) {  // base j is K1's lane j: at infinity where P == -j*ADV
      const Fe a_x = kh::fe_load_lm(tab_x, K, j - 1), a_y = kh::fe_load_lm(tab_y, K, j - 1);
      bad |= kh::fe_eq(a_x, p_x) && !kh::fe_eq(a_y, p_y);
    }
    Fe seven = kh::fe_one();
    seven.v[0] = 7;
    bad |= !kh::fe_eq(kh::fe_sqr(p_y), kh::fe_add(kh::fe_mul(kh::fe_sqr(p_x), p_x), seven));
    kh::fe_store_lm(cx, TK, col0 + j, x3);
    kh::fe_store_lm(cy, TK, col0 + j, y3);
    cflag[col0 + j] = bad ? 1 : 0;
    return;
  }
  if (j < K) {
    kh::fe_store_lm(bx, TK, col0 + j, x3);
    kh::fe_store_lm(by, TK, col0 + j, y3);
  } else {
    kh::fe_store_lm(nx, T, t, x3);
    kh::fe_store_lm(ny, T, t, y3);
  }
  adeg[col0 + j - 1] = inf ? 1 : 0;
  if (j == 1) {  // base 0 is P itself
    kh::fe_store_lm(bx, TK, col0, p_x);
    kh::fe_store_lm(by, TK, col0, p_y);
  }
}

// K2: thread = one offset column u and kWalkGroup = G consecutive base rows;
// block = kWalkThreads neighbouring columns.
//
// Bound on the H100: the integer multiply pipe (~4 field products and a
// squaring per point; a 32x32->64 product, IMAD.WIDE, takes two of its
// slots, so a field product takes at least 128). The field arithmetic is
// K2's own (csrc/fe_walk.cuh): PTX carry chains whose products leave
// values in [0, 2^256), canonical only where K2 tests dx or emits x3;
// 148 / 124 SASS a product / squaring against fe.cuh's 305 / 250, and
// ~865 SASS a point for the products, squaring and subtractions against
// ~1,745. The TPU
// kernel batch-inverts each grid block's SB*U denominators with one
// powering, its 128 lanes side by side; one inversion per thread over its
// G points would cost ~1,350 instructions a point at G = 32, more than the
// walk's own ~830. Here every thread still runs its own Montgomery chain
// over its G denominators (prefix products in local memory, dx recomputed
// in the backward pass instead of stored), but the chain totals of the
// block go into a shared-memory product tree with ONE inversion per block
// (block_batch_inv), so the inversion costs a point 1/(G * threads) of an
// inversion plus ~3/G products. A flagged dx == 0 lane
// enters its chain as 1, and so do ragged rows and columns, so a zero
// never poisons the block. Neighbouring threads own neighbouring u: table
// loads and qlo/qhi/deg stores coalesce; the G base rows are warp-uniform
// broadcast loads. A block's inverting thread stalls the block for one
// inversion, and resident blocks reach it together, so the shape is one
// whose grid at R = 256, U = 16384 fits one wave of resident blocks: G =
// 64 rows and 256 threads (2 blocks an SM at most 128 registers), the
// backward loop unrolled by two (126 registers with the probe, 108
// without). On an H100 (700 W) with the probe: 0.3455 ms, against 0.3520
// not unrolled, 0.3541 at 128 threads (0.3543 unrolled) and 0.5190 with
// fe.cuh's arithmetic at 128 threads; the other shapes are in PERF.md
// (scripts/torch_pwalk_shapes.py). With fe.cuh's arithmetic and the
// addition chain a^(p-2) as the inversion: 0.584 ms at G = 64, 0.699 at G
// = 32, 0.928 at G = 16. The inversion is fe_inv_var: 0.493 ms, against
// 0.520 with fe_inv_const and 0.580 with the chain (fe.cuh's arithmetic).
//
// With a level-1 bitmap (PROBE), K2 also probes each key it emits, so the
// BSGS chunk needs no probe kernel of its own. That probe is one random
// 32-byte DRAM read a key (4,194,304 a chunk, 2^35 bits): alone it ran at
// the card's random-read ceiling (0.150 ms, csrc/probe.cu), while the
// walk's integer work left the DRAM idle. Here row j's word is read as
// soon as its x3 is out and tested at the end of row j - 1, one iteration
// of the backward loop later (thousands of instructions a warp), so its
// latency hides under the walk's products. A warp is 32 consecutive
// columns of one row, so the ballot of its bits is one word of the
// (R, ceil(U/32)) survivor mask, position-aligned; ragged columns give 0
// bits. The index math is the probe kernels' (csrc/probe.cuh). The
// ordered compaction of the mask is kh_mask_compact (csrc/probe.cu).
// Without a bitmap the kernel is the walk alone. On an H100 (700 W) at R
// = 256, U = 16384 and 2^35 bits, with fe.cuh's arithmetic: 0.523 ms
// against 0.497 for the walk alone and 0.150 for the probe kernel it
// replaces; testing each word in the iteration that read it took 0.525,
// and with a minimum of 4 blocks an SM in the launch bounds 0.530
// (scripts/torch_fused_probe_shapes.py).
constexpr int kWalkGroup = 64;
constexpr int kWalkThreads = 256;

template <bool PROBE>
__global__ void __launch_bounds__(kWalkThreads)
walk_blocks_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                   const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                   uint32_t* __restrict__ qlo, uint32_t* __restrict__ qhi,
                   uint8_t* __restrict__ deg, const uint32_t* __restrict__ words,
                   uint32_t* __restrict__ mask, long long R, int U, int bits) {
  constexpr int G = kWalkGroup;
  __shared__ Fe tree[2 * kWalkThreads];
  const int i = threadIdx.x;
  const int u = blockIdx.y * kWalkThreads + i;
  const long long r0 = (long long)blockIdx.x * G;
  const int n = u < U ? (int)min((long long)G, R - r0) : 0;  // rows of this thread
  const Fe one = kh::fe_one();
  Fe tX = one, tY = one;
  if (n) {
    tX = kh::fe_load_lm(tx, U, u);
    tY = kh::fe_load_lm(ty, U, u);
  }
  Fe pref[G];
  Fe acc = one;
  for (int j = 0; j < n; j++) {
    Fe dx = kh::fw_sub(tX, kh::fe_load_lm(bx, R, r0 + j));  // canonical: tX, bX are
    const bool z = kh::fe_is_zero(dx);
    deg[(r0 + j) * U + u] = z ? 1 : 0;
    if (z) dx = one;  // flagged lane: invert 1 instead of 0
    acc = j ? kh::fw_mul(acc, dx) : dx;
    pref[j] = acc;
  }
  tree[kWalkThreads + i] = acc;  // < 2^256, maybe not canonical: fe_mul takes it
  block_batch_inv<kh::fe_inv_var>(tree);
  Fe inv = tree[kWalkThreads + i];  // 1 / (this thread's chain total)
  // PROBE: the lanes of this warp with a column (a prefix of it; all run
  // the same rows), the mask's words a row, and the word read for row j + 1
  // with the key's bit in it
  const unsigned live = PROBE ? __ballot_sync(0xFFFFFFFFu, n > 0) : 0u;
  const int W = (U + 31) >> 5;
  uint32_t word = 0, bit = 0;
#pragma unroll 2
  for (int j = n - 1; j >= 0; j--) {
    const Fe bX = kh::fe_load_lm(bx, R, r0 + j);
    const Fe bY = kh::fe_load_lm(by, R, r0 + j);
    Fe inv_j = inv;
    if (j > 0) {
      Fe dx = kh::fw_sub(tX, bX);
      if (kh::fe_is_zero(dx)) dx = one;
      inv_j = kh::fw_mul(inv, pref[j - 1]);
      inv = kh::fw_mul(inv, dx);
    }
    const Fe lam = kh::fw_mul(kh::fw_sub(tY, bY), inv_j);
    uint32_t x3lo, x3hi;  // only the 64-bit truncation of canonical x3 leaves
    kh::fw_canon_lo(kh::fw_sub(kh::fw_sub(kh::fw_sqr(lam), bX), tX), x3lo, x3hi);
    qlo[(r0 + j) * U + u] = x3lo;
    qhi[(r0 + j) * U + u] = x3hi;
    if constexpr (PROBE) {
      if (j < n - 1) {  // row j + 1's word, read one iteration ago
        const unsigned hit = __ballot_sync(live, (word >> bit) & 1u);
        if ((i & 31) == 0) mask[(r0 + j + 1) * W + (u >> 5)] = hit;
      }
      word = kh::ld_word<true>(words + kh::word_of(x3lo, x3hi, bits));
      bit = x3lo & 31u;
    }
  }
  if constexpr (PROBE) {
    if (n) {  // row 0's
      const unsigned hit = __ballot_sync(live, (word >> bit) & 1u);
      if ((i & 31) == 0) mask[r0 * W + (u >> 5)] = hit;
    }
  }
}

// K2, paired: the same points, two a thread. Every caller walks a step
// table, tab_u = (u + 1)*S, so row r's U points base_r + tab_u are the U/2
// pairs C_r +- t_d around the centre C_r = base_r + c*S, c = (U + 1)/2 mod n
// (a half step), with t_d = (d + 1/2)*S, d < U/2: pair d is columns
// U/2 + d (C_r + t_d) and U/2 - 1 - d (C_r - t_d). Both share dx = x(t_d) -
// x(C_r), so one slot of the thread's Montgomery chain and one inverse;
// lambda is (y_t - y_C) / dx for one and (-y_C - y_t) / dx, up to a sign
// that lambda^2 removes, for the other. A pair is 3 chain products, 2
// lambdas, 2 squarings and 9 subtractions: 2.5 products and a squaring a
// point against walk_blocks_kernel's 4 and a squaring, with half its
// base-row loads and prefix products. The centres come from K1 (CENTRES).
//
// Thread = pair d over kPairGroup = G consecutive rows; a warp is 32
// consecutive d, so it writes 32 consecutive columns U/2 + d and 32
// consecutive columns U/2 - 1 - d in reverse: with U % 64 == 0 each side's
// probe ballot is one word of the survivor mask, the minus side's
// bit-reversed. Other U take walk_blocks_kernel. G = 32 pair rows (a
// thread's 64 points, as before) at 128 threads: 512 blocks at R = 256, U =
// 16,384, one wave at 4 blocks an SM, the launch bounds holding it to 128
// registers (8 bytes spilled with the probe). On an H100 (700 W) at 2^35
// bits: 0.2677 ms with the probe and 0.2323 alone, against
// walk_blocks_kernel's 0.3476 / 0.3083; at 256 threads 0.2683 / 0.2301;
// with the loop unrolled by two 0.2730; without the launch bounds' cap
// (156 registers with the probe) 0.3592. The build's R = 128, U = 4,096:
// 0.1065 ms against 0.1868 (scripts/torch_pwalk_shapes.py sweeps the
// shapes).
//
// Rare lanes are walked again alone after the loop, exactly as
// walk_blocks_kernel walks them (lone_point), so the words are the same: a
// pair with dx == 0 (C_r == +-t_d: one column is the point at infinity,
// flagged, the other 2*C_r) enters its chain as 1 and walks both columns
// alone; a column with x(base_r) == x(tab_u) (base_r == tab_u:
// walk_blocks_kernel flags it, where the pair would give the doubling),
// found by the low words of both x, walks alone (a false match, 2^-32 a
// lane, to the same word); so does every column of a row K1 flagged.
constexpr int kPairGroup = 32;
constexpr int kPairThreads = 128;
constexpr int kPairResident = 512;  // threads an SM the launch bounds ask for: 128 registers
constexpr int kPairUnroll = 1;  // the backward loop's unrolling

// walk_blocks_kernel's word for (row r, column u), with an inversion of its
// own: x's canonical low 64 bits and the dx == 0 flag.
__device__ __noinline__ uint3 lone_point(const uint32_t* __restrict__ bx,
                                         const uint32_t* __restrict__ by,
                                         const uint32_t* __restrict__ tx,
                                         const uint32_t* __restrict__ ty, long long R, int U,
                                         long long r, int u) {
  const Fe bX = kh::fe_load_lm(bx, R, r), bY = kh::fe_load_lm(by, R, r);
  const Fe tX = kh::fe_load_lm(tx, U, u), tY = kh::fe_load_lm(ty, U, u);
  Fe dx = kh::fe_sub(tX, bX);
  const bool z = kh::fe_is_zero(dx);
  if (z) dx = kh::fe_one();
  const Fe lam = kh::fe_mul(kh::fe_sub(tY, bY), kh::fe_inv_var(dx));
  const Fe x3 = kh::fe_sub(kh::fe_sub(kh::fe_sqr(lam), bX), tX);
  return make_uint3(x3.v[0], x3.v[1], z ? 1u : 0u);
}

template <bool PROBE>
__global__ void __launch_bounds__(kPairThreads, kPairResident / kPairThreads)
walk_pairs_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                  const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                  const uint32_t* __restrict__ hx, const uint32_t* __restrict__ hy,
                  const uint32_t* __restrict__ cx, const uint32_t* __restrict__ cy,
                  const uint8_t* __restrict__ cflag, uint32_t* __restrict__ qlo,
                  uint32_t* __restrict__ qhi, uint8_t* __restrict__ deg,
                  const uint32_t* __restrict__ words, uint32_t* __restrict__ mask, long long R,
                  int U, int bits) {
  constexpr int G = kPairGroup;
  static_assert(G <= 64, "a thread's rare rows are bits of a 64-bit word");
  __shared__ Fe tree[2 * kPairThreads];
  const int i = threadIdx.x, H = U >> 1;
  const int d = blockIdx.y * kPairThreads + i;
  const int up = H + d, um = H - 1 - d;  // the pair's columns
  const long long r0 = (long long)blockIdx.x * G;
  const int n = d < H ? (int)min((long long)G, R - r0) : 0;  // rows of this thread
  const Fe one = kh::fe_one();
  Fe zero = one;
  zero.v[0] = 0;
  Fe hX = one, hY = one;  // t_d
  uint32_t up0 = 0, um0 = 0;  // the low words of x(tab_up), x(tab_um)
  if (n) {
    hX = kh::fe_load_lm(hx, H, d);
    hY = kh::fe_load_lm(hy, H, d);
    up0 = tx[up];
    um0 = tx[um];
  }
  Fe pref[G];
  Fe acc = one;
  for (int j = 0; j < n; j++) {
    Fe dx = kh::fw_sub(hX, kh::fe_load_lm(cx, R, r0 + j));  // canonical: hX, cX are
    if (kh::fe_is_zero(dx)) dx = one;  // C == +-t: both columns walk alone
    acc = j ? kh::fw_mul(acc, dx) : dx;
    pref[j] = acc;
  }
  tree[kPairThreads + i] = acc;
  block_batch_inv<kh::fe_inv_var>(tree);
  Fe inv = tree[kPairThreads + i];  // 1 / (this thread's chain total)
  // PROBE: as walk_blocks_kernel's, a word of each side a row in flight
  const unsigned live = PROBE ? __ballot_sync(0xFFFFFFFFu, n > 0) : 0u;
  const int W = U >> 5;
  const int d0 = d & ~31;  // the warp's first pair: its mask words, each side's
  const int wp = (H + d0) >> 5, wm = ((H - d0) >> 5) - 1;
  uint32_t word_p = 0, bit_p = 0, word_m = 0, bit_m = 0;
  unsigned long long rare = 0;  // bit j: row j has a rare lane in this pair
#pragma unroll kPairUnroll
  for (int j = n - 1; j >= 0; j--) {
    const long long r = r0 + j;
    const Fe cX = kh::fe_load_lm(cx, R, r);
    const Fe cY = kh::fe_load_lm(cy, R, r);
    Fe dx = kh::fw_sub(hX, cX);
    const bool z = kh::fe_is_zero(dx);
    Fe inv_j = inv;
    if (j > 0) {
      if (z) dx = one;
      inv_j = kh::fw_mul(inv, pref[j - 1]);
      inv = kh::fw_mul(inv, dx);
    }
    // -y_C - y_t: -y_C is canonical where y_C is (a point's y is never 0)
    const Fe lam_p = kh::fw_mul(kh::fw_sub(hY, cY), inv_j);
    const Fe lam_m = kh::fw_mul(kh::fw_sub(kh::fw_sub(zero, cY), hY), inv_j);
    uint32_t lo_p, hi_p, lo_m, hi_m;
    kh::fw_canon_lo(kh::fw_sub(kh::fw_sub(kh::fw_sqr(lam_p), cX), hX), lo_p, hi_p);
    kh::fw_canon_lo(kh::fw_sub(kh::fw_sub(kh::fw_sqr(lam_m), cX), hX), lo_m, hi_m);
    const uint32_t b0 = bx[r];
    if (z || cflag[r] || b0 == up0 || b0 == um0)
      rare |= 1ull << j;
    const long long o = r * U;
    qlo[o + up] = lo_p;
    qhi[o + up] = hi_p;
    deg[o + up] = 0;
    qlo[o + um] = lo_m;
    qhi[o + um] = hi_m;
    deg[o + um] = 0;
    if constexpr (PROBE) {
      if (j < n - 1) {  // row j + 1's words, read one iteration ago
        const unsigned hp = __ballot_sync(live, (word_p >> bit_p) & 1u);
        const unsigned hm = __ballot_sync(live, (word_m >> bit_m) & 1u);
        if ((i & 31) == 0) {
          mask[(r + 1) * W + wp] = hp;
          mask[(r + 1) * W + wm] = __brev(hm);
        }
      }
      word_p = kh::ld_word<true>(words + kh::word_of(lo_p, hi_p, bits));
      bit_p = lo_p & 31u;
      word_m = kh::ld_word<true>(words + kh::word_of(lo_m, hi_m, bits));
      bit_m = lo_m & 31u;
    }
  }
  if constexpr (PROBE) {
    if (n) {  // row 0's
      const unsigned hp = __ballot_sync(live, (word_p >> bit_p) & 1u);
      const unsigned hm = __ballot_sync(live, (word_m >> bit_m) & 1u);
      if ((i & 31) == 0) {
        mask[r0 * W + wp] = hp;
        mask[r0 * W + wm] = __brev(hm);
      }
    }
  }
  // the rare lanes, out of the loop (lone_point called in it cost the loop
  // registers and spills: 0.2753 ms with the probe at 256 threads against
  // 0.2711 so): the
  // warp takes each row where any of its lanes has one, walks those
  // columns alone and writes the row's words and mask words again
  unsigned long long todo = rare;  // warp-uniform: a warp is all live or all not
#pragma unroll
  for (int o = 16; o; o >>= 1) todo |= __shfl_xor_sync(0xFFFFFFFFu, todo, o);
  while (todo) {
    const int j = __ffsll((long long)todo) - 1;
    todo &= todo - 1;
    const long long r = r0 + j, o = r * U;
    const bool alone = kh::fe_is_zero(kh::fw_sub(hX, kh::fe_load_lm(cx, R, r))) || cflag[r];
    const uint32_t b0 = bx[r];
    uint3 qp = make_uint3(qlo[o + up], qhi[o + up], 0);
    uint3 qm = make_uint3(qlo[o + um], qhi[o + um], 0);
    if (alone || b0 == up0) {
      qp = lone_point(bx, by, tx, ty, R, U, r, up);
      qlo[o + up] = qp.x;
      qhi[o + up] = qp.y;
      deg[o + up] = (uint8_t)qp.z;
    }
    if (alone || b0 == um0) {
      qm = lone_point(bx, by, tx, ty, R, U, r, um);
      qlo[o + um] = qm.x;
      qhi[o + um] = qm.y;
      deg[o + um] = (uint8_t)qm.z;
    }
    if constexpr (PROBE) {
      const uint32_t wdp = kh::ld_word<true>(words + kh::word_of(qp.x, qp.y, bits));
      const uint32_t wdm = kh::ld_word<true>(words + kh::word_of(qm.x, qm.y, bits));
      const unsigned hp = __ballot_sync(live, (wdp >> (qp.x & 31u)) & 1u);
      const unsigned hm = __ballot_sync(live, (wdm >> (qm.x & 31u)) & 1u);
      if ((i & 31) == 0) {
        mask[r * W + wp] = hp;
        mask[r * W + wm] = __brev(hm);
      }
    }
  }
}

}  // namespace

// ctab_x / ctab_y: the centre offsets (8, K) (null: the bases alone); then
// the centres go to cx / cy (8, T*K) and their flags to cflag (T*K) bytes.
extern "C" int kh_advance_chain(const void* px, const void* py, const void* tab_x,
                                const void* tab_y, void* bx, void* by, void* nx, void* ny,
                                void* adeg, const void* ctab_x, const void* ctab_y, void* cx,
                                void* cy, void* cflag, int T, int K, void* stream) {
  if (T < 1 || K < 1 || (ctab_x && !(ctab_y && cx && cy && cflag)))
    return (int)cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((K + kAdvTile - 1) / kAdvTile);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *p_x = (const uint32_t*)px, *p_y = (const uint32_t*)py;
  const uint32_t *t_x = (const uint32_t*)tab_x, *t_y = (const uint32_t*)tab_y;
  if (ctab_x) {
    advance_chain_kernel<true><<<dim3((unsigned)T, 2 * tiles), kAdvTile, 0, s>>>(
        p_x, p_y, t_x, t_y, (const uint32_t*)ctab_x, (const uint32_t*)ctab_y, (uint32_t*)bx,
        (uint32_t*)by, (uint32_t*)nx, (uint32_t*)ny, (uint8_t*)adeg, (uint32_t*)cx,
        (uint32_t*)cy, (uint8_t*)cflag, T, K);
  } else {
    advance_chain_kernel<false><<<dim3((unsigned)T, tiles), kAdvTile, 0, s>>>(
        p_x, p_y, t_x, t_y, nullptr, nullptr, (uint32_t*)bx, (uint32_t*)by, (uint32_t*)nx,
        (uint32_t*)ny, (uint8_t*)adeg, nullptr, nullptr, nullptr, T, K);
  }
  return (int)cudaGetLastError();
}

// words: the level-1 bitmap (2^bits bits) to probe the keys against, its
// survivor mask written to mask (R, ceil(U/32)) u32; null: the walk alone
// (mask unused). hx / hy: the pair table (8, U/2) of the step table tx / ty,
// with the rows' centres cx / cy (8, R) and flags cflag (R) from K1: the
// paired walk (U % 64 == 0); null: a point a thread.
extern "C" int kh_walk_blocks(const void* bx, const void* by, const void* tx,
                              const void* ty, void* qlo, void* qhi, void* deg,
                              const void* words, void* mask, const void* hx, const void* hy,
                              const void* cx, const void* cy, const void* cflag, long long R,
                              int U, int bits, void* stream) {
  if (R < 1 || U < 1 || (words && (!mask || bits < 5 || bits > 35)) ||
      (hx && (U % 64 || !(hy && cx && cy && cflag))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *b_x = (const uint32_t*)bx, *b_y = (const uint32_t*)by;
  const uint32_t *t_x = (const uint32_t*)tx, *t_y = (const uint32_t*)ty;
  if (hx) {
    dim3 grid((unsigned)((R + kPairGroup - 1) / kPairGroup),
              (unsigned)((U / 2 + kPairThreads - 1) / kPairThreads));
    const uint32_t *h_x = (const uint32_t*)hx, *h_y = (const uint32_t*)hy;
    const uint32_t *c_x = (const uint32_t*)cx, *c_y = (const uint32_t*)cy;
    if (words) {
      walk_pairs_kernel<true><<<grid, kPairThreads, 0, s>>>(
          b_x, b_y, t_x, t_y, h_x, h_y, c_x, c_y, (const uint8_t*)cflag, (uint32_t*)qlo,
          (uint32_t*)qhi, (uint8_t*)deg, (const uint32_t*)words, (uint32_t*)mask, R, U, bits);
    } else {
      walk_pairs_kernel<false><<<grid, kPairThreads, 0, s>>>(
          b_x, b_y, t_x, t_y, h_x, h_y, c_x, c_y, (const uint8_t*)cflag, (uint32_t*)qlo,
          (uint32_t*)qhi, (uint8_t*)deg, nullptr, nullptr, R, U, 0);
    }
    return (int)cudaGetLastError();
  }
  dim3 grid((unsigned)((R + kWalkGroup - 1) / kWalkGroup),
            (unsigned)((U + kWalkThreads - 1) / kWalkThreads));
  if (words) {
    walk_blocks_kernel<true><<<grid, kWalkThreads, 0, s>>>(
        b_x, b_y, t_x, t_y, (uint32_t*)qlo, (uint32_t*)qhi, (uint8_t*)deg,
        (const uint32_t*)words, (uint32_t*)mask, R, U, bits);
  } else {
    walk_blocks_kernel<false><<<grid, kWalkThreads, 0, s>>>(
        b_x, b_y, t_x, t_y, (uint32_t*)qlo, (uint32_t*)qhi, (uint8_t*)deg, nullptr, nullptr,
        R, U, 0);
  }
  return (int)cudaGetLastError();
}
