// secp256k1 field arithmetic for one thread: the device twin of
// keyhuntm1cpu_tpu_torch/field/fe.py and of keyhuntm1cpu_tpu/field/fe_tiles.py.
//
// An element is 8 little-endian u32 limbs. Products use native 32x32->64
// multiplies (the TPU version splits into 16-bit halves because its vector
// unit has no wide multiply). p = 2^256 - 2^32 - 977, so 2^256 folds to
// 2^32 + 977.
//
// Every function returns a CANONICAL value (< p) for canonical inputs. This
// is load-bearing: the walk emits the low 64 bits of x3 and tests is_zero/eq
// on differences, so a lazily reduced value would give a different
// truncation (a silent false negative), not just a different representation.
#pragma once

#include <cstdint>

namespace kh {

struct Fe {
  uint32_t v[8];
};

static __device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  r.v[0] = 1;
  return r;
}

static __device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = a.v[0];
#pragma unroll
  for (int i = 1; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

static __device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// r = a + (2^256 - p) mod 2^256; returns the carry out, which is 1
// exactly when a >= p (then r = a - p).
static __device__ __forceinline__ uint32_t fe_add_negp(Fe& r, const Fe& a) {
  uint64_t c = (uint64_t)a.v[0] + 0x3D1u;
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + (uint64_t)a.v[1] + 1u;
  r.v[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += a.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

static __device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s, d;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  uint32_t cc = fe_add_negp(d, s);
  return ((uint32_t)c | cc) ? d : s;
}

static __device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  const uint32_t P[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                         0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
  Fe r;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  if (borrow) {  // wrapped by 2^256: add p back (mod 2^256)
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      c += (uint64_t)r.v[i] + P[i];
      r.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return r;
}

static __device__ __forceinline__ Fe fe_dbl(const Fe& a) { return fe_add(a, a); }

// The 512-bit product t (16 limbs) mod p, canonical.
static __device__ __forceinline__ Fe fe_reduce(const uint32_t (&t)[16]) {
  // t = lo + hi * 2^256 = lo + hi * 977 + hi * 2^32 (mod p)
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)t[8 + i] * 977u + t[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  uint64_t c2 = 0;
#pragma unroll
  for (int i = 1; i < 8; i++) {
    c2 += (uint64_t)r.v[i] + t[7 + i];
    r.v[i] = (uint32_t)c2;
    c2 >>= 32;
  }
  uint64_t top = c + c2 + t[15];  // coefficient of 2^256, < 2^33
  c = (uint64_t)r.v[0] + top * 977u;
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + (uint64_t)r.v[1] + top;
  r.v[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += r.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  if (c) {  // wrapped: r < 2^76, so adding 2^32 + 977 cannot carry out
    c = (uint64_t)r.v[0] + 977u;
    r.v[0] = (uint32_t)c;
    c = (c >> 32) + (uint64_t)r.v[1] + 1u;
    r.v[1] = (uint32_t)c;
    c >>= 32;
#pragma unroll
    for (int i = 2; i < 8; i++) {
      c += r.v[i];
      r.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  Fe d;
  if (fe_add_negp(d, r)) r = d;  // r < 2^256 < 2p: one subtraction suffices
  return r;
}

static __device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.v[i] * b.v[j] + t[i + j];  // <= 2^64 - 1
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  return fe_reduce(t);
}

// a^2 with 36 products instead of 64: the 28 cross products a_i a_j (i < j)
// once, doubled by a one-bit shift, plus the 8 squares a_i^2 on the
// diagonal. The same reduction as fe_mul, so the result is identical.
static __device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      c += (uint64_t)a.v[i] * a.v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // the cross sum is < 2^511: doubling it cannot carry out of t[15]
#pragma unroll
  for (int i = 15; i > 0; i--) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint64_t d = (uint64_t)a.v[i] * a.v[i];
    c += (uint64_t)t[2 * i] + (uint32_t)d;
    t[2 * i] = (uint32_t)c;
    c = (c >> 32) + (uint64_t)t[2 * i + 1] + (d >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  return fe_reduce(t);
}

// a^-1 mod p by safegcd divsteps (Bernstein-Yang, in the formulation of
// libsecp256k1's modinv32): batches of 30 divsteps on the low bits of f, g
// give a 2x2 transition matrix, applied to f, g and to the Bezout-style d,
// e in signed 30-bit limbs; ~20 batches where the addition chain a^(p-2)
// needs 270 dependent products, so a much shorter chain of dependent
// operations for one thread. Two forms, both exact and mapping 0 -> 0:
// fe_inv_var (variable time: stops when g = 0, skips runs of zero bits)
// and fe_inv_const (a fixed count of branch-free divsteps). Which kernel
// takes which was measured on the card (scripts/torch_pinv_shapes.py):
// pinv, K1 and K6's to-affine launch are fastest with fe_inv_const, K2 and
// K4 (which pay one inversion per thread or block among their walks) with
// fe_inv_var (PERF.md has the times).
struct Fe30 {
  int32_t v[9];  // value = sum v[i] * 2^(30 i), limbs signed
};

// p = 2^256 - 2^32 - 977 in signed 30-bit limbs, and p^-1 mod 2^30
static __device__ __forceinline__ Fe30 fe30_p() {
  Fe30 m = {{-0x3D1, -4, 0, 0, 0, 0, 0, 0, 65536}};
  return m;
}
constexpr uint32_t kPInv30 = 0x2DDACACFu;
constexpr int32_t kM30 = 0x3FFFFFFF;

// a (< 2^256) in 9 non-negative 30-bit limbs
static __device__ __forceinline__ Fe30 fe30_from_fe(const Fe& a) {
  Fe30 g;
#pragma unroll
  for (int i = 0; i < 9; i++) {  // bits [30 i, 30 i + 30) of a
    const int lo = 30 * i, w = lo >> 5, s = lo & 31;
    uint64_t bits = a.v[w] >> s;
    if (w + 1 < 8) bits |= (uint64_t)a.v[w + 1] << (32 - s);
    g.v[i] = (int32_t)(bits & kM30);
  }
  return g;
}

// The end of a divsteps inversion: g = 0 and f = +-1 (fn, its top limb,
// holds the sign); d = +-a^-1 in (-2p, p): to [0, p), negated when f < 0.
static __device__ __forceinline__ Fe fe30_normalize(Fe30 d, int32_t fn) {
  const Fe30 p = fe30_p();
  const int32_t sign = fn >> 31;
  int32_t add = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] = ((d.v[i] + (p.v[i] & add)) ^ sign) - sign;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= kM30;
  }
  add = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] += p.v[i] & add;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= kM30;
  }
  Fe out;
#pragma unroll
  for (int w = 0; w < 8; w++) {  // bits [32 w, 32 w + 32) of d (32 w % 30 <= 14)
    const int lo = 32 * w, i = lo / 30, s = lo % 30;
    out.v[w] = (uint32_t)(((uint64_t)(uint32_t)d.v[i] >> s) |
                          ((uint64_t)(uint32_t)d.v[i + 1] << (30 - s)));
  }
  return out;
}


// 30 divsteps from eta on the low words of f and g; returns the new eta
// and the transition matrix (u, v; q, r), scaled by 2^30.
static __device__ __forceinline__ int32_t divsteps_30(int32_t eta, uint32_t f0, uint32_t g0,
                                                      int32_t& tu, int32_t& tv, int32_t& tq,
                                                      int32_t& tr) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
  int i = 30;
#pragma unroll 1
  for (;;) {
    // the zero bits of g, up to i, are divsteps that halve g
    const int zeros = __ffs(g | (0xFFFFFFFFu << i)) - 1;
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {  // swap: f, g = g, -f
      uint32_t t;
      eta = -eta;
      t = f; f = g; g = 0u - t;
      t = u; u = q; q = 0u - t;
      t = v; v = r; r = 0u - t;
    }
    // cancel the low min(eta + 1, i, 8) bits of g with a multiple of f
    const int limit = (eta + 1) > i ? i : (eta + 1);
    const uint32_t m = (0xFFFFFFFFu >> (32 - limit)) & 255u;
    uint32_t fi = f;  // f^-1 mod 2^8 (f is odd): Newton from 3 correct bits
    fi *= 2u - f * fi;
    fi *= 2u - f * fi;
    const uint32_t w = (g * (0u - fi)) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  tu = (int32_t)u;
  tv = (int32_t)v;
  tq = (int32_t)q;
  tr = (int32_t)r;
  return eta;
}

// d, e = (t [d, e] + p [md, me]) / 2^30, md and me chosen to make the
// division exact and to keep d, e in range.
static __device__ __forceinline__ void update_de_30(Fe30& d, Fe30& e, int32_t u, int32_t v,
                                                    int32_t q, int32_t r) {
  const Fe30 p = fe30_p();
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)p.v[0] * md;
  ce += (int64_t)p.v[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    const int32_t di = d.v[i], ei = e.v[i];
    cd += (int64_t)u * di + (int64_t)v * ei + (int64_t)p.v[i] * md;
    ce += (int64_t)q * di + (int64_t)r * ei + (int64_t)p.v[i] * me;
    d.v[i - 1] = (int32_t)cd & kM30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & kM30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// f, g = t [f, g] / 2^30 over their len low limbs (exact by construction).
// Limbs are picked by unrolled compares, not by len as an index, so f and g
// stay in registers.
static __device__ __forceinline__ void update_fg_30(int len, Fe30& f, Fe30& g, int32_t u,
                                                    int32_t v, int32_t q, int32_t r) {
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i <= 9; i++) {
    if (i < len) {
      const int32_t fi = f.v[i], gi = g.v[i];
      cf += (int64_t)u * fi + (int64_t)v * gi;
      cg += (int64_t)q * fi + (int64_t)r * gi;
      f.v[i - 1] = (int32_t)cf & kM30;
      cf >>= 30;
      g.v[i - 1] = (int32_t)cg & kM30;
      cg >>= 30;
    } else if (i == len) {
      f.v[i - 1] = (int32_t)cf;
      g.v[i - 1] = (int32_t)cg;
    }
  }
}

static __device__ __noinline__ Fe fe_inv_var(const Fe& a) {
  Fe30 d = {{0, 0, 0, 0, 0, 0, 0, 0, 0}}, e = {{1, 0, 0, 0, 0, 0, 0, 0, 0}};
  Fe30 f = fe30_p(), g = fe30_from_fe(a);
  int len = 9;
  int32_t eta = -1, fn = 0;
#pragma unroll 1
  for (;;) {
    int32_t u, v, q, r;
    eta = divsteps_30(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], u, v, q, r);
    update_de_30(d, e, u, v, q, r);
    update_fg_30(len, f, g, u, v, q, r);
    int32_t gn = 0, any = 0;
#pragma unroll
    for (int j = 0; j < 9; j++) {
      if (j < len) any |= g.v[j];
      if (j == len - 1) {
        fn = f.v[j];
        gn = g.v[j];
      }
    }
    if (any == 0) break;
    // drop the top limb once it is 0 or -1 in both f and g, its sign
    // moving into the limb below
    if (len > 1 && ((fn ^ (fn >> 31)) | (gn ^ (gn >> 31))) == 0) {
#pragma unroll
      for (int j = 0; j < 8; j++) {
        if (j == len - 2) {
          f.v[j] = (int32_t)((uint32_t)f.v[j] | ((uint32_t)fn << 30));
          g.v[j] = (int32_t)((uint32_t)g.v[j] | ((uint32_t)gn << 30));
        }
      }
      --len;
    }
  }
  return fe30_normalize(d, fn);
}

// a^-1 mod p by a fixed count of safegcd divsteps (libsecp256k1's
// constant-time modinv32): 20 batches of 30 branch-free divsteps (590
// suffice for a 256-bit input), each batch's matrix applied to d, e and
// to all 9 limbs of f, g. Every input runs the same instructions, so the
// lanes of a warp never diverge; the divstep itself is a few dependent
// logic operations where fe_inv_var's loop pays a bit scan, a branch and a
// Newton inverse per group of bits. Maps 0 -> 0 (g = 0 leaves d = 0); the
// result equals fe_inv_var's.
static __device__ __forceinline__ int32_t divsteps_30_const(int32_t zeta, uint32_t f0,
                                                            uint32_t g0, int32_t& tu,
                                                            int32_t& tv, int32_t& tq,
                                                            int32_t& tr) {
  // zeta = -(delta + 1/2); masks in place of branches
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    const uint32_t neg = (uint32_t)(zeta >> 31);  // zeta < 0: swap when g is odd
    const uint32_t odd = 0u - (g & 1u);
    g += ((f ^ neg) - neg) & odd;
    q += ((u ^ neg) - neg) & odd;
    r += ((v ^ neg) - neg) & odd;
    const uint32_t swap = neg & odd;
    zeta = (zeta ^ (int32_t)swap) - 1;
    f += g & swap;
    u += q & swap;
    v += r & swap;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  tu = (int32_t)u;
  tv = (int32_t)v;
  tq = (int32_t)q;
  tr = (int32_t)r;
  return zeta;
}

static __device__ __noinline__ Fe fe_inv_const(const Fe& a) {
  Fe30 d = {{0, 0, 0, 0, 0, 0, 0, 0, 0}}, e = {{1, 0, 0, 0, 0, 0, 0, 0, 0}};
  Fe30 f = fe30_p(), g = fe30_from_fe(a);
  int32_t zeta = -1;
#pragma unroll 1
  for (int b = 0; b < 20; b++) {
    int32_t u, v, q, r;
    zeta = divsteps_30_const(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], u, v, q, r);
    update_de_30(d, e, u, v, q, r);
    update_fg_30(9, f, g, u, v, q, r);
  }
  return fe30_normalize(d, f.v[8]);
}

// Limb-major (8, n) access: limb i of column col at p[i * n + col].
static __device__ __forceinline__ Fe fe_load_lm(const uint32_t* p, long long n,
                                                long long col) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = p[i * n + col];
  return r;
}

static __device__ __forceinline__ void fe_store_lm(uint32_t* p, long long n,
                                                   long long col, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) p[i * n + col] = a.v[i];
}

// Row-major (n, 8) access: one element = 32 contiguous bytes (2 x uint4).
static __device__ __forceinline__ Fe fe_load_row(const uint32_t* p, long long row) {
  const uint4* q = reinterpret_cast<const uint4*>(p + row * 8);
  uint4 a = q[0], b = q[1];
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

static __device__ __forceinline__ void fe_store_row(uint32_t* p, long long row,
                                                    const Fe& r) {
  uint4* q = reinterpret_cast<uint4*>(p + row * 8);
  q[0] = make_uint4(r.v[0], r.v[1], r.v[2], r.v[3]);
  q[1] = make_uint4(r.v[4], r.v[5], r.v[6], r.v[7]);
}

}  // namespace kh
