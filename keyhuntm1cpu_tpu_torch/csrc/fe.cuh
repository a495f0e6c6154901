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

static __device__ __noinline__ Fe fe_sqr_n(Fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) x = fe_sqr(x);
  return x;
}

// a^(p-2) by the secp256k1 addition chain (255 squarings, 15 multiplies),
// the chain of fe_tiles.inv; maps 0 -> 0.
static __device__ __noinline__ Fe fe_inv(const Fe& a) {
  Fe x1 = a;
  Fe x2 = fe_mul(fe_sqr_n(x1, 1), x1);
  Fe x3 = fe_mul(fe_sqr_n(x2, 1), x1);
  Fe x6 = fe_mul(fe_sqr_n(x3, 3), x3);
  Fe x9 = fe_mul(fe_sqr_n(x6, 3), x3);
  Fe x11 = fe_mul(fe_sqr_n(x9, 2), x2);
  Fe x22 = fe_mul(fe_sqr_n(x11, 11), x11);
  Fe x44 = fe_mul(fe_sqr_n(x22, 22), x22);
  Fe x88 = fe_mul(fe_sqr_n(x44, 44), x44);
  Fe x176 = fe_mul(fe_sqr_n(x88, 88), x88);
  Fe x220 = fe_mul(fe_sqr_n(x176, 44), x44);
  Fe x223 = fe_mul(fe_sqr_n(x220, 3), x3);
  Fe t = fe_mul(fe_sqr_n(x223, 23), x22);
  t = fe_mul(fe_sqr_n(t, 5), x1);
  t = fe_mul(fe_sqr_n(t, 3), x2);
  return fe_mul(fe_sqr_n(t, 2), x1);
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
