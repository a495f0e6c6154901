// K2's own field arithmetic (csrc/pwalk.cu kh_walk_blocks; no other kernel
// includes it): a product, a squaring and a subtraction of 8 little-endian
// u32 limbs that leave values in [0, 2^256) instead of [0, p), and
// canonical values made only where K2 tests or emits them.
//
// Why K2 has its own: on an H100 a 32x32->64 multiply (IMAD.WIDE) takes
// two slots of the integer multiply pipe, so a 256-bit product costs at
// least 128 of them, and fe.cuh's fe_mul / fe_sqr compile to 73 / 45
// IMAD.WIDE and 74 / 77 IMAD beside 141 / 121 IADD3, LOP3, SHF and SEL
// (305 / 250 SASS; scripts/torch_pwalk_shapes.py counts them). Here the
// partial products run as PTX carry chains, even and odd limbs of the
// multiplicand in two accumulators (each chain's products land on whole
// 64-bit words, so a lo/hi pair of a row adds into two words with one
// carry), and the reduction by 2^256 = 2^32 + 977 (mod p) stops at
// [0, 2^256): no compare-and-select of fe_add_negp per product. fw_mul /
// fw_sqr compile to 72 / 45 IMAD.WIDE and 4 / 15 IMAD beside 49 / 59
// IADD3 and SEL and 23 / 5 moves (148 / 124 SASS); on an H100 (700 W)
// they ran 2.71 / 1.88 SM clocks a product against fe_mul / fe_sqr's
// 4.41 / 2.95 (independent chains).
//
// Contract: every input of fw_mul / fw_sqr is < 2^256 (any, canonical or
// not), and so is every result; fw_sub takes a < 2^256 and a canonical b;
// fw_canon_lo gives the low 64 bits of the canonical value. The results are
// equal mod p to fe.cuh's, so the canonical values K2 emits are equal bit
// for bit. The limb-exact model beside the tests
// (tests/test_torch_fe_walk.py) runs the same steps with their bounds.
#pragma once

#include <cstdint>

#include "fe.cuh"

namespace kh {

// r[0..8) = a0 b, a1 b, a2 b, a3 b as lo/hi pairs
static __device__ __forceinline__ void fw_mul4(uint32_t* r, uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b) {
  asm("mul.lo.u32 %0, %8, %12;\n\t"
      "mul.hi.u32 %1, %8, %12;\n\t"
      "mul.lo.u32 %2, %9, %12;\n\t"
      "mul.hi.u32 %3, %9, %12;\n\t"
      "mul.lo.u32 %4, %10, %12;\n\t"
      "mul.hi.u32 %5, %10, %12;\n\t"
      "mul.lo.u32 %6, %11, %12;\n\t"
      "mul.hi.u32 %7, %11, %12;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b));
}

// r[0..6) = a0 b, a1 b, a2 b
static __device__ __forceinline__ void fw_mul3(uint32_t* r, uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t b) {
  asm("mul.lo.u32 %0, %6, %9;\n\t"
      "mul.hi.u32 %1, %6, %9;\n\t"
      "mul.lo.u32 %2, %7, %9;\n\t"
      "mul.hi.u32 %3, %7, %9;\n\t"
      "mul.lo.u32 %4, %8, %9;\n\t"
      "mul.hi.u32 %5, %8, %9;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5])
      : "r"(a0), "r"(a1), "r"(a2), "r"(b));
}

// r[0..2k) += (a_0 .. a_{k-1}) * b as lo/hi pairs. CARRY: the carry out goes
// into r[2k], a word not written yet (set, not added); else r[2k - 1] was
// not written yet (0), so the sum cannot carry out of it.
template <int K, bool CARRY>
static __device__ __forceinline__ void fw_mad(uint32_t* r, const uint32_t (&a)[K], uint32_t b);

template <>
__device__ __forceinline__ void fw_mad<4, true>(uint32_t* r, const uint32_t (&a)[4], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "=r"(r[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b));
}

template <>
__device__ __forceinline__ void fw_mad<4, false>(uint32_t* r, const uint32_t (&a)[4], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b));
}

template <>
__device__ __forceinline__ void fw_mad<3, true>(uint32_t* r, const uint32_t (&a)[3], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %7, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %7, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %10, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %10, %5;\n\t"
      "addc.u32 %6, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "=r"(r[6])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(b));
}

template <>
__device__ __forceinline__ void fw_mad<3, false>(uint32_t* r, const uint32_t (&a)[3], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %6, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, %6, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
      "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
      "madc.lo.cc.u32 %4, %8, %9, %4;\n\t"
      "madc.hi.u32 %5, %8, %9, %5;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(b));
}

template <>
__device__ __forceinline__ void fw_mad<2, true>(uint32_t* r, const uint32_t (&a)[2], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
      "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
      "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
      "addc.u32 %4, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "=r"(r[4])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

template <>
__device__ __forceinline__ void fw_mad<2, false>(uint32_t* r, const uint32_t (&a)[2], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %4, %6, %0;\n\t"
      "madc.hi.cc.u32 %1, %4, %6, %1;\n\t"
      "madc.lo.cc.u32 %2, %5, %6, %2;\n\t"
      "madc.hi.u32 %3, %5, %6, %3;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

template <>
__device__ __forceinline__ void fw_mad<1, true>(uint32_t* r, const uint32_t (&a)[1], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "=r"(r[2])
      : "r"(a[0]), "r"(b));
}

template <>
__device__ __forceinline__ void fw_mad<1, false>(uint32_t* r, const uint32_t (&a)[1], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\t"
      "madc.hi.u32 %1, %2, %3, %1;"
      : "+r"(r[0]), "+r"(r[1])
      : "r"(a[0]), "r"(b));
}

// e[1..16) += o[0..15): the odd accumulator (o[k] is word k + 1) into the
// even one, one carry chain; the sum is < 2^512, so nothing carries out.
static __device__ __forceinline__ void fw_merge(uint32_t (&e)[16], const uint32_t (&o)[15]) {
  uint32_t c;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]),
        "+r"(e[8]), "=r"(c)
      : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]),
        "r"(o[7]));
  // the carry back into CC: c + 0xFFFFFFFF carries out exactly when c == 1
  asm("add.cc.u32 %7, %7, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.u32 %6, %6, %14;"
      : "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]), "+r"(e[14]),
        "+r"(e[15]), "+r"(c)
      : "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]), "r"(o[12]), "r"(o[13]), "r"(o[14]));
}

// t (16 words, < 2^512) mod p into [0, 2^256):
//   r = lo + hi * 977 + hi * 2^32  (< 2^289: words r[0..9), r[9] < 2)
//   r = r[0..8) + top * (2^32 + 977), top = r[8] + r[9] 2^32 < 2^33
//   and where that wraps 2^256 (the rest < 2^66), 2^32 + 977 once more.
static __device__ __forceinline__ Fe fw_reduce(const uint32_t (&t)[16]) {
  uint32_t r0, r1, r2, r3, r4, r5, r6, r7, r8, r9;
  asm("{\n\t"
      // lo + the even limbs of hi times 977 (each product on two words)
      "mad.lo.cc.u32 %0, %18, 977, %10;\n\t"
      "madc.hi.cc.u32 %1, %18, 977, %11;\n\t"
      "madc.lo.cc.u32 %2, %20, 977, %12;\n\t"
      "madc.hi.cc.u32 %3, %20, 977, %13;\n\t"
      "madc.lo.cc.u32 %4, %22, 977, %14;\n\t"
      "madc.hi.cc.u32 %5, %22, 977, %15;\n\t"
      "madc.lo.cc.u32 %6, %24, 977, %16;\n\t"
      "madc.hi.cc.u32 %7, %24, 977, %17;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      // the odd limbs, one word up
      "mad.lo.cc.u32 %1, %19, 977, %1;\n\t"
      "madc.hi.cc.u32 %2, %19, 977, %2;\n\t"
      "madc.lo.cc.u32 %3, %21, 977, %3;\n\t"
      "madc.hi.cc.u32 %4, %21, 977, %4;\n\t"
      "madc.lo.cc.u32 %5, %23, 977, %5;\n\t"
      "madc.hi.cc.u32 %6, %23, 977, %6;\n\t"
      "madc.lo.cc.u32 %7, %25, 977, %7;\n\t"
      "madc.hi.u32 %8, %25, 977, %8;\n\t"
      // hi * 2^32
      "add.cc.u32 %1, %1, %18;\n\t"
      "addc.cc.u32 %2, %2, %19;\n\t"
      "addc.cc.u32 %3, %3, %20;\n\t"
      "addc.cc.u32 %4, %4, %21;\n\t"
      "addc.cc.u32 %5, %5, %22;\n\t"
      "addc.cc.u32 %6, %6, %23;\n\t"
      "addc.cc.u32 %7, %7, %24;\n\t"
      "addc.cc.u32 %8, %8, %25;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3), "=r"(r4), "=r"(r5), "=r"(r6), "=r"(r7),
        "=r"(r8), "=r"(r9)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
        "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]),
        "r"(t[14]), "r"(t[15]));
  // top * (2^32 + 977) = r8 977 + (r8 + 977 r9) 2^32 + r9 2^64; where r9 = 1,
  // r8 < 2^11, so r8 + 977 r9 < 2^32
  const uint32_t s1 = r8 + 977u * r9;
  uint32_t w;
  asm("{\n\t"
      "add.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.lo.cc.u32 %0, %11, 977, %0;\n\t"
      "madc.hi.cc.u32 %1, %11, 977, %1;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      // wrapped (w = 1): the rest is < 2^66, and + 2^32 + 977 stays in 3 words
      "mad.lo.cc.u32 %0, %8, 977, %0;\n\t"
      "addc.cc.u32 %1, %1, %8;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "}"
      : "+r"(r0), "+r"(r1), "+r"(r2), "+r"(r3), "+r"(r4), "+r"(r5), "+r"(r6), "+r"(r7),
        "=r"(w)
      : "r"(s1), "r"(r9), "r"(r8));
  Fe r;
  r.v[0] = r0; r.v[1] = r1; r.v[2] = r2; r.v[3] = r3;
  r.v[4] = r4; r.v[5] = r5; r.v[6] = r6; r.v[7] = r7;
  return r;
}

// a * b mod p in [0, 2^256). Row i multiplies b_i by a's even limbs
// (a0 a2 a4 a6) and odd limbs (a1 a3 a5 a7): a product a_j b_i sits on
// words i + j, i + j + 1, so within a row each parity's four products tile
// eight consecutive words of one accumulator, e (word k) for i + j even, o
// (word k + 1) for odd. One chain of a row runs over words already written
// and carries into the next, unwritten one; the other ends on an unwritten
// word and cannot carry out.
static __device__ __forceinline__ Fe fw_mul(const Fe& a, const Fe& b) {
  const uint32_t ev[4] = {a.v[0], a.v[2], a.v[4], a.v[6]};
  const uint32_t od[4] = {a.v[1], a.v[3], a.v[5], a.v[7]};
  uint32_t e[16], o[15];
#pragma unroll
  for (int k = 8; k < 16; k++) e[k] = 0;
#pragma unroll
  for (int k = 8; k < 15; k++) o[k] = 0;
  fw_mul4(e, ev[0], ev[1], ev[2], ev[3], b.v[0]);
  fw_mul4(o, od[0], od[1], od[2], od[3], b.v[0]);
#pragma unroll
  for (int i = 1; i < 8; i++) {
    if (i & 1) {
      fw_mad<4, true>(o + i - 1, ev, b.v[i]);
      fw_mad<4, false>(e + i + 1, od, b.v[i]);
    } else {
      fw_mad<4, true>(e + i, ev, b.v[i]);
      fw_mad<4, false>(o + i, od, b.v[i]);
    }
  }
  fw_merge(e, o);
  return fw_reduce(e);
}

// a^2 mod p in [0, 2^256): the 28 cross products a_i a_j (i < j) in the
// same two accumulators, row i over j > i, then doubled, then the squares
// a_i^2 on words 2i, 2i + 1.
static __device__ __forceinline__ Fe fw_sqr(const Fe& a) {
  const uint32_t* v = a.v;
  uint32_t e[16], o[15];
#pragma unroll
  for (int k = 0; k < 16; k++) e[k] = 0;
#pragma unroll
  for (int k = 8; k < 15; k++) o[k] = 0;
  fw_mul4(o, v[1], v[3], v[5], v[7], v[0]);  // words 1..8
  fw_mul3(e + 2, v[2], v[4], v[6], v[0]);    // words 2..7
  {
    const uint32_t x[3] = {v[2], v[4], v[6]}, y[3] = {v[3], v[5], v[7]};
    fw_mad<3, true>(o + 2, x, v[1]);   // words 3..8, carry into word 9
    fw_mad<3, false>(e + 4, y, v[1]);  // words 4..9
  }
  {
    const uint32_t x[3] = {v[3], v[5], v[7]}, y[2] = {v[4], v[6]};
    fw_mad<3, false>(o + 4, x, v[2]);  // words 5..10
    fw_mad<2, true>(e + 6, y, v[2]);   // words 6..9, carry into word 10
  }
  {
    const uint32_t x[2] = {v[4], v[6]}, y[2] = {v[5], v[7]};
    fw_mad<2, true>(o + 6, x, v[3]);   // words 7..10, carry into word 11
    fw_mad<2, false>(e + 8, y, v[3]);  // words 8..11
  }
  {
    const uint32_t x[2] = {v[5], v[7]}, y[1] = {v[6]};
    fw_mad<2, false>(o + 8, x, v[4]);  // words 9..12
    fw_mad<1, true>(e + 10, y, v[4]);  // words 10..11, carry into word 12
  }
  {
    const uint32_t x[1] = {v[6]}, y[1] = {v[7]};
    fw_mad<1, true>(o + 10, x, v[5]);   // words 11..12, carry into word 13
    fw_mad<1, false>(e + 12, y, v[5]);  // words 12..13
  }
  {
    const uint32_t x[1] = {v[7]};
    fw_mad<1, false>(o + 12, x, v[6]);  // words 13..14
  }
  fw_merge(e, o);  // the cross sum, < 2^511
  asm("{\n\t"
      "add.cc.u32 %0, %0, %0;\n\t"
      "addc.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.u32 %14, %14, %14;\n\t"
      "mad.lo.cc.u32 %15, %16, %16, 0;\n\t"
      "madc.hi.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.lo.cc.u32 %1, %17, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %18, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %19, %19, %5;\n\t"
      "madc.hi.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.lo.cc.u32 %7, %20, %20, %7;\n\t"
      "madc.hi.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.lo.cc.u32 %9, %21, %21, %9;\n\t"
      "madc.hi.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.lo.cc.u32 %11, %22, %22, %11;\n\t"
      "madc.hi.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.lo.cc.u32 %13, %23, %23, %13;\n\t"
      "madc.hi.u32 %14, %23, %23, %14;\n\t"
      "}"
      : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]),
        "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]),
        "+r"(e[14]), "+r"(e[15]), "=r"(e[0])
      : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]), "r"(v[5]), "r"(v[6]),
        "r"(v[7]));
  return fw_reduce(e);
}

// a - b mod p for a < 2^256 and a canonical b, in [0, 2^256): where a < b
// the wrapped difference gets p added back (mod 2^256), branch-free.
static __device__ __forceinline__ Fe fw_sub(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t m;
  asm("{\n\t"
      "sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;\n\t"
      "}"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]),
        "=r"(r.v[6]), "=r"(r.v[7]), "=r"(m)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  // m = all ones where it borrowed: subtract 2^32 + 977 (adds p mod 2^256)
  asm("{\n\t"
      "sub.cc.u32 %0, %0, %8;\n\t"
      "subc.cc.u32 %1, %1, %9;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.u32 %7, %7, 0;\n\t"
      "}"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7])
      : "r"(m & 977u), "r"(m & 1u));
  return r;
}

// The low 64 bits of a mod p (canonical) for a < 2^256: a - p where a >= p.
static __device__ __forceinline__ void fw_canon_lo(const Fe& a, uint32_t& lo, uint32_t& hi) {
  Fe d;
  const uint32_t ge = fe_add_negp(d, a);
  lo = ge ? d.v[0] : a.v[0];
  hi = ge ? d.v[1] : a.v[1];
}

}  // namespace kh
