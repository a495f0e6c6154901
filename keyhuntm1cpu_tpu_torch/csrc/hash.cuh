// SHA-256, RIPEMD-160 and Keccak-f[1600] for one thread: the device twin of
// keyhuntm1cpu_tpu_torch/hash/phash.py and of the tile functions of
// keyhuntm1cpu_tpu/hash/phash.py.
//
// The round loops are unrolled at compile time by folds over integer
// sequences, so every message word, state word, round constant, rotation
// amount and word index is a compile-time constant: the state stays in
// registers and no table is read from memory. Rotates are funnel shifts;
// Keccak runs on native 64-bit lanes, and its compare words equal the JAX
// package's (hi, lo) 32-bit formulation bit for bit.
//
// The three word functions at the bottom are what the brute walk kernel
// (pbrute.cu) calls per point; the standalone hash kernels of phash.py
// (_hash160x2_kernel, _keccak_pubkey_kernel, _hash160_u_kernel) port as
// thin loops over them. Limbs are little-endian u32 (limb 7 most significant),
// as in fe.cuh. Each returns (lo, hi) = digest bytes 0..3 and 4..7 as
// little-endian words (Keccak: address bytes 0..7, digest bytes 12..19).
#pragma once

#include <cstdint>
#include <utility>

namespace kh {

static __device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

static __device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

static __device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

template <int N>
static __device__ __forceinline__ uint64_t rotl64(uint64_t x) {
  if constexpr (N == 0) {
    return x;
  } else {
    return (x << N) | (x >> (64 - N));
  }
}

// ---------------------------------------------------------------------------
// SHA-256
// ---------------------------------------------------------------------------

struct Sha256Tab {
  static constexpr uint32_t k[64] = {
      0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
      0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
      0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
      0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
      0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
      0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
      0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
      0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
      0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
      0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
      0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};
};

// Round I on the rotating state s[0..7] = (a..h), schedule in a 16-word ring.
template <int I>
static __device__ __forceinline__ void sha256_round(uint32_t (&s)[8], uint32_t (&w)[16]) {
  uint32_t wi;
  if constexpr (I < 16) {
    wi = w[I];
  } else {
    const uint32_t w15 = w[(I - 15) & 15], w2 = w[(I - 2) & 15];
    const uint32_t sig0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
    const uint32_t sig1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
    wi = w[I & 15] + sig0 + w[(I - 7) & 15] + sig1;
    w[I & 15] = wi;
  }
  constexpr int a = (64 - I) & 7, b = (65 - I) & 7, c = (66 - I) & 7, d = (67 - I) & 7;
  constexpr int e = (68 - I) & 7, f = (69 - I) & 7, g = (70 - I) & 7, h = (71 - I) & 7;
  const uint32_t s1 = rotr32(s[e], 6) ^ rotr32(s[e], 11) ^ rotr32(s[e], 25);
  const uint32_t ch = (s[e] & s[f]) ^ (~s[e] & s[g]);
  constexpr uint32_t k = Sha256Tab::k[I];
  const uint32_t t1 = s[h] + s1 + ch + k + wi;
  const uint32_t s0 = rotr32(s[a], 2) ^ rotr32(s[a], 13) ^ rotr32(s[a], 22);
  const uint32_t maj = (s[a] & s[b]) ^ (s[a] & s[c]) ^ (s[b] & s[c]);
  s[d] += t1;        // becomes e of the next round
  s[h] = t1 + s0 + maj;  // becomes a of the next round
}

template <int... I>
static __device__ __forceinline__ void sha256_rounds(uint32_t (&s)[8], uint32_t (&w)[16],
                                                     std::integer_sequence<int, I...>) {
  (sha256_round<I>(s, w), ...);
}

// One compression continuing from st (64 rounds leave the roles where
// they started: after round I the word for `a` sits at index (-I-1) & 7).
static __device__ __forceinline__ void sha256_compress(uint32_t (&st)[8], uint32_t (&w)[16]) {
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = st[i];
  sha256_rounds(s, w, std::make_integer_sequence<int, 64>{});
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] += s[i];
}

static __device__ __forceinline__ void sha256_init(uint32_t (&st)[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// ---------------------------------------------------------------------------
// RIPEMD-160 of a 32-byte message
// ---------------------------------------------------------------------------

struct RmdTab {
  static constexpr int r1[80] = {
      0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
      7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
      3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
      1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
      4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
  static constexpr int r2[80] = {
      5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
      6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
      15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
      8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
      12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
  static constexpr int s1[80] = {
      11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
      7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
      11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
      11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
      9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
  static constexpr int s2[80] = {
      8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
      9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
      9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
      15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
      8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
  static constexpr uint32_t k1[5] = {0x00000000u, 0x5A827999u, 0x6ED9EBA1u, 0x8F1BBCDCu,
                                     0xA953FD4Eu};
  static constexpr uint32_t k2[5] = {0x50A28BE6u, 0x5C4DD124u, 0x6D703EF3u, 0x7A6D76E9u,
                                     0x00000000u};
};

template <int F>
static __device__ __forceinline__ uint32_t rmd_f(uint32_t x, uint32_t y, uint32_t z) {
  if constexpr (F == 0) return x ^ y ^ z;
  else if constexpr (F == 1) return (x & y) | (~x & z);
  else if constexpr (F == 2) return (x | ~y) ^ z;
  else if constexpr (F == 3) return (x & z) | (y & ~z);
  else return x ^ (y | ~z);
}

// Step J of both lines on rotating states l[5], r[5] = (a, b, c, d, e).
template <int J>
static __device__ __forceinline__ void rmd_step(uint32_t (&l)[5], uint32_t (&r)[5],
                                                const uint32_t (&x)[16]) {
  constexpr int g = J / 16;
  constexpr int x1 = RmdTab::r1[J], x2 = RmdTab::r2[J], s1 = RmdTab::s1[J], s2 = RmdTab::s2[J];
  constexpr uint32_t k1 = RmdTab::k1[g], k2 = RmdTab::k2[g];
  // at step J the word for `a` sits at index (-J) mod 5
  constexpr int a = (80 - J) % 5, b = (81 - J) % 5, c = (82 - J) % 5, d = (83 - J) % 5,
                e = (84 - J) % 5;
  uint32_t t = rotl32(l[a] + rmd_f<g>(l[b], l[c], l[d]) + x[x1] + k1, s1) + l[e];
  l[c] = rotl32(l[c], 10);
  l[a] = t;  // a <- e, e <- d, d <- rol(c), c <- b, b <- t: rotate roles
  t = rotl32(r[a] + rmd_f<4 - g>(r[b], r[c], r[d]) + x[x2] + k2, s2) + r[e];
  r[c] = rotl32(r[c], 10);
  r[a] = t;
}

template <int... J>
static __device__ __forceinline__ void rmd_steps(uint32_t (&l)[5], uint32_t (&r)[5],
                                                 const uint32_t (&x)[16],
                                                 std::integer_sequence<int, J...>) {
  (rmd_step<J>(l, r, x), ...);
}

// RIPEMD-160 of a 32-byte message given as 8 big-endian words; the digest
// as 5 little-endian words.
static __device__ __forceinline__ void ripemd160_32(const uint32_t (&msg_be)[8],
                                                    uint32_t (&out)[5]) {
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 8; i++) x[i] = bswap32(msg_be[i]);
  x[8] = 0x80u;
#pragma unroll
  for (int i = 9; i < 16; i++) x[i] = 0u;
  x[14] = 256u;
  constexpr uint32_t h0 = 0x67452301u, h1 = 0xEFCDAB89u, h2 = 0x98BADCFEu,
                     h3 = 0x10325476u, h4 = 0xC3D2E1F0u;
  uint32_t l[5] = {h0, h1, h2, h3, h4}, r[5] = {h0, h1, h2, h3, h4};
  rmd_steps(l, r, x, std::make_integer_sequence<int, 80>{});
  // 80 steps: roles back at their start indices (a = 0 ... e = 4)
  out[0] = h1 + l[2] + r[3];
  out[1] = h2 + l[3] + r[4];
  out[2] = h3 + l[4] + r[0];
  out[3] = h4 + l[0] + r[1];
  out[4] = h0 + l[1] + r[2];
}

// ---------------------------------------------------------------------------
// Keccak-f[1600], lanes a[x + 5y]
// ---------------------------------------------------------------------------

struct KeccakTab {
  static constexpr uint64_t rc[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  // rotation offset of lane x + 5y, at index x + 5y
  static constexpr int rot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                  25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
};

// rho + pi for lane I = x + 5y: B[y + 5((2x + 3y) % 5)] = rol(A[I], rot[I])
template <int I>
static __device__ __forceinline__ void keccak_rho_pi(const uint64_t (&a)[25], uint64_t (&b)[25]) {
  constexpr int x = I % 5, y = I / 5;
  constexpr int rot = KeccakTab::rot[I];
  b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64<rot>(a[I]);
}

template <int... I>
static __device__ __forceinline__ void keccak_rho_pi_all(const uint64_t (&a)[25],
                                                         uint64_t (&b)[25],
                                                         std::integer_sequence<int, I...>) {
  (keccak_rho_pi<I>(a, b), ...);
}

template <int R>
static __device__ __forceinline__ void keccak_round(uint64_t (&a)[25]) {
  uint64_t c[5], b[25];
#pragma unroll
  for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
  for (int x = 0; x < 5; x++) {
    const uint64_t d = c[(x + 4) % 5] ^ rotl64<1>(c[(x + 1) % 5]);
#pragma unroll
    for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
  }
  keccak_rho_pi_all(a, b, std::make_integer_sequence<int, 25>{});
#pragma unroll
  for (int y = 0; y < 5; y++) {
#pragma unroll
    for (int x = 0; x < 5; x++)
      a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
  }
  constexpr uint64_t rc = KeccakTab::rc[R];
  a[0] ^= rc;
}

template <int... R>
static __device__ __forceinline__ void keccak_rounds(uint64_t (&a)[25],
                                                     std::integer_sequence<int, R...>) {
  (keccak_round<R>(a), ...);
}

static __device__ __forceinline__ void keccak_f1600(uint64_t (&a)[25]) {
  keccak_rounds(a, std::make_integer_sequence<int, 24>{});
}

// ---------------------------------------------------------------------------
// Per-point compare words (phash.py hash160_parity_words, hash160_u_words,
// keccak_eth_words)
// ---------------------------------------------------------------------------

// hash160(prefix || X): the 33-byte message spliced from the LE limbs.
static __device__ __noinline__ uint2 hash160_parity_words(const uint32_t (&x)[8],
                                                          uint32_t prefix) {
  uint32_t w[16];
  w[0] = (prefix << 24) | (x[7] >> 8);
#pragma unroll
  for (int k = 1; k < 8; k++) w[k] = ((x[8 - k] & 0xFFu) << 24) | (x[7 - k] >> 8);
  w[8] = ((x[0] & 0xFFu) << 24) | (0x80u << 16);
#pragma unroll
  for (int k = 9; k < 15; k++) w[k] = 0u;
  w[15] = 33u * 8u;
  uint32_t st[8], d[5];
  sha256_init(st);
  sha256_compress(st, w);
  ripemd160_32(st, d);
  return make_uint2(d[0], d[1]);
}

// hash160(04 || X || Y): 65 bytes, two chained SHA-256 blocks.
static __device__ __noinline__ uint2 hash160_u_words(const uint32_t (&x)[8],
                                                     const uint32_t (&y)[8]) {
  uint32_t w[16];
  w[0] = (4u << 24) | (x[7] >> 8);
#pragma unroll
  for (int k = 1; k < 8; k++) w[k] = ((x[8 - k] & 0xFFu) << 24) | (x[7 - k] >> 8);
  w[8] = ((x[0] & 0xFFu) << 24) | (y[7] >> 8);
#pragma unroll
  for (int k = 1; k < 7; k++) w[8 + k] = ((y[8 - k] & 0xFFu) << 24) | (y[7 - k] >> 8);
  w[15] = ((y[1] & 0xFFu) << 24) | (y[0] >> 8);
  uint32_t st[8], d[5];
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = ((y[0] & 0xFFu) << 24) | (0x80u << 16);
#pragma unroll
  for (int k = 1; k < 15; k++) w[k] = 0u;
  w[15] = 65u * 8u;
  sha256_compress(st, w);
  ripemd160_32(st, d);
  return make_uint2(d[0], d[1]);
}

// keccak256(X_be || Y_be): lane k of the message is the LE u64 of bytes
// 8k..8k+7, i.e. (bswap(limb 6-2k) << 32) | bswap(limb 7-2k).
static __device__ __noinline__ uint2 keccak_eth_words(const uint32_t (&x)[8],
                                                      const uint32_t (&y)[8]) {
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0ull;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    a[k] = ((uint64_t)bswap32(x[6 - 2 * k]) << 32) | bswap32(x[7 - 2 * k]);
    a[4 + k] = ((uint64_t)bswap32(y[6 - 2 * k]) << 32) | bswap32(y[7 - 2 * k]);
  }
  a[8] = 1ull;                     // 0x01 padding after 64 bytes
  a[16] = 0x8000000000000000ull;   // final bit of the 136-byte block
  keccak_f1600(a);
  // digest bytes 12..15 = high half of lane 1; bytes 16..19 = low half of lane 2
  return make_uint2((uint32_t)(a[1] >> 32), (uint32_t)a[2]);
}

}  // namespace kh
