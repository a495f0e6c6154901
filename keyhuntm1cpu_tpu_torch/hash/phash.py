"""SHA-256, RIPEMD-160 and Keccak-f[1600] as plain torch tile functions,
and the standalone hash kernels K7, K8 and the Keccak ETH kernel.

Port of the pure tile functions of keyhuntm1cpu_tpu/hash/phash.py: the
hash160 of a compressed public key from its x limbs, the hash160 of the
uncompressed key (two chained SHA-256 blocks) and the Keccak-256 ETH
compare words. They are the plain versions of the device hashes in
csrc/hash.cuh, and run inside curve/pbrute.brute_walk_blocks_ref.

``hash160_x2_from_batch`` (K7), ``hash160_u_from_batch`` (K8) and
``keccak_eth_from_batch`` hash a batch of points, limb-major (8, n) int32:
their plain versions for CPU tensors, the kernels of csrc/phash.cu for
CUDA tensors (launches counted in ``<wrapper>.launches``).

Words are int64 tensors holding u32 values in [0, 2^32) (torch on the CPU
has no u32 shifts), masked with ``& 0xFFFFFFFF`` after every add and left
shift. Every function takes lists of word tensors of one shape and returns
word tensors of that shape; x and y limbs are little-endian (limb 7 most
significant), as in field/fe.py. Keccak lanes are (hi, lo) word pairs, the
JAX package's formulation; the CUDA twin uses native 64-bit lanes.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .. import _build
from ..field import fe
from .consts import _H0, _IV, _K, _K1, _K2, _R1, _R2, _RC, _ROT, _S1, _S2

M32 = 0xFFFFFFFF
Words = List[torch.Tensor]


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _rol(x, n: int):
    return ((x << n) | (x >> (32 - n))) & M32


def _not(x):
    return x ^ M32


def _bswap(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | (x >> 24))


def _sha256_compress_chain(state: Words, w: Words) -> Words:
    """One SHA-256 compression continuing from `state` (8 words)."""
    a, b, c, d, e, f, g, h = state
    wbuf = list(w)
    for i in range(64):
        if i < 16:
            wi = wbuf[i]
        else:
            w15, w2 = wbuf[i - 15], wbuf[i - 2]
            sig0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            sig1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            wi = (wbuf[i - 16] + sig0 + wbuf[i - 7] + sig1) & M32
            wbuf.append(wi)
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (_not(e) & g)
        t1 = (h + s1 + ch + _K[i] + wi) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
    return [(x + y) & M32 for x, y in zip([a, b, c, d, e, f, g, h], state)]


def _sha256_compress_unrolled(w: Words) -> Words:
    """One SHA-256 compression from the initial hash value; w: 16 words."""
    return _sha256_compress_chain([torch.full_like(w[0], v) for v in _H0], w)


def _ripemd160_32_unrolled(sha_be: Words) -> Words:
    """RIPEMD-160 of a 32-byte SHA-256 digest given as 8 big-endian words;
    returns the 5 little-endian digest words."""
    zero = torch.zeros_like(sha_be[0])
    x = [_bswap(wd) for wd in sha_be]
    x.append(zero + 0x80)
    x += [zero] * 5
    x.append(zero + 256)
    x.append(zero)
    fns = [
        lambda p, q, r: p ^ q ^ r,
        lambda p, q, r: (p & q) | (_not(p) & r),
        lambda p, q, r: (p | _not(q)) ^ r,
        lambda p, q, r: (p & r) | (q & _not(r)),
        lambda p, q, r: p ^ (q | _not(r)),
    ]
    a1, b1, c1, d1, e1 = [zero + v for v in _IV]
    a2, b2, c2, d2, e2 = [zero + v for v in _IV]
    for j in range(80):
        g = j // 16
        t = (_rol((a1 + fns[g](b1, c1, d1) + x[_R1[j]] + _K1[g]) & M32, _S1[j]) + e1) & M32
        a1, e1, d1, c1, b1 = e1, d1, _rol(c1, 10), b1, t
        t = (_rol((a2 + fns[4 - g](b2, c2, d2) + x[_R2[j]] + _K2[g]) & M32, _S2[j]) + e2) & M32
        a2, e2, d2, c2, b2 = e2, d2, _rol(c2, 10), b2, t
    h0, h1, h2, h3, h4 = _IV
    return [(h1 + c1 + d2) & M32, (h2 + d1 + e2) & M32, (h3 + e1 + a2) & M32,
            (h4 + a1 + b2) & M32, (h0 + b1 + c2) & M32]


def _sha_words_from_x(xl: Words, prefix: int) -> Words:
    """16 big-endian schedule words of the 33-byte message prefix || X_be."""
    zero = torch.zeros_like(xl[0])
    w = [(zero + (prefix << 24)) | (xl[7] >> 8)]
    for k in range(1, 8):
        w.append(((xl[8 - k] & 0xFF) << 24) | (xl[7 - k] >> 8))
    w.append(((xl[0] & 0xFF) << 24) | (0x80 << 16))
    w += [zero] * 6
    w.append(zero + 33 * 8)
    return w


def hash160_parity_words(xl: Words, prefix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi): words 0 and 1 of hash160(prefix || X), i.e. digest bytes
    0..3 and 4..7 as little-endian words (the target packing)."""
    digest = _ripemd160_32_unrolled(
        _sha256_compress_unrolled(_sha_words_from_x(xl, prefix)))
    return digest[0], digest[1]


def hash160_u_words(xl: Words, yl: Words) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of hash160(04 || X_be || Y_be): a 65-byte message, two
    chained SHA-256 blocks."""
    zero = torch.zeros_like(xl[0])
    w = [(zero + (4 << 24)) | (xl[7] >> 8)]
    for k in range(1, 8):
        w.append(((xl[8 - k] & 0xFF) << 24) | (xl[7 - k] >> 8))
    w.append(((xl[0] & 0xFF) << 24) | (yl[7] >> 8))
    for k in range(1, 7):
        w.append(((yl[8 - k] & 0xFF) << 24) | (yl[7 - k] >> 8))
    w.append(((yl[1] & 0xFF) << 24) | (yl[0] >> 8))
    state = _sha256_compress_unrolled(w)
    w2 = [((yl[0] & 0xFF) << 24) | (0x80 << 16)] + [zero] * 14 + [zero + 65 * 8]
    digest = _ripemd160_32_unrolled(_sha256_compress_chain(state, w2))
    return digest[0], digest[1]


def _k_rol64(hi, lo, n: int):
    """Rotate the 64-bit lane (hi, lo) left by n."""
    n %= 64
    if n == 0:
        return hi, lo
    if n == 32:
        return lo, hi
    if n < 32:
        return (((hi << n) | (lo >> (32 - n))) & M32,
                ((lo << n) | (hi >> (32 - n))) & M32)
    m = n - 32
    return (((lo << m) | (hi >> (32 - m))) & M32,
            ((hi << m) | (lo >> (32 - m))) & M32)


def _keccak_round_tiles(state, rc_hi: int, rc_lo: int):
    """One Keccak-f round over a 5x5 list of (hi, lo) lane pairs."""
    c = []
    for x in range(5):
        h = state[x][0][0] ^ state[x][1][0] ^ state[x][2][0] ^ state[x][3][0] ^ state[x][4][0]
        lo = state[x][0][1] ^ state[x][1][1] ^ state[x][2][1] ^ state[x][3][1] ^ state[x][4][1]
        c.append((h, lo))
    d = []
    for x in range(5):
        rh, rl = _k_rol64(c[(x + 1) % 5][0], c[(x + 1) % 5][1], 1)
        d.append((c[(x - 1) % 5][0] ^ rh, c[(x - 1) % 5][1] ^ rl))
    a = [[(state[x][y][0] ^ d[x][0], state[x][y][1] ^ d[x][1]) for y in range(5)]
         for x in range(5)]
    b = [[None] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            b[y][(2 * x + 3 * y) % 5] = _k_rol64(a[x][y][0], a[x][y][1], _ROT[x][y])
    out = [[None] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            nh = b[x][y][0] ^ (_not(b[(x + 1) % 5][y][0]) & b[(x + 2) % 5][y][0])
            nl = b[x][y][1] ^ (_not(b[(x + 1) % 5][y][1]) & b[(x + 2) % 5][y][1])
            out[x][y] = (nh, nl)
    out[0][0] = (out[0][0][0] ^ rc_hi, out[0][0][1] ^ rc_lo)
    return out


def keccak_eth_words(xl: Words, yl: Words) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi): bytes 12..15 and 16..19 of keccak256(X_be || Y_be) as
    little-endian words, the first 8 bytes of the ETH address."""
    zero = torch.zeros_like(xl[0])
    state = [[(zero, zero)] * 5 for _ in range(5)]

    def set_lane(idx, lane):
        state[idx % 5][idx // 5] = lane

    for k in range(4):
        set_lane(k, (_bswap(xl[6 - 2 * k]), _bswap(xl[7 - 2 * k])))
        set_lane(4 + k, (_bswap(yl[6 - 2 * k]), _bswap(yl[7 - 2 * k])))
    set_lane(8, (zero, zero + 1))
    set_lane(16, (zero + 0x80000000, zero))
    for rc in _RC:
        state = _keccak_round_tiles(state, rc >> 32, rc & M32)
    return state[1][0][0], state[2][0][1]


# ---------------------------------------------------------------------------
# K7 / K8: hash160 of a batch of points (phash.hash160_x2_from_batch,
# hash160_u_from_batch), limb-major (8, n) int32 in, (n,) int32 words out
# ---------------------------------------------------------------------------


def _check_points(*pts) -> int:
    n = pts[0].shape[1] if pts[0].dim() == 2 else 0
    for t in pts:
        if (t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != (8, n)
                or n < 1):
            raise ValueError(f"need contiguous int32 (8, n) limbs with n >= 1, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return n


def hash160_x2_ref(x: torch.Tensor):
    """Plain torch version of K7 (see hash160_x2_from_batch)."""
    xl = list(fe.u32(x))
    return tuple(tuple(fe.i32(wd) for wd in hash160_parity_words(xl, prefix))
                 for prefix in (2, 3))


def hash160_x2_from_batch(x: torch.Tensor):
    """x: (8, n) int32 limbs. Returns ((lo_even, hi_even), (lo_odd, hi_odd)),
    (n,) int32 words of hash160(02 || X) and hash160(03 || X): digest bytes
    0..3 and 4..7 as little-endian words."""
    n = _check_points(x)
    if not _build.on_cuda(x):
        return hash160_x2_ref(x)
    out = [torch.empty(n, dtype=torch.int32, device=x.device) for _ in range(4)]
    _build.launch("kh_hash160_x2", x.data_ptr(), *(o.data_ptr() for o in out), n,
                  _build.stream(x))
    hash160_x2_from_batch.launches += 1
    return (out[0], out[1]), (out[2], out[3])


hash160_x2_from_batch.launches = 0


def hash160_u_ref(x: torch.Tensor, y: torch.Tensor):
    """Plain torch version of K8 (see hash160_u_from_batch)."""
    lo, hi = hash160_u_words(list(fe.u32(x)), list(fe.u32(y)))
    return fe.i32(lo), fe.i32(hi)


def hash160_u_from_batch(x: torch.Tensor, y: torch.Tensor):
    """x, y: (8, n) int32 limbs. Returns (lo, hi), (n,) int32 words of
    hash160(04 || X || Y)."""
    n = _check_points(x, y)
    if not _build.on_cuda(x, y):
        return hash160_u_ref(x, y)
    lo, hi = (torch.empty(n, dtype=torch.int32, device=x.device) for _ in range(2))
    _build.launch("kh_hash160_u", x.data_ptr(), y.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                  n, _build.stream(x))
    hash160_u_from_batch.launches += 1
    return lo, hi


hash160_u_from_batch.launches = 0


# ---------------------------------------------------------------------------
# Keccak-256 ETH words of a batch of points (phash.keccak_eth_from_batch)
# ---------------------------------------------------------------------------


def keccak_eth_ref(x: torch.Tensor, y: torch.Tensor):
    """Plain torch version of the kernel (see keccak_eth_from_batch)."""
    lo, hi = keccak_eth_words(list(fe.u32(x)), list(fe.u32(y)))
    return fe.i32(lo), fe.i32(hi)


def keccak_eth_from_batch(x: torch.Tensor, y: torch.Tensor):
    """x, y: (8, n) int32 limbs. Returns (lo, hi), (n,) int32: bytes 12..15
    and 16..19 of keccak256(X || Y) as little-endian words."""
    n = _check_points(x, y)
    if not _build.on_cuda(x, y):
        return keccak_eth_ref(x, y)
    lo, hi = (torch.empty(n, dtype=torch.int32, device=x.device) for _ in range(2))
    _build.launch("kh_keccak_eth", x.data_ptr(), y.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                  n, _build.stream(x))
    keccak_eth_from_batch.launches += 1
    return lo, hi


keccak_eth_from_batch.launches = 0
