"""secp256k1 field arithmetic: numpy limb helpers and the plain torch ops.

Representation (the limb-major layout of keyhuntm1cpu_tpu/field/fe_tiles.py):
a batch of field elements is a tensor shaped ``(8,) + tile``; ``a[i]`` is
limb i (little-endian, 32 bits) of every element. The plain ops here work
on int64 tensors whose values are u32 limbs in [0, 2^32): torch on the CPU
has no u32 shifts, adds or compares, so limbs ride in int64 and are masked
with ``& 0xFFFFFFFF``. Products are taken on 16-bit halves (as fe_tiles
does), so no int64 product can overflow.

Device tensors hold the same u32 bits in int32 (``i32``/``u32`` convert);
csrc/fe.cuh is the CUDA twin of these ops, with native 32x32->64 products.
Every op returns canonical values (< p) for canonical inputs, which is what
makes the CUDA kernels, these plain versions and the JAX package agree bit
for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

LIMBS = 8
P_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
M16 = 0xFFFF
M32 = 0xFFFFFFFF
FOLD = 0x3D1  # 2^256 = 2^32 + 0x3D1 (mod p)
_P_LIMBS = [(P_INT >> (32 * i)) & M32 for i in range(LIMBS)]
_NEG_P = [FOLD, 1, 0, 0, 0, 0, 0, 0]  # 2^256 - p, as limbs


# ---------------------------------------------------------------------------
# Host helpers (numpy)
# ---------------------------------------------------------------------------


def int_to_limbs(v: int) -> np.ndarray:
    """Python int -> (8,) uint32 little-endian limbs."""
    return np.array([(v >> (32 * i)) & M32 for i in range(LIMBS)], dtype=np.uint32)


def limbs_to_int(a) -> int:
    """(8,) limbs -> python int."""
    a = np.asarray(a).astype(np.uint64)
    return sum(int(a[i]) << (32 * i) for i in range(LIMBS))


def to_tiles(a_bm: np.ndarray) -> np.ndarray:
    """(B, 8) batch-major -> (8, B) limb-major."""
    return np.ascontiguousarray(np.asarray(a_bm).T)


def from_tiles(a_lm: np.ndarray) -> np.ndarray:
    """(8, ...) limb-major -> (N, 8) batch-major."""
    a_lm = np.asarray(a_lm)
    return np.ascontiguousarray(a_lm.reshape(LIMBS, -1).T)


def u32(t: torch.Tensor) -> torch.Tensor:
    """u32 bits in any integer tensor -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & M32


def i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as int32."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain torch field ops on int64 limb tensors (8,) + tile
# ---------------------------------------------------------------------------


def _propagate(limbs: List[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Carry-normalise non-negative int64 limbs to u32; returns the carry out."""
    out = []
    c = torch.zeros_like(limbs[0])
    for v in limbs:
        v = v + c
        out.append(v & M32)
        c = v >> 32
    return out, c


def _add_const(r: List[torch.Tensor], k: List[int]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    return _propagate([r[i] + k[i] for i in range(LIMBS)])


def _canonical(r: List[torch.Tensor], carry: torch.Tensor) -> torch.Tensor:
    """r + carry*2^256 (carry in {0, 1}, value < 2p) -> canonical stack.
    r >= p exactly when r + (2^256 - p) carries out of 256 bits."""
    d, cc = _add_const(r, _NEG_P)
    take = (carry | cc) == 1
    return torch.stack([torch.where(take, d[i], r[i]) for i in range(LIMBS)])


def _halves(a: torch.Tensor) -> torch.Tensor:
    """(8,)+t -> (16,)+t 16-bit half-limbs, low half first."""
    return torch.stack([a & M16, a >> 16], dim=1).reshape((16,) + a.shape[1:])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p."""
    ah, bh = _halves(a), _halves(b)
    cols = a.new_zeros((32,) + a.shape[1:])
    for i in range(16):
        cols[i : i + 16] += ah[i] * bh  # products < 2^32, columns < 2^36
    return _reduce(cols)


def sqr(a: torch.Tensor) -> torch.Tensor:
    """(a * a) mod p."""
    return mul(a, a)


def _reduce(cols: torch.Tensor) -> torch.Tensor:
    """32 uncarried 16-bit columns (< 2^37) -> canonical (8,)+tile.

    Column i >= 16 weighs 2^(256 + 16(i-16)) = 2^(16(i-16)) * (2^32 + 0x3D1),
    so it folds into columns i-16 (times 0x3D1) and i-14. Two folds leave 16
    columns < 2^59; one carry pass, a fold of the < 2^44 carry, a second
    pass, a last fold of a {0,1} carry and one conditional subtraction give
    the canonical value."""
    low = cols.new_zeros((18,) + cols.shape[1:])
    low[:16] = cols[:16] + cols[16:] * FOLD
    low[2:18] += cols[16:]
    top = low[16:18].clone()
    low = low[:16]
    low[0:2] += top * FOLD
    low[2:4] += top
    halves = []
    c = torch.zeros_like(low[0])
    for i in range(16):
        v = low[i] + c
        halves.append(v & M16)
        c = v >> 16
    r = [halves[2 * i] | (halves[2 * i + 1] << 16) for i in range(LIMBS)]
    r[0] = r[0] + c * FOLD
    r[1] = r[1] + c
    r, c = _propagate(r)
    # c == 1 only when the value wrapped: r is then tiny and absorbs 2^32+0x3D1
    r[0] = r[0] + c * FOLD
    r[1] = r[1] + c
    r, _ = _propagate(r)
    return _canonical(r, torch.zeros_like(c))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical inputs."""
    s, carry = _propagate([a[i] + b[i] for i in range(LIMBS)])
    return _canonical(s, carry)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical inputs."""
    out = []
    borrow = torch.zeros_like(a[0])
    for i in range(LIMBS):
        v = a[i] - b[i] - borrow
        borrow = (v < 0).to(torch.int64)
        out.append(v & M32)
    # on borrow the value wrapped by 2^256: adding p back (mod 2^256) fixes it
    fixed, _ = _propagate([out[i] + _P_LIMBS[i] for i in range(LIMBS)])
    take = borrow == 1
    return torch.stack([torch.where(take, fixed[i], out[i]) for i in range(LIMBS)])


def dbl(a: torch.Tensor) -> torch.Tensor:
    return add(a, a)


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p; maps 0 -> 0."""
    return sub(torch.zeros_like(a), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b): mask shaped like the tile, operands (8,)+tile."""
    return torch.where(mask, a, b)


def one_like(a: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(a)
    out[0] = 1
    return out


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) by the secp256k1 addition chain (255 squarings, 15
    multiplies — the chain of fe_tiles.inv); maps 0 -> 0."""

    def sqr_n(x, n):
        for _ in range(n):
            x = sqr(x)
        return x

    x1 = a
    x2 = mul(sqr_n(x1, 1), x1)
    x3 = mul(sqr_n(x2, 1), x1)
    x6 = mul(sqr_n(x3, 3), x3)
    x9 = mul(sqr_n(x6, 3), x3)
    x11 = mul(sqr_n(x9, 2), x2)
    x22 = mul(sqr_n(x11, 11), x11)
    x44 = mul(sqr_n(x22, 22), x22)
    x88 = mul(sqr_n(x44, 44), x44)
    x176 = mul(sqr_n(x88, 88), x88)
    x220 = mul(sqr_n(x176, 44), x44)
    x223 = mul(sqr_n(x220, 3), x3)
    t = mul(sqr_n(x223, 23), x22)
    t = mul(sqr_n(t, 5), x1)
    t = mul(sqr_n(t, 3), x2)
    return mul(sqr_n(t, 2), x1)


def batch_inv_mod_p(a: torch.Tensor, chain_len: int = 32) -> torch.Tensor:
    """Inverses of the (8, B) elements of a by the chunked Montgomery trick
    of fe.batch_inv_mod_p: B is padded with ones to a multiple of
    L = chain_len, element i sits in chain i % C at position i // C
    (C = B / L after padding), the L positions are multiplied forward, the
    C chain totals inverted at once (pinv.inv_batch's plain version) and
    the inverses peeled backward. A zero spoils its whole chain, so callers
    mask zeros to 1 first. On the card the walker walk runs the prefix and
    the peel in csrc/walk.cu around pinv.inv_batch."""
    chains, prefixes = chain_prefix(a, chain_len)
    return chain_peel(chains, prefixes, inv(prefixes[:, -1]))[:, : a.shape[1]]


def chain_prefix(a: torch.Tensor, chain_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(8, B) -> (chains, prefixes), both (8, L, C): the elements padded
    with ones, element i = l*C + c at [:, l, c], and their running products
    along l (prefixes[:, -1] are the chain totals)."""
    pad = (-a.shape[1]) % chain_len
    if pad:
        ones = a.new_zeros((LIMBS, pad))
        ones[0] = 1
        a = torch.cat([a, ones], dim=1)
    chains = a.reshape(LIMBS, chain_len, -1)
    prefixes = [chains[:, 0]]
    for l in range(1, chain_len):
        prefixes.append(mul(prefixes[-1], chains[:, l]))
    return chains, torch.stack(prefixes, dim=1)


def chain_peel(chains: torch.Tensor, prefixes: torch.Tensor,
               inv_totals: torch.Tensor) -> torch.Tensor:
    """Backward peel of chain_prefix: (8, L*C) inverses of the chain
    elements from the (8, C) inverses of the chain totals."""
    running = inv_totals
    invs: List[torch.Tensor] = [running] * chains.shape[1]
    for l in range(chains.shape[1] - 1, 0, -1):
        invs[l] = mul(running, prefixes[:, l - 1])
        running = mul(running, chains[:, l])
    invs[0] = running
    return torch.stack(invs, dim=1).reshape(LIMBS, -1)


def montgomery_inv_groups(dens: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Batched inverse of (8, G*S, ...) denominators by chained groups
    along dim 1: prefix products over groups, ONE inversion, backward
    peel. Zero denominators must be masked to 1 by the caller."""
    s = dens.shape[1] // n_groups
    groups = [dens[:, g * s : (g + 1) * s] for g in range(n_groups)]
    prefixes = [groups[0]]
    for g in range(1, n_groups):
        prefixes.append(mul(prefixes[-1], groups[g]))
    running = inv(prefixes[-1])
    invs: List[torch.Tensor] = [running] * n_groups
    for g in range(n_groups - 1, 0, -1):
        invs[g] = mul(running, prefixes[g - 1])
        running = mul(running, groups[g])
    invs[0] = running
    return torch.cat(invs, dim=1)
