"""Fused brute-force chunk: walk + hash + membership (K4) and compaction.

Port of keyhuntm1cpu_tpu/curve/pbrute.py. One chunk is:

- **K1 advance chain** (curve/pwalk.py, reused): the K walk bases
  P, P+ADV, ..., P+(K-1)ADV of the chunk's single chain.
- **K4 brute walk** (``brute_walk_blocks``): every point base_s + tab_u
  gets its affine x3 (and y3 for eth / uncompressed), the GLV variants
  beta^e * x3, the mode's hashes (hash/phash.py; csrc/hash.cuh on the
  card) and a membership test against T 64-bit big-endian intervals
  (exact targets are point intervals) and, for large exact sets, a
  lane-bucketed high-word table. One u32 hit word per point: bit q for
  query set q (GLV power major, then the mode's hashes), 1 << 30 in place
  of every bit on a degenerate (dx == 0) lane.
- **Compaction** (``compact_hits``, no host sync): rows of 128 hit words
  are reduced, the flagged rows compacted (budget R = max(8, C // 32)),
  then the flagged words within them; one (2C + 3K + 1,) int32 summary
  [cand_pos (C), cand_bits (C), n_deg (K), first_deg (K), adv_deg (K), n].

``brute_walk_blocks`` and ``compact_hits`` run their plain torch versions
(``*_ref``) for CPU tensors and launch their CUDA kernels (csrc/pbrute.cu,
csrc/compact.cu) for CUDA tensors; each counts its kernel launches in
``<wrapper>.launches``. Layouts are pwalk's: limb-major int32 (8, n)
field elements holding u32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..field import fe
from ..filter.bitmap import compact_positions
from ..hash import phash
from ..ref import ecref
from . import pwalk

LANES = 128
HIT_DEGENERATE = 1 << 30

MODES = ("xpoint", "rmd160", "eth", "address_u", "rmd160_both")
NEEDS_Y = ("eth", "address_u", "rmd160_both")
ENDO_MODES = ("rmd160", "xpoint")  # the only modes run with n_endo = 3


def n_qsets(mode: str, n_endo: int) -> int:
    """Query-set pairs emitted per walk point."""
    per = {"rmd160": 2, "rmd160_both": 3}.get(mode, 1)
    return per * n_endo


def pack_buckets(vals64) -> np.ndarray:
    """(Lmax, 128) uint32 bucketed HIGH words: the 64-bit compare value v
    lands in lane v & 127, storing v >> 32. Lmax = the largest bucket,
    rounded up to a multiple of 8. Padding repeats the bucket's first
    entry; empty buckets stay zero (a zero high word can only make a
    spurious candidate, which the exact host verification removes)."""
    if not len(vals64):
        raise ValueError("empty bucketed target set")
    buckets: list = [[] for _ in range(LANES)]
    for v in vals64:
        v = int(v)
        buckets[v & 127].append((v >> 32) & 0xFFFFFFFF)
    lmax = max(8, -(-max(len(b) for b in buckets) // 8) * 8)
    out = np.zeros((lmax, LANES), dtype=np.uint32)
    for lane, vals in enumerate(buckets):
        for r in range(lmax if vals else 0):
            out[r, lane] = vals[r] if r < len(vals) else vals[0]
    return out


def pack_intervals(lo64, hi64) -> np.ndarray:
    """(4, T_pad) uint32 interval bounds [lo_hi, lo_lo, hi_hi, hi_lo] from
    64-bit big-endian lo/hi values, padded to the next power of two (>= 8)
    by repeating entry 0. Exact targets are point intervals (lo == hi)."""
    t = len(lo64)
    if t == 0:
        raise ValueError("empty target/interval set")
    tp = 8
    while tp < t:
        tp *= 2
    out = np.empty((4, tp), dtype=np.uint32)
    for i in range(tp):
        lo = int(lo64[i] if i < t else lo64[0])
        hi = int(hi64[i] if i < t else hi64[0])
        out[0, i] = (lo >> 32) & 0xFFFFFFFF
        out[1, i] = lo & 0xFFFFFFFF
        out[2, i] = (hi >> 32) & 0xFFFFFFFF
        out[3, i] = hi & 0xFFFFFFFF
    return out


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need a contiguous int32 tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# K4: brute walk blocks
# ---------------------------------------------------------------------------


def _member(a, b, tgt, btab, n_bucket_rows: int):
    """(a, b) = high and low 32 bits of each query's compare value, int64
    u32 tiles; tgt (4, T) and btab (TB, 128) int64 u32 values."""
    m = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for t in range(tgt.shape[1]):
        lo_h, lo_l, hi_h, hi_l = tgt[:, t]
        ge = (a > lo_h) | ((a == lo_h) & (b >= lo_l))
        le = (a < hi_h) | ((a == hi_h) & (b <= hi_l))
        m |= ge & le
    lane = b & 127
    for r in range(n_bucket_rows):
        m |= btab[r][lane] == a
    return m


def _query_pairs(mode: str, xl, yl):
    """[(a, b)] compare words of one GLV variant, in query-set order."""
    if mode == "xpoint":
        return [(xl[1], xl[0])]  # raw low 64 bits of x
    if mode in ("rmd160", "rmd160_both"):
        words = [phash.hash160_parity_words(xl, 2), phash.hash160_parity_words(xl, 3)]
        if mode == "rmd160_both":
            words.append(phash.hash160_u_words(xl, yl))
    elif mode == "eth":
        words = [phash.keccak_eth_words(xl, yl)]
    else:  # address_u
        words = [phash.hash160_u_words(xl, yl)]
    # LE digest words -> big-endian bytes 0..7 (interval order)
    return [(phash._bswap(lo), phash._bswap(hi)) for lo, hi in words]


def brute_walk_blocks_ref(bases_x, bases_y, tab_x, tab_y, tgt, btab, mode: str,
                          n_endo: int, n_bucket_rows: int):
    """Plain torch version of K4 (see brute_walk_blocks)."""
    K = bases_x.shape[1]
    bx, by = fe.u32(bases_x)[:, :, None], fe.u32(bases_y)[:, :, None]
    tx, ty = fe.u32(tab_x)[:, None, :], fe.u32(tab_y)[:, None, :]
    dx = fe.sub(tx, bx)  # (8, K, U)
    deg = fe.is_zero(dx)
    dx = fe.select(deg, fe.one_like(dx), dx)
    inv_dx = fe.montgomery_inv_groups(dx, n_groups=K)
    lam = fe.mul(fe.sub(ty, by), inv_dx)
    x3 = fe.sub(fe.sub(fe.sqr(lam), bx), tx)
    y3 = fe.sub(fe.mul(lam, fe.sub(bx, x3)), by) if mode in NEEDS_Y else None
    tgt64, btab64 = fe.u32(tgt), fe.u32(btab)
    hit = torch.zeros(deg.shape, dtype=torch.int64, device=deg.device)
    q = 0
    for e in range(n_endo):
        xv = x3
        if e:
            beta = pow(ecref.BETA, e, ecref.P)
            b_lm = torch.from_numpy(fe.int_to_limbs(beta).astype(np.int64))
            xv = fe.mul(x3, b_lm.to(x3.device)[:, None, None].expand(8, *x3.shape[1:]))
        for a, b in _query_pairs(mode, list(xv), None if y3 is None else list(y3)):
            hit |= _member(a, b, tgt64, btab64, n_bucket_rows).to(torch.int64) << q
            q += 1
    hit = torch.where(deg, HIT_DEGENERATE, hit)
    return fe.i32(hit)


def brute_walk_blocks(bases_x, bases_y, tab_x, tab_y, tgt, btab, mode: str,
                      n_endo: int, n_bucket_rows: int):
    """bases: (8, K) int32 affine walk bases; tab: (8, U) int32 offsets;
    tgt: (4, T) int32 interval bounds (pack_intervals); btab:
    (max(n_bucket_rows, 8), 128) int32 bucketed high words (pack_buckets;
    unread when n_bucket_rows == 0). Returns (K, U) int32 hit words."""
    if mode not in MODES:
        raise ValueError(f"unknown brute mode {mode!r}")
    if n_endo not in (1, 3) or (n_endo == 3 and mode not in ENDO_MODES):
        raise ValueError(f"n_endo={n_endo} is not supported for mode {mode!r}")
    K = bases_x.shape[1] if bases_x.dim() == 2 else -1
    U = tab_x.shape[1] if tab_x.dim() == 2 else -1
    T = tgt.shape[1] if tgt.dim() == 2 else -1
    TB = n_bucket_rows
    for name, t, shape in (("bases_x", bases_x, (8, K)), ("bases_y", bases_y, (8, K)),
                           ("tab_x", tab_x, (8, U)), ("tab_y", tab_y, (8, U)),
                           ("tgt", tgt, (4, T)), ("btab", btab, (max(TB, 8), LANES))):
        _check(name, t, shape)
    if K < 1 or U < 1 or T < 1 or TB < 0:
        raise ValueError(f"brute_walk_blocks needs K, U, T >= 1 (K={K}, U={U}, T={T})")
    if not _build.on_cuda(bases_x, bases_y, tab_x, tab_y, tgt, btab):
        return brute_walk_blocks_ref(bases_x, bases_y, tab_x, tab_y, tgt, btab,
                                     mode, n_endo, n_bucket_rows)
    hits = torch.empty((K, U), dtype=torch.int32, device=bases_x.device)
    ptrs = [t.data_ptr() for t in (bases_x, bases_y, tab_x, tab_y, tgt, btab, hits)]
    _build.launch("kh_brute_walk_blocks", *ptrs, K, U, T, TB, MODES.index(mode),
                  n_endo, _build.stream(bases_x))
    brute_walk_blocks.launches += 1
    return hits


brute_walk_blocks.launches = 0


# ---------------------------------------------------------------------------
# Chunk: K1 + K4 + compaction
# ---------------------------------------------------------------------------


def row_budget(C: int) -> int:
    """R: the flagged 128-word rows a chunk's compaction picks."""
    return max(8, C // 32)


def compact_hits_ref(hits: torch.Tensor, adeg: torch.Tensor, C: int) -> torch.Tensor:
    """Plain torch version of the kernel (see compact_hits): the JAX
    chunk's compaction ops."""
    K, U = hits.shape
    rows2 = hits.reshape(-1, LANES)
    qbits2 = rows2 & (HIT_DEGENERATE - 1)
    R = row_budget(C)
    nr = rows2.shape[0]
    rowflag = (qbits2 != 0).any(dim=1)
    n_rows = rowflag.sum(dtype=torch.int32)
    rsel = compact_positions(rowflag, R, nr)
    picked = qbits2[rsel.clamp(max=nr - 1).long()]
    picked = torch.where((rsel < nr)[:, None], picked, 0)
    mask = (picked != 0).reshape(-1)
    n = mask.sum(dtype=torch.int32)
    n = torch.where(n_rows > R, C + 1, n)
    ip = compact_positions(mask, C, R * LANES)
    ips = ip.clamp(max=R * LANES - 1).long()
    valid = ip < R * LANES
    bits = torch.where(valid, picked.reshape(-1)[ips], 0)
    pos = torch.where(valid, rsel[ips // LANES] * LANES + ips % LANES, K * U)
    deg = ((hits >> 30) & 1).to(torch.uint8)
    return torch.cat([pos.to(torch.int32), bits.to(torch.int32),
                      deg.sum(dim=1, dtype=torch.int32),
                      deg.argmax(dim=1).to(torch.int32),
                      adeg.to(torch.int32), n.reshape(1)])


def compact_hits(hits: torch.Tensor, adeg: torch.Tensor, C: int) -> torch.Tensor:
    """(K, U) int32 hit words (U % 128 == 0) + (K,) bool adv-degenerate
    flags -> the packed (2C + 3K + 1,) int32 summary [cand_pos (C),
    cand_bits (C), n_deg (K), first_deg (K), adv_deg (K), n]: the first C
    non-zero query words (bits 0..29) of the first R = max(8, C // 32)
    flagged 128-word rows, their flat positions (K*U = padding) and bits;
    per step the words with the degenerate bit 30 and the first of them (0
    when none); the advance flags; n, their count in the picked rows. A
    row overflow (more flagged rows than R) reports n = C + 1, which sends
    the host to an exact rescan of the chunk. One launch of csrc/compact.cu
    kh_compact_hits on the card and no memset (the stream's scratch pair,
    _COMPACT), counted in ``compact_hits.launches``; its plain version
    ``compact_hits_ref`` for CPU tensors."""
    K, U = hits.shape if hits.dim() == 2 else (-1, -1)
    if (hits.dtype != torch.int32 or not hits.is_contiguous() or adeg.dtype != torch.bool
            or not adeg.is_contiguous() or tuple(adeg.shape) != (K,)):
        raise ValueError(f"compact_hits: need contiguous (K, U) int32 hits and (K,) bool "
                         f"adeg, got {hits.dtype} {tuple(hits.shape)}, {adeg.dtype} "
                         f"{tuple(adeg.shape)}")
    if K < 1 or U < LANES or U % LANES or C < 1 or K * U >= 1 << 31:
        raise ValueError(f"compact_hits needs K, C >= 1, U a multiple of {LANES} and "
                         f"K*U < 2^31 (K={K}, U={U}, C={C})")
    if not _build.on_cuda(hits, adeg):
        return compact_hits_ref(hits, adeg, C)
    if hits.data_ptr() % 16:
        raise ValueError("compact_hits: the hit words must be 16-byte aligned")
    out = torch.empty((2 * C + 3 * K + 1,), dtype=torch.int32, device=hits.device)
    # the ticket (two u32 words), each step's flagged rows and row flags
    words = 2 + K + K * -(-U // LANES // 32)
    _COMPACT.launch("kh_compact_hits", hits, -(-words // 2),
                    (hits.data_ptr(), adeg.data_ptr(), out.data_ptr()), (K, U, C))
    compact_hits.launches += 1
    return out


compact_hits.launches = 0
# a pair of scratches a stream; each launch zeroes the other's ticket alone
_COMPACT = _build.ScratchPairs(whole=False)


def brute_chunk(px, py, tab_x_lm, tab_y_lm, ax, ay, tgt, btab, *, K: int, U: int,
                C: int, mode: str, n_endo: int, n_bucket_rows: int = 0, adv_tab=None):
    """px/py: (8,) int32 limbs of the chunk's base point; tab_*_lm: (8, U);
    ax/ay: (8,) ADV = U * stride * G and adv_tab its table
    (pwalk.adv_multiples(ADV, K), built per call when None). Returns
    (next_x, next_y, summary): the base K steps on and the (2C + 3K + 1,)
    int32 summary (see compact_hits). No host sync: the summary stays where it was made."""
    if U % LANES:
        raise ValueError(f"brute_chunk needs U % {LANES} == 0 (U={U})")
    bx, by, nx, ny, adeg = pwalk.advance_chain(px[:, None], py[:, None], ax, ay, K,
                                               adv_tab)
    hits = brute_walk_blocks(bx, by, tab_x_lm, tab_y_lm, tgt, btab, mode, n_endo,
                             n_bucket_rows)
    return nx[:, 0], ny[:, 0], compact_hits(hits, adeg[0], C)
