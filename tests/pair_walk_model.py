"""A model of K2's paired walk (keyhuntm1cpu_tpu_torch/csrc/pwalk.cu
walk_pairs_kernel) on Python ints, step for step as the kernel takes it:

- the half-step centre C_r = base_r + c*S, c = (U + 1)/2 mod n, as K1 gives
  it (advance_chain with centre_tab), and K1's row flag where C_r is not a
  point of base_r's walk (the centre at infinity, a base off the curve);
- the pair table t_d = (d + 1/2)*S, d < U/2 (tables.pair_table);
- thread d of a block of THREADS over G rows: columns U/2 + d (C + t_d) and
  U/2 - 1 - d (C - t_d), the forward Montgomery chain over the rows with a
  zero dx entered as 1, one inversion of the block's chain totals, the
  backward pass with lambda (y_t - y_C) / dx and (-y_t - y_C) / dx;
- the rare lanes walked alone as walk_blocks_kernel walks them (lone):
  every column of a pair with dx == 0 or of a flagged row, and a column
  whose base has the low word of x(tab_u) (the kernel walks them again
  after its loop, the same words);
- the probe's ballots: a warp is 32 consecutive d, its plus side's bits one
  mask word in lane order, its minus side's one word bit-reversed.

The field arithmetic is exact mod p here (fe_walk.cuh's lazy products are
held to the exact ones by tests/test_torch_fe_walk.py), so every x is
canonical where the kernel makes it so. G and THREADS are read from
pwalk.cu, so the model follows the kernel's shape.
"""

import os
import re

from keyhuntm1cpu_tpu_torch.ref import ecref

P, N = ecref.P, ecref.N
M32 = 0xFFFFFFFF
HALF = (N + 1) // 2  # 1/2 mod n

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "keyhuntm1cpu_tpu_torch", "csrc", "pwalk.cu")
with open(_SRC) as _f:
    _text = _f.read()
G = int(re.search(r"constexpr int kPairGroup = (\d+);", _text).group(1))
THREADS = int(re.search(r"constexpr int kPairThreads = (\d+);", _text).group(1))


def centre_scalar(U):
    """c = (U + 1)/2 mod n."""
    return (U + 1) * HALF % N


def pair_points(S, U):
    """t_d = (d + 1/2)*S for d < U/2, by steps of S from S/2."""
    out, cur = [], ecref.scalar_mult(HALF, S)
    for _ in range(U // 2):
        out.append(cur)
        cur = ecref.point_add(cur, S)
    return out


def centres(bases, S, U):
    """K1's centres and row flags for these bases: (C_r or None, flagged)."""
    cS = ecref.scalar_mult(centre_scalar(U), S)
    out = []
    for b in bases:
        if not ecref.is_on_curve(b):
            out.append((None, True))
            continue
        c = ecref.point_add(b, cS)
        out.append((c, c is None))
    return out


def lone(b, t):
    """walk_blocks_kernel's word for base b + table point t: (lo, hi, deg)."""
    dx = (t[0] - b[0]) % P
    z = dx == 0
    lam = (t[1] - b[1]) * pow(1 if z else dx, P - 2, P) % P
    x3 = (lam * lam - b[0] - t[0]) % P
    return x3 & M32, (x3 >> 32) & M32, z


def word_of(lo, hi, bits):
    """probe.cuh word_of and the bit: the low `bits` bits of hi:lo."""
    if bits > 32:
        return (lo >> 5) | ((hi & ((1 << (bits - 32)) - 1)) << 27), lo & 31
    idx = lo & ((1 << bits) - 1)
    return idx >> 5, idx & 31


def brev(v):
    return int(f"{v:032b}"[::-1], 2)


def walk_pairs(bases, tab, S, words=None, bits=0):
    """The paired walk of rows `bases` over the step table tab = [(u + 1)*S]
    (affine points of ints). Returns qlo, qhi, deg as (R, U) lists of ints
    and, given the bitmap's words (a list of u32) and bits, the survivor
    mask (R, U/32) of u32 words; and the set of (row, column) walked alone."""
    R, U = len(bases), len(tab)
    assert U % 64 == 0, "the paired walk needs U % 64 == 0"
    H = U // 2
    pairs, cen = pair_points(S, U), centres(bases, S, U)
    qlo = [[0] * U for _ in range(R)]
    qhi = [[0] * U for _ in range(R)]
    deg = [[False] * U for _ in range(R)]
    alone = set()
    for r0 in range(0, R, G):
        rows = list(range(r0, min(R, r0 + G)))
        for blk in range(-(-H // THREADS)):
            threads = range(blk * THREADS, min(H, (blk + 1) * THREADS))
            # forward: each thread's chain of dx over its rows
            chains = {}
            for d in threads:
                t = pairs[d]
                pref, acc = [], 1
                for r in rows:
                    c = cen[r][0] or (1, 1)  # a flagged row's centre: any value
                    dx = (t[0] - c[0]) % P
                    acc = acc * (dx or 1) % P
                    pref.append(acc)
                chains[d] = pref
            for d in threads:
                t, pref = pairs[d], chains[d]
                # the block's shared inversion gives each thread 1 / its total
                inv = pow(pref[-1], P - 2, P)
                up, um = H + d, H - 1 - d
                for j in range(len(rows) - 1, -1, -1):
                    r = rows[j]
                    c, flagged = cen[r]
                    c = c or (1, 1)
                    dx = (t[0] - c[0]) % P
                    inv_j = inv * pref[j - 1] % P if j else inv
                    inv = inv * (dx or 1) % P
                    lam_p = (t[1] - c[1]) * inv_j % P
                    lam_m = (-t[1] - c[1]) * inv_j % P
                    for u, lam in ((up, lam_p), (um, lam_m)):
                        x3 = (lam * lam - c[0] - t[0]) % P
                        qlo[r][u], qhi[r][u] = x3 & M32, (x3 >> 32) & M32
                    for u in (up, um):  # x's low words match: walked alone too
                        if dx == 0 or flagged or bases[r][0] & M32 == tab[u][0] & M32:
                            qlo[r][u], qhi[r][u], deg[r][u] = lone(bases[r], tab[u])
                            alone.add((r, u))
    if words is None:
        return qlo, qhi, deg, alone
    mask = [[0] * (U // 32) for _ in range(R)]
    for r in range(R):
        for d0 in range(0, H, 32):  # a warp
            hp = hm = 0
            for lane in range(32):
                d = d0 + lane
                for u, side in ((H + d, "p"), (H - 1 - d, "m")):
                    w, b = word_of(qlo[r][u], qhi[r][u], bits)
                    hit = (words[w] >> b) & 1
                    if side == "p":
                        hp |= hit << lane
                    else:
                        hm |= hit << lane
            mask[r][(H + d0) // 32] = hp
            mask[r][(H - d0) // 32 - 1] = brev(hm)
    return qlo, qhi, deg, alone, mask


def _curve_point(x):
    y = pow(x**3 + 7, (P + 1) // 4, P)
    return (x, y) if y * y % P == (x**3 + 7) % P else None


def plants(case, U, tab, S):
    """{row: base} planting the rare lanes of the paired walk over the step
    table tab = [(u + 1)*S], u < U, by case (see test_torch_pair_walk.py)."""
    H, c = U // 2, centre_scalar(U)
    cS = ecref.scalar_mult(c, S)
    pairs = pair_points(S, U)
    neg = ecref.point_neg
    last = min(H, THREADS) - 1  # the first block's last pair
    if case == "plain":
        return {}
    if case == "plus_minus":  # base = +-tab_u at both columns of pairs 0, 5, last
        out = {}
        for n, d in enumerate((0, 5, last)):
            out[4 * n] = tab[H + d]
            out[4 * n + 1] = neg(tab[H - 1 - d])
            out[4 * n + 2] = neg(tab[H + d])
            out[4 * n + 3] = tab[H - 1 - d]
        return out
    if case == "pair_dx_zero":  # C = t_d and C = -t_d: one column at infinity
        return {1: ecref.point_add(pairs[3], neg(cS)),
                33: ecref.point_add(neg(pairs[last]), neg(cS)),
                40: ecref.point_add(pairs[0], neg(cS))}
    if case == "centre":  # base = -c*S: no centre (flagged); +c*S: a doubling
        return {2: neg(cS), 31: cS, 32: neg(cS)}
    if case == "off_curve":  # a garbage base, as K1 leaves past a flag
        b = ecref.scalar_mult(12345)
        return {3: (b[0], (b[1] + 1) % P), 69: (b[0] + 1, b[1])}
    if case == "fe_edges":  # x3 < 2^32 + 977; dy == 0 by column and by pair
        small = next(pt for pt in map(_curve_point, range(1, 200)) if pt)
        beta = pow(3, (P - 1) // 3, P)
        t = pairs[7]
        cen = (beta * t[0] % P, t[1])  # y_C == y_t: the plus side's dy == 0
        return {5: ecref.point_add(small, neg(tab[H + 9])),
                6: ecref.point_add(small, neg(tab[H - 1 - 9])),
                7: (beta * tab[H + 2][0] % P, tab[H + 2][1]),
                8: ecref.point_add(cen, neg(cS))}
    raise ValueError(case)
