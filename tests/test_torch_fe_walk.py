"""K2's own field arithmetic (keyhuntm1cpu_tpu_torch/csrc/fe_walk.cuh) in
its limb-exact model (tests/fe_walk_model.py) against Python integers: the
product, squaring, subtraction and canonical low words on edge values
(0, 1, p - 1, the values from p - 2^32 - 977 to p - 1, p and past it up to
2^256 - 1 where an input may be unreduced, operands of all-ones limbs) and
on seeded random pairs, the model asserting at each step the bounds that
make leaving values unreduced safe; and K2's walk of a few rows of
columns through the model (the forward chain, one inversion, the backward
pass) against ecref's affine additions. The kernel itself is held to the
plain K2 on the card (tests/test_torch_kernels_cuda.py)."""

import random

import pytest

import fe_walk_model as fw
from keyhuntm1cpu_tpu_torch.ref import ecref

P = fw.P
W = fw.to_words
V = fw.from_words

# values an input of fw_mul / fw_sqr / fw_sub's first operand may take (any
# < 2^256), by kind
EDGES = {
    "small": [0, 1, 2, 3, 977, 2**32 - 1, 2**32, 2**32 + 977, 2**32 + 976, 2**64 - 1],
    "below_p": [P - 1, P - 2, P - 2**32 - 977, P - 2**32 - 976, P - 2**32 - 978, P - 977,
                P - 2**32],
    "unreduced": [P, P + 1, P + 2**32 + 976, 2**256 - 2**32 - 978, 2**256 - 2, 2**256 - 1],
    "limbs": [sum(0xFFFFFFFF << (32 * k) for k in ks)
              for ks in ([0], [7], [0, 2, 4, 6], [1, 3, 5, 7], range(4), range(4, 8),
                         range(1, 8), range(7))],
    "powers": [2**k for k in (31, 32, 63, 64, 128, 224, 255)] + [(2**256 - 1) // 3,
                                                                  2**255 - 19],
}
ALL_EDGES = sorted({v for vs in EDGES.values() for v in vs})


def _check_pair(a, b):
    A, B = W(a), W(b)
    r = V(fw.mul(A, B))
    assert r < 2**256 and r % P == a * b % P, (hex(a), hex(b))
    assert V(fw.mul(B, A)) % P == r % P
    if b < P:
        d = V(fw.sub(A, B))
        assert d < 2**256 and d % P == (a - b) % P, (hex(a), hex(b))


def _check_one(a):
    A = W(a)
    s = V(fw.sqr(A))
    assert s < 2**256 and s % P == a * a % P, hex(a)
    assert fw.canon_lo(A) == W(a % P)[:2]


@pytest.mark.parametrize("kind", sorted(EDGES))
def test_edges_against_every_edge(kind):
    for a in EDGES[kind]:
        _check_one(a)
        for b in ALL_EDGES:
            _check_pair(a, b)
            _check_pair(b, a)


@pytest.mark.parametrize("seed", range(6))
def test_random_pairs(seed):
    rng = random.Random(0x25 * 1000 + seed)
    for i in range(600):
        a = rng.getrandbits(256) if i % 3 else rng.randrange(P)
        b = rng.randrange(P) if i % 2 else rng.getrandbits(256)
        _check_pair(a, b)
        _check_one(a)


@pytest.mark.parametrize("seed", range(3))
def test_lazy_chains(seed):
    """Products of products, as K2 chains them (acc, inv, inv_j, lambda),
    stay < 2^256 and equal mod p: 64 steps from seeded starts."""
    rng = random.Random(seed)
    a, b = rng.randrange(P), rng.randrange(P)
    A, B = W(a), W(b)
    for _ in range(64):
        A = fw.mul(A, B)
        a = a * b % P
        assert V(A) % P == a
        B = fw.sqr(fw.sub(A, W(b)))
        b = (a - b) ** 2 % P
        assert V(B) % P == b
        b = V(B) % P
        B = W(b)


def test_subtraction_wraps_exactly():
    """fw_sub where a < b (p added back) and a >= b, a unreduced or not,
    down to the values whose difference is 0 and p - 1."""
    for a in ALL_EDGES:
        for b in [0, 1, 2**32 + 977, P - 1, P - 2, 2**255, a % P, (a + 1) % P, (a - 1) % P]:
            d = V(fw.sub(W(a), W(b)))
            assert d < 2**256 and d % P == (a - b) % P
            if a < P:
                assert d == (a - b) % P  # canonical in, canonical out: K2's dx is exact


def test_canonical_low_words_below_2_32_plus_977():
    """x3 below 2^32 + 977 is where a value left unreduced (x3 + p < 2^256)
    would emit other low words: fw_canon_lo gives x3's own."""
    for x in [0, 1, 5, 977, 2**32, 2**32 + 976]:
        assert fw.canon_lo(W(x + P)) == W(x)[:2]
        assert fw.canon_lo(W(x)) == W(x)[:2]
    for x in [2**32 + 977, 2**32 + 978, 2**64]:  # x + p >= 2^256: only x itself
        assert fw.canon_lo(W(x)) == W(x)[:2]


def _small_x_point():
    """A curve point with a small x (x^3 + 7 a square mod p)."""
    for x in range(1, 200):
        y = pow(x**3 + 7, (P + 1) // 4, P)
        if y * y % P == (x**3 + 7) % P:
            return x, y
    raise AssertionError("no small x")


def _walk_rows_model(bases, tab):
    """K2's walk of one column set through the model: per column u the
    forward chain over the rows (dx == 0 lanes as 1), one inversion of
    its total (the block tree's, here pow), the backward pass; returns
    {(row, u): (qlo, qhi, deg)}."""
    out = {}
    one = W(1)
    for u, (tx, ty) in enumerate(tab):
        tX, tY = W(tx), W(ty)
        pref, acc, degs = [], None, []
        for bx, _ in bases:
            dx = fw.sub(tX, W(bx))
            z = V(dx) == 0
            degs.append(z)
            if z:
                dx = one
            acc = fw.mul(acc, dx) if acc is not None else dx
            pref.append(acc)
        inv = W(pow(V(acc), P - 2, P))
        for j in range(len(bases) - 1, -1, -1):
            bX, bY = W(bases[j][0]), W(bases[j][1])
            inv_j = inv
            if j > 0:
                dx = fw.sub(tX, bX)
                if V(dx) == 0:
                    dx = one
                inv_j = fw.mul(inv, pref[j - 1])
                inv = fw.mul(inv, dx)
            lam = fw.mul(fw.sub(tY, bY), inv_j)
            x3 = fw.sub(fw.sub(fw.sqr(lam), bX), tX)
            out[(j, u)] = (*fw.canon_lo(x3), degs[j])
    return out


def test_walk_rows_match_ecref():
    """Rows of bases against a table of columns, with an x3 planted below
    2^32 + 977 (base = R - T_u for R of small x), dy = 0 (a base of T_u's
    y and another x), dx = 0 (base = T_u and -T_u), dx = p - 1 and 1 where
    a curve point has x one off T_u's: x3's low 64 bits equal ecref's
    x(base + T_u), dx == 0 lanes flagged."""
    tab = [ecref.scalar_mult(7 * (u + 1)) for u in range(6)]
    bases = [ecref.scalar_mult(1000 + 17 * r) for r in range(9)]
    small = _small_x_point()
    bases[1] = ecref.point_add(small, ecref.point_neg(tab[2]))
    beta = pow(3, (P - 1) // 3, P)  # a cube root of unity: (beta x, y) is on the curve
    bases[2] = (beta * tab[4][0] % P, tab[4][1])
    bases[4] = tab[1]
    bases[7] = ecref.point_neg(tab[5])
    for row, dxv in ((5, 1), (6, P - 1)):
        for t in tab:
            x = (t[0] - dxv) % P
            y = pow(x**3 + 7, (P + 1) // 4, P)
            if y * y % P == (x**3 + 7) % P:
                bases[row] = (x, y)
                break
        else:
            raise AssertionError(f"no base with dx = {dxv}")
    got = _walk_rows_model(bases, tab)
    for (j, u), (qlo, qhi, deg) in got.items():
        b, t = bases[j], tab[u]
        assert deg == (b[0] == t[0]), (j, u)
        if deg:
            continue
        x3 = ecref.point_add(b, t)[0]
        assert (qlo, qhi) == tuple(W(x3)[:2]), (j, u)
    assert got[(1, 2)][:2] == tuple(W(small[0])[:2])
    assert got[(4, 1)][2] and got[(7, 5)][2]
