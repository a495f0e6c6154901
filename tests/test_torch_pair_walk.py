"""K2's paired walk (keyhuntm1cpu_tpu_torch/csrc/pwalk.cu walk_pairs_kernel),
run on the CPU as its model (tests/pair_walk_model.py), held word for word to
the plain version walk_blocks_ref (qlo, qhi, deg and the survivor mask of
bitmap.survivor_mask_ref) at U % 64 == 0 with ragged row groups, with the
rare lanes planted: base = +-tab_u at both columns of a pair and at a
block's first and last pair, a pair with dx == 0 on each side, base = +-c*S
(the centre at infinity and a doubling centre), a base off the curve, x3
below 2^32 + 977 and dy == 0. Also the paired walk's tables and K1's
centres (advance_chain with centre_tab, plain version) against ecref.
Integer arithmetic: the tolerance is exact equality."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu_torch.curve import pwalk, tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref  # noqa: E402
import pair_walk_model as pm  # noqa: E402

torch.set_num_threads(1)
P = ecref.P
S = ecref.point_neg(ecref.scalar_mult(1 << 13))  # S = -(2m)G at m = 2^12
BITS = 12  # a 2^12-bit bitmap, ~1/4 of it set: many survivors


def _limbs(v):
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())


def _lm(pts):
    return (torch.stack([_limbs(p[0]) for p in pts], 1).contiguous(),
            torch.stack([_limbs(p[1]) for p in pts], 1).contiguous())


CASES = [("plain", 64, 70), ("plus_minus", 128, 70), ("pair_dx_zero", 64, 70),
         ("centre", 128, 45), ("off_curve", 64, 70), ("fe_edges", 128, 33),
         ("plus_minus", 1024, 33)]


@pytest.mark.parametrize("case,U,R", CASES, ids=[f"{c}-U{u}-R{r}" for c, u, r in CASES])
def test_paired_walk_model_matches_walk_blocks_ref(case, U, R):
    """The model's qlo, qhi, deg and survivor mask equal walk_blocks_ref's
    on every (row, column) of R rows (ragged against the 32-row groups) and
    U columns (U = 1024: two blocks of 256 pairs); each planted lane is
    walked alone, and no other lane is."""
    xs, ys = tables.step_table(S, U)
    tab = [(fe.limbs_to_int(x), fe.limbs_to_int(y)) for x, y in zip(xs, ys)]
    rng = random.Random(f"{case}-{U}-{R}")
    bases = [ecref.scalar_mult(rng.randrange(1, 1 << 64)) for _ in range(R)]
    plants = pm.plants(case, U, tab, S)
    for r, b in plants.items():
        bases[r] = b
    g = torch.Generator().manual_seed(U + R)
    rnd = lambda: torch.randint(-2**31, 2**31, (1 << (BITS - 5),), dtype=torch.int32, generator=g)
    bm = bmp.DeviceBitmap(rnd() & rnd(), BITS)
    bx, by = _lm(bases)
    want = pwalk.walk_blocks_ref(bx, by, pwalk.table_to_limb_major(xs, "cpu"),
                                 pwalk.table_to_limb_major(ys, "cpu"), bm)
    words = bm.words.numpy().view(np.uint32).tolist()
    qlo, qhi, deg, alone, mask = pm.walk_pairs(bases, tab, S, words, BITS)
    assert np.array_equal(np.array(qlo, np.uint32), want[0].numpy().view(np.uint32))
    assert np.array_equal(np.array(qhi, np.uint32), want[1].numpy().view(np.uint32))
    assert np.array_equal(np.array(deg, bool), want[2].numpy())
    assert np.array_equal(np.array(mask, np.uint32), want[3].numpy().view(np.uint32))
    H, low = U // 2, lambda v: v & 0xFFFFFFFF
    cS = ecref.scalar_mult(pm.centre_scalar(U), S)
    expect = set()
    for r, b in enumerate(bases):
        on = ecref.is_on_curve(b)
        cen = ecref.point_add(b, cS) if on else None
        for d, t in enumerate(pm.pair_points(S, U)):
            for u in (H + d, H - 1 - d):
                if cen is None or cen[0] == t[0] or low(b[0]) == low(tab[u][0]):
                    expect.add((r, u))
    assert alone == expect
    rows = {"plain": set(), "fe_edges": set(), "centre": {2, 32}}.get(case, set(plants))
    assert {r for r, _ in alone} == rows
    if case == "plus_minus":  # b = +-tab_u flagged, as K2 flags it, and nothing else
        last = min(H, pm.THREADS) - 1
        cols = {(4 * n + k, H + d if k % 2 == 0 else H - 1 - d)
                for n, d in enumerate((0, 5, last)) for k in range(4)}
        assert {(r, u) for r in range(R) for u in range(U) if deg[r][u]} == cols
    if case in ("pair_dx_zero", "centre", "off_curve"):
        assert not all(deg[r][u] for r, u in alone)  # the valid 2C, the garbage rows
    if case == "fe_edges":
        assert int(qlo[5][H + 9]) | int(qhi[5][H + 9]) << 32 < 2**32 + 977
        assert not any(deg[r][u] for r in range(R) for u in range(U))


def test_pair_table_and_centre_offsets_vs_ecref():
    """tables.pair_table entry d is (2d + 1)/2 * S; centre_offsets column j
    is j*ADV + ((U + 1)/2)*S, both mod n."""
    U, K = 128, 5
    adv = ecref.point_neg(ecref.scalar_mult(U << 13))
    hx, hy = tables.pair_table(S, U // 2)
    for d in (0, 1, 31, U // 2 - 1):
        want = ecref.scalar_mult((2 * d + 1) * pm.HALF % ecref.N, S)
        assert (fe.limbs_to_int(hx[d]), fe.limbs_to_int(hy[d])) == want
    cx, cy = pwalk.centre_offsets(S, U, adv, K, "cpu")
    assert cx.shape == (8, K) and cx.dtype == torch.int32
    cS = ecref.scalar_mult(pm.centre_scalar(U), S)
    for j in range(K):
        want = ecref.point_add(ecref.scalar_mult(j, adv), cS)
        got = (fe.limbs_to_int(cx[:, j].numpy().view(np.uint32)),
               fe.limbs_to_int(cy[:, j].numpy().view(np.uint32)))
        assert got == want


def test_advance_chain_centres_vs_ecref():
    """K1's plain version with centre_tab: centre s of target t is base_s +
    c*S, exactly, and flagged where the centre is infinity (P = -ctab_s),
    where base s is (P = -s*ADV, K1's flagged lane) and, every row of it,
    where P is off the curve; a doubling centre (P = ctab_s) is a point."""
    U, K, advk = 64, 6, 0xA5A5 << 7
    adv = ecref.scalar_mult(advk)
    ctab = pwalk.centre_offsets(S, U, adv, K, "cpu")
    col = lambda t, j: (fe.limbs_to_int(t[0][:, j].numpy().view(np.uint32)),
                        fe.limbs_to_int(t[1][:, j].numpy().view(np.uint32)))
    off = ecref.scalar_mult(99)
    pts = [ecref.scalar_mult(777), ecref.point_neg(col(ctab, 2)), ecref.scalar_mult(
        (-3 * advk) % ecref.N), col(ctab, 4), (off[0], (off[1] + 1) % P)]
    px, py = _lm(pts)
    out = pwalk.advance_chain(px, py, _limbs(adv[0]), _limbs(adv[1]), K,
                              pwalk.adv_multiples(adv, K, "cpu"), ctab)
    assert len(out) == 8
    bx, by, _, _, adeg, cx, cy, cflag = out
    base = pwalk.advance_chain(px, py, _limbs(adv[0]), _limbs(adv[1]), K)
    for g, w in zip(out[:5], base):
        assert torch.equal(g, w)
    flags = {(t, s) for t in range(len(pts)) for s in range(K) if cflag[t * K + s]}
    assert flags == {(1, 2), (2, 3)} | {(4, s) for s in range(K)}
    cS = ecref.scalar_mult(pm.centre_scalar(U), S)
    for t in range(4):
        for s in range(K):
            if (t, s) in flags:
                continue
            b = col((bx, by), t * K + s)
            assert col((cx, cy), t * K + s) == ecref.point_add(b, cS), (t, s)


def test_pair_tables_only_on_the_card_at_u_mod_64():
    """pair_tables is None off the card and where U % 64 != 0 (K2 then walks a
    point a thread); chunk_multi given pair tables on the CPU walks every
    point by the plain versions, the same words, and says it walked no
    pairs."""
    adv = ecref.point_neg(ecref.scalar_mult(64 << 13))
    assert pwalk.pair_tables(S, 64, adv, 4, "cpu") is None
    assert pwalk.pair_tables(S, 300, adv, 4, torch.device("cuda")) is None
    assert pwalk.pair_tables(S, 96, adv, 4, torch.device("cuda")) is None
    U, K, T = 64, 3, 2
    xs, ys = tables.step_table(S, U)
    tx, ty = pwalk.table_to_limb_major(xs, "cpu"), pwalk.table_to_limb_major(ys, "cpu")
    hx, hy = tables.pair_table(S, U // 2)
    pt = pwalk.PairTables(pwalk.table_to_limb_major(hx, "cpu"),
                          pwalk.table_to_limb_major(hy, "cpu"),
                          *pwalk.centre_offsets(S, U, adv, K, "cpu"))
    px, py = (t.t().contiguous() for t in _lm([ecref.scalar_mult(5), ecref.scalar_mult(6)]))
    args = (px, py, tx, ty, _limbs(adv[0]), _limbs(adv[1]))
    got = pwalk.chunk_multi(*args, K=K, U=U, T=T, pair_tab=pt)
    want = pwalk.chunk_multi(*args, K=K, U=U, T=T)
    assert not got.paired and not want.paired
    for g, w in zip(got[:6], want[:6]):
        assert torch.equal(g, w)


def test_walk_tables_agree_and_move():
    """walk_tables builds the step table (u + 1)*S, ADV and its multiples
    from one S and ADV, with no pair tables off the card; .to gives the same
    tables on another device. A BSGS engine's walk tables are its step table,
    ADV = U*S and ADV's table, and its sharded walk reads the same."""
    from keyhuntm1cpu_tpu_torch.engine import bsgs

    U, K = 64, 3
    adv = ecref.scalar_mult(U, S)
    w = pwalk.walk_tables(S, U, adv, K, "cpu")
    assert (w.U, w.K) == (U, K) and w.pair_tab is None
    xs, ys = tables.step_table(S, U)
    assert torch.equal(w.tab_x, pwalk.table_to_limb_major(xs, "cpu"))
    assert torch.equal(w.tab_y, pwalk.table_to_limb_major(ys, "cpu"))
    assert torch.equal(w.adv_x, _limbs(adv[0])) and torch.equal(w.adv_y, _limbs(adv[1]))
    for g, want in zip(w.adv_tab, pwalk.adv_multiples(adv, K, "cpu")):
        assert torch.equal(g, want)
    moved = w.to(torch.device("cpu"))
    assert moved.pair_tab is None and all(a is b for a, b in zip(moved[:4], w[:4]))
    params = bsgs.BSGSParams(m=1 << 12, block_u=U, steps_per_chunk=K, build_block=128,
                             bits_log2=16)
    eng = bsgs.BSGSEngine([ecref.scalar_mult(0xA00123)], 0xA00000, 0xA00000 + (1 << 22),
                          params, device="cpu")
    S_eng = ecref.point_neg(ecref.scalar_mult(eng.stride))
    want = pwalk.walk_tables(S_eng, U, ecref.scalar_mult(U, S_eng), K, "cpu")
    for g, t in zip((eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, *eng.adv_tab),
                    (*want[:4], *want.adv_tab)):
        assert torch.equal(g, t)
    assert eng.walk.pair_tab is None and eng.pair_tab is None
