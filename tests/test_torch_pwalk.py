"""Port walk (keyhuntm1cpu_tpu_torch/curve/pwalk.py, plain versions of the
K1/K2 kernels) vs the JAX package's XLA walk (curve/walk.walk_fused with
filter/sorted_table.trunc64_from_limbs) and ref/ecref, including the
degenerate cases: P == j*ADV (doubling lanes), P == -j*ADV (flagged) and
dx == 0 walk lanes, and the T=3 row layout t*K + s. Integer arithmetic:
the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import points, walk  # noqa: E402
from keyhuntm1cpu_tpu.filter import sorted_table as st  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import pwalk, tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe  # noqa: E402

torch.set_num_threads(1)
M64 = (1 << 64) - 1


def _limbs(v):
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())


def _pts(pts):
    """list of affine points -> (T, 8) x, y int32 tensors"""
    return (torch.stack([_limbs(p[0]) for p in pts]),
            torch.stack([_limbs(p[1]) for p in pts]))


def _u64(qhi, qlo):
    return ((qhi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
            | qlo.numpy().view(np.uint32).astype(np.uint64))


def test_advance_chain_degenerate_lanes_vs_ecref():
    advk, K = 1000, 6
    adv = ecref.scalar_mult(advk)
    # t0: P == ADV (doubling at step 1); t1: plain; t2: P + 3*ADV == 0
    ks = [advk, 12345, ecref.N - 3 * advk]
    px, py = _pts([ecref.scalar_mult(k) for k in ks])
    bx, by, nx, ny, adeg = pwalk.advance_chain(
        px.t().contiguous(), py.t().contiguous(), _limbs(adv[0]), _limbs(adv[1]), K)
    assert bx.shape == (8, 3 * K) and adeg.shape == (3, K)
    assert adeg.tolist() == [[False] * K, [False] * K,
                             [False, False, True] + [False] * (K - 3)]
    for t, k in enumerate(ks):
        for s in range(K):
            if t == 2 and s >= 3:
                continue  # past the flagged infinity the chain is garbage
            want = ecref.scalar_mult(k + s * advk)
            col = t * K + s
            assert fe.limbs_to_int(bx[:, col].numpy().view(np.uint32)) == want[0]
            assert fe.limbs_to_int(by[:, col].numpy().view(np.uint32)) == want[1]
        if t < 2:
            want = ecref.scalar_mult(k + K * advk)
            assert fe.limbs_to_int(nx[:, t].numpy().view(np.uint32)) == want[0]
            assert fe.limbs_to_int(ny[:, t].numpy().view(np.uint32)) == want[1]


def test_walk_blocks_dx_zero_lanes_vs_ecref():
    U = 12
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(7), U)
    rows = [ecref.scalar_mult(100), ecref.scalar_mult(7 * 5),
            ecref.point_neg(ecref.scalar_mult(7 * 9))]
    bx, by = _pts(rows)
    qlo, qhi, deg = pwalk.walk_blocks(
        bx.t().contiguous(), by.t().contiguous(),
        pwalk.table_to_limb_major(tab_x, "cpu"),
        pwalk.table_to_limb_major(tab_y, "cpu"))
    assert deg.nonzero().tolist() == [[1, 4], [2, 8]]
    keys = _u64(qhi, qlo)
    for r, base in enumerate(rows):
        for u in range(U):
            if not deg[r, u]:
                pt = ecref.point_add(base, ecref.scalar_mult(7 * (u + 1)))
                assert int(keys[r, u]) == pt[0] & M64


def test_chunk_multi_matches_walk_fused():
    """T=3 targets x K=4 steps x U=16 against K steps of walk_fused per
    target (its advance lane feeds the next step, as the XLA chunk does).
    Target 1 puts a dx == 0 lane in step 1; target 2 hits P == -ADV."""
    T, K, U = 3, 4, 16
    stride = 1 << 13
    s_pt = ecref.point_neg(ecref.scalar_mult(stride))
    tab_x, tab_y = tables.step_table(s_pt, U)
    adv = ecref.point_neg(ecref.scalar_mult(U * stride))
    c0 = 0xA00000
    # P_base = Q - c0*G; lane u (1-based) of step s sits at center
    # c0 + (s*U + u)*stride: a key there makes that lane degenerate
    ks = [0xA12345, c0 + (1 * U + 5) * stride, c0 + (2 * U + U) * stride]
    neg_c0 = ecref.scalar_mult((-c0) % ecref.N)
    bases = [ecref.point_add(ecref.scalar_mult(k), neg_c0) for k in ks]
    px, py = _pts(bases)
    res = pwalk.chunk_multi(px, py, pwalk.table_to_limb_major(tab_x, "cpu"),
                            pwalk.table_to_limb_major(tab_y, "cpu"),
                            _limbs(adv[0]), _limbs(adv[1]), K=K, U=U, T=T)

    wf = jax.jit(walk.walk_fused)
    cx, cy = jnp.asarray(px.numpy().view(np.uint32)), jnp.asarray(py.numpy().view(np.uint32))
    qh, ql, dg, ad = [], [], [], []
    for _ in range(K):
        r = wf(points.PointBatch(cx, cy, jnp.zeros((T,), bool)),
               jnp.asarray(tab_x), jnp.asarray(tab_y),
               jnp.asarray(fe.int_to_limbs(adv[0])), jnp.asarray(fe.int_to_limbs(adv[1])))
        hi, lo = st.trunc64_from_limbs(r.x_plus)
        qh.append(np.asarray(hi)), ql.append(np.asarray(lo))
        dg.append(np.asarray(r.degenerate)), ad.append(np.asarray(r.adv_degenerate))
        cx, cy = r.adv_x, r.adv_y
    # (K, T, U) -> rows t*K + s
    want_qhi = np.stack(qh, 1).reshape(T * K, U)
    want_qlo = np.stack(ql, 1).reshape(T * K, U)
    want_deg = np.stack(dg, 1).reshape(T * K, U)
    want_adv = np.stack(ad, 1)
    assert np.array_equal(res.degenerate.numpy(), want_deg)
    assert np.array_equal(res.adv_degenerate.numpy(), want_adv)
    assert want_deg[1 * K + 1, 4] and want_adv[2, 2]
    live = ~want_deg
    live[2 * K + 3:] = False  # past the P == -ADV step both walks are garbage
    assert np.array_equal(res.qhi.numpy().view(np.uint32)[live], want_qhi[live])
    assert np.array_equal(res.qlo.numpy().view(np.uint32)[live], want_qlo[live])
    for t in range(2):
        want = np.asarray(cx)[t]
        assert np.array_equal(res.next_x[t].numpy().view(np.uint32), want)


ADVK = 1000  # ADV = 1000*G in the chain tests
_WF = jax.jit(walk.walk_fused)


def _jax_chain(pts, adv, K):
    """The chain K1 replaces: K serial walk_fused steps from each start
    point, each step's advance lane feeding the next (T=3, U=16, as
    test_chunk_multi_matches_walk_fused). Returns x, y (K+1, T, 8) uint32
    of P + s*ADV and the (T, K) advance flags."""
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(5), 16)
    cx = jnp.asarray(np.stack([fe.int_to_limbs(p[0]) for p in pts]))
    cy = jnp.asarray(np.stack([fe.int_to_limbs(p[1]) for p in pts]))
    xs, ys, flags = [np.asarray(cx)], [np.asarray(cy)], []
    for _ in range(K):
        r = _WF(points.PointBatch(cx, cy, jnp.zeros((len(pts),), bool)),
                jnp.asarray(tab_x), jnp.asarray(tab_y),
                jnp.asarray(fe.int_to_limbs(adv[0])), jnp.asarray(fe.int_to_limbs(adv[1])))
        cx, cy = r.adv_x, r.adv_y
        xs.append(np.asarray(cx)), ys.append(np.asarray(cy))
        flags.append(np.asarray(r.adv_degenerate))
    return np.stack(xs), np.stack(ys), np.stack(flags, 1)


def _check_chain(ks, K):
    """advance_chain from P_t = ks[t]*G against ecref on every lane that is
    not infinity (lanes past a flag included; the flags are exactly the
    infinity lanes) and against the JAX chain up to each target's first
    flag: the same flags and points. Past it the JAX chain walks garbage
    (it flags again every other step); nothing downstream reads it."""
    adv = ecref.scalar_mult(ADVK)
    pts = [ecref.scalar_mult(k) for k in ks]
    px, py = _pts(pts)
    bx, by, nx, ny, adeg = pwalk.advance_chain(
        px.t().contiguous(), py.t().contiguous(), _limbs(adv[0]), _limbs(adv[1]), K)
    T = len(ks)
    assert bx.shape == (8, T * K) and nx.shape == (8, T) and adeg.shape == (T, K)
    # lane s = P_t + s*ADV: bases s < K, the next state at s = K
    gx = torch.cat([bx.reshape(8, T, K), nx[:, :, None]], 2).numpy().view(np.uint32)
    gy = torch.cat([by.reshape(8, T, K), ny[:, :, None]], 2).numpy().view(np.uint32)
    jx, jy, jflags = _jax_chain(pts, adv, K)
    for t in range(T):
        upto = int(np.argmax(jflags[t])) + 1 if jflags[t].any() else K
        assert np.array_equal(adeg[t, :upto].numpy(), jflags[t, :upto])
    for t in range(T):
        pt, chain_ok = pts[t], True
        for s in range(K + 1):
            if s:
                pt = ecref.point_add(pt, adv)
                assert bool(adeg[t, s - 1]) == (pt is None)
            if pt is None:
                chain_ok = False  # the JAX chain carries garbage from here
                continue
            got = (fe.limbs_to_int(gx[:, t, s]), fe.limbs_to_int(gy[:, t, s]))
            assert got == pt, (t, s)
            if chain_ok:
                assert np.array_equal(gx[:, t, s], jx[s, t]) and np.array_equal(gy[:, t, s], jy[s, t])
    return adeg


@pytest.mark.parametrize("form", ["point", "limbs"])
def test_adv_multiples_vs_ecref(form):
    K, advk = 9, 0xDEADBEEF
    adv = ecref.scalar_mult(advk)
    arg = adv if form == "point" else (_limbs(adv[0]), _limbs(adv[1]))
    tx, ty = pwalk.adv_multiples(arg, K, "cpu")
    assert tx.shape == ty.shape == (8, K) and tx.dtype == torch.int32
    for j in range(1, K + 1):
        want = ecref.scalar_mult(j * advk)
        assert fe.limbs_to_int(tx[:, j - 1].numpy().view(np.uint32)) == want[0]
        assert fe.limbs_to_int(ty[:, j - 1].numpy().view(np.uint32)) == want[1]


@pytest.mark.parametrize("j", [1, 2, 8, 16])
def test_advance_chain_doubling_lanes(j):
    """P == j*ADV makes lane j a doubling (j = K: the next state)."""
    adeg = _check_chain([j * ADVK, 0xBEEF01, 3 * ADVK + 1], K=16)
    assert not adeg.any()


@pytest.mark.parametrize("j", [1, 8, 16])
def test_advance_chain_infinity_lanes(j):
    """P == -j*ADV: lane j is the point at infinity, flagged at s = j - 1;
    the lanes after it are true points (the JAX chain's are garbage)."""
    adeg = _check_chain([0xBEEF02, ecref.N - j * ADVK, 5 * ADVK], K=16)
    assert adeg.nonzero().tolist() == [[1, j - 1]]


@pytest.mark.parametrize("K", [1, 7, 33])
def test_advance_chain_any_k(K):
    """K = 1, a K that is no power of two and one past a power of two, in
    the T = 3 column layout: a plain target, a doubling at lane 1 and the
    point at infinity in the next state."""
    adeg = _check_chain([0x123456789, ADVK, ecref.N - K * ADVK], K=K)
    assert adeg.nonzero().tolist() == [[2, K - 1]]


def test_advance_chain_takes_the_engine_table():
    """A table passed in gives what the built-in one gives; one of another
    length is refused."""
    K = 5
    adv = ecref.scalar_mult(ADVK)
    px, py = _pts([ecref.scalar_mult(77), ecref.scalar_mult(ADVK)])
    args = (px.t().contiguous(), py.t().contiguous(), _limbs(adv[0]), _limbs(adv[1]))
    got = pwalk.advance_chain(*args, K, pwalk.adv_multiples(adv, K, "cpu"))
    for g, w in zip(got, pwalk.advance_chain(*args, K)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        pwalk.advance_chain(*args, K, pwalk.adv_multiples(adv, K + 1, "cpu"))
