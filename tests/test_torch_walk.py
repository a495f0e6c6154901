"""The walker walk's field and curve pieces of the port against the JAX
package on the CPU: pinv.inv_batch (plain version) against fe.inv_mod_p
and fe_tiles.inv, fe.batch_inv_mod_p against the JAX batch_inv_mod_p
(zeros spoil their chain alike), and curve/walk.walk_fused (the plain
versions of walk_prefix, inv_batch and walk_emit) against walk.walk_fused,
symmetric with and without y, with C == ADV, C == -ADV and dx == 0 lanes
planted, plus its GLV variants and center lane against python ints. Inputs
come from numpy seeds; integer arithmetic, so the tolerance is exact
equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import points as jpoints  # noqa: E402
from keyhuntm1cpu_tpu.curve import walk as jwalk  # noqa: E402
from keyhuntm1cpu_tpu.field import fe as jfe  # noqa: E402
from keyhuntm1cpu_tpu.field import fe_tiles as ft  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import pwalk, tables, walk  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve.points import point_batch_from_ints  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe, pinv  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref  # noqa: E402

torch.set_num_threads(1)
P = fe.P_INT


def _vals(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _bm(vals):
    return np.stack([fe.int_to_limbs(v) for v in vals])  # (B, 8) uint32


def _i32(vals):  # (8, B) int32 limbs
    return torch.from_numpy(np.ascontiguousarray(_bm(vals).T).view(np.int32))


def _ints_lm(t):  # (8, ...) int limbs -> ints, column order
    arr = t.numpy().astype(np.int64).astype(np.uint32).reshape(8, -1)
    return [fe.limbs_to_int(arr[:, j]) for j in range(arr.shape[1])]


def test_inv_batch_matches_jax_with_zeros():
    vals = _vals(4, 37)
    vals[0] = vals[17] = vals[36] = 0
    vals[5], vals[9] = 1, P - 1
    got = pinv.inv_batch(_i32(vals))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 37)
    want = [pow(v, P - 2, P) for v in vals]
    assert _ints_lm(got) == want
    j_inv = np.asarray(jfe.inv_mod_p(jnp.asarray(_bm(vals))))
    assert np.array_equal(j_inv.T, got.numpy().view(np.uint32))
    tiles = jnp.asarray(_bm(vals).T.reshape(8, 1, len(vals)))
    assert np.array_equal(np.asarray(ft.inv(tiles)).reshape(8, -1),
                          got.numpy().view(np.uint32))
    with pytest.raises(ValueError):
        pinv.inv_batch(_i32(vals).to(torch.int64))


@pytest.mark.parametrize("n,chain_len,zero", [(40, 8, None), (37, 8, 13), (64, 32, None)])
def test_batch_inv_mod_p_matches_jax(n, chain_len, zero):
    vals = [v or 1 for v in _vals(5, n)]
    if zero is not None:
        vals[zero] = 0  # spoils its chain (elements i == zero mod C) in both
    want = np.asarray(jfe.batch_inv_mod_p(jnp.asarray(_bm(vals)), chain_len=chain_len))
    a = torch.from_numpy(np.ascontiguousarray(_bm(vals).T).astype(np.int64))
    got = fe.batch_inv_mod_p(a, chain_len=chain_len)
    assert np.array_equal(got.numpy().astype(np.uint32), want.T)
    if zero is None:
        assert _ints_lm(got) == [pow(v, P - 2, P) for v in vals]


U, L = 8, 8
STRIDE = 3
ADV_K = (2 * U + 1) * STRIDE
# centers: plain, C == ADV (the doubling lane), C == -ADV (flagged), and
# C == +-5S, -2S (dx == 0 at those lanes), then two more plain ones
CENTER_KEYS = [1000, ADV_K, ecref.N - ADV_K, STRIDE * 5, ecref.N - STRIDE * 2, 77777,
               123456789]


@pytest.fixture(scope="module")
def walk_inputs():
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(STRIDE), U)
    adv = ecref.scalar_mult(ADV_K)
    centers = [ecref.scalar_mult(k) for k in CENTER_KEYS]
    port = (point_batch_from_ints(centers), pwalk.table_to_limb_major(tab_x, "cpu"),
            pwalk.table_to_limb_major(tab_y, "cpu"), _i32([adv[0]])[:, 0].contiguous(),
            _i32([adv[1]])[:, 0].contiguous())
    jax_in = (jpoints.point_batch_from_ints(centers), jnp.asarray(tab_x), jnp.asarray(tab_y),
              jfe.from_int(adv[0]), jfe.from_int(adv[1]))
    return port, jax_in, centers


def _bm_u32(t):  # (8, W, U) or (8, W) int32 -> (W, U, 8) / (W, 8) uint32
    return np.moveaxis(t.numpy().view(np.uint32), 0, -1)


@pytest.mark.parametrize("need_y", [False, True])
def test_walk_fused_matches_jax(walk_inputs, need_y):
    port, jax_in, _ = walk_inputs
    # jitted, so the compile lands in the tests' persistent cache
    fn = jax.jit(jwalk.walk_fused, static_argnames=("symmetric", "need_y", "chain_len"))
    want = fn(*jax_in, symmetric=True, need_y=need_y, chain_len=L)
    got = walk.walk_fused(*port, need_y=need_y, chain_len=L)
    names = ["x_plus", "x_minus", "adv_x", "adv_y"] + (["y_plus", "y_minus"] if need_y else [])
    for name in names:
        assert np.array_equal(_bm_u32(getattr(got, name)), np.asarray(getattr(want, name))), name
    assert np.array_equal(got.degenerate.numpy(), np.asarray(want.degenerate))
    assert np.array_equal(got.adv_degenerate.numpy(), np.asarray(want.adv_degenerate))
    assert (got.y_plus is None) == (not need_y)
    # the planted edges: C == -ADV flagged (C == ADV doubled), dx == 0 lanes
    assert got.adv_degenerate.tolist() == [False, False, True, False, False, False, False]
    assert np.nonzero(got.degenerate.numpy())[0].tolist() == [3, 4]
    assert np.nonzero(got.degenerate.numpy())[1].tolist() == [4, 1]


def test_walk_fused_variants_center_and_one_sided(walk_inputs):
    port, _, centers = walk_inputs
    got = walk.walk_fused(*port, need_y=True, chain_len=L, n_endo=3)
    W, npts = len(centers), 2 * U + 1
    assert tuple(got.x_all.shape) == (3, 8, W, npts) and tuple(got.y_all.shape) == (8, W, npts)
    x = _ints_lm(got.x_all[0])
    for e in (1, 2):
        beta = pow(ecref.BETA, e, P)
        assert _ints_lm(got.x_all[e]) == [v * beta % P for v in x]
    for w, c in enumerate(centers):  # the last lane is the center itself
        assert x[w * npts + npts - 1] == c[0]
        assert _ints_lm(got.y_all)[w * npts + npts - 1] == c[1]
        if w in (0, 5):  # a plain walker: lane u is C + (u+1)S, lane U + u is C - (u+1)S
            k = CENTER_KEYS[w]
            assert x[w * npts + 2] == ecref.scalar_mult(k + 3 * STRIDE)[0]
            assert x[w * npts + U + 2] == ecref.scalar_mult(k - 3 * STRIDE)[0]
    no_y = walk.walk_fused(*port, need_y=False, chain_len=L)
    assert no_y.y_all is None and tuple(no_y.x_all.shape) == (1, 8, W, npts)
    assert torch.equal(no_y.x_all[0], got.x_all[0]) and torch.equal(no_y.adv_x, got.adv_x)
    with pytest.raises(ValueError):
        walk.walk_fused(port[0], port[1][:, :3].contiguous(), *port[2:], chain_len=L)
