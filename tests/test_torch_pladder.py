"""The scalar-mult ladder of the port (keyhuntm1cpu_tpu_torch/curve/pladder.py)
against the JAX package on the CPU: scalar_mult_ref against
points.scalar_mult_batch_jac (the JAX engine's CPU ladder, the same
(points, irregular) contract as pladder.scalar_mult_tiles) on x, y, inf and
irregular, edge scalars included, and the regular lanes against ecref;
scalar_mult_split_ref (K6's own order: 2, 4 or 8 lanes per scalar, merged
by Jacobian adds) against both and ecref on the lanes it leaves unflagged.
Exact equality. The CUDA kernel K6 is held to scalar_mult_split_ref on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import points, tables as jtables  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import pladder, tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref  # noqa: E402

torch.set_num_threads(1)
N = ecref.N
EDGES = [0, 1, 2, N - 1, N, 2 ** 256 - 1,
         # zero bytes in several windows, among them the first and the last
         0x00FF00000000FF000000000000AB0000000000CD0000000000000000000100,
         # past N: N + 1 is G again, 2N and 2N - 1 wrap mod 2^256
         N + 1, (2 * N) % 2 ** 256, (2 * N - 1) % 2 ** 256]


def _scalars():
    rng = np.random.default_rng(2024)
    return EDGES + [int.from_bytes(rng.bytes(32), "big") for _ in range(256)]


def test_gtable_matches_jax():
    for got, want in zip(tables.gtable_np(), jtables.gtable_np()):
        np.testing.assert_array_equal(got, want)


def test_scalar_mult_ref_matches_jax_and_ecref():
    ks = _scalars()
    k_bm = np.stack([fe.int_to_limbs(k) for k in ks])  # (V, 8)
    gtx, gty = pladder.gtable_tensors("cpu")
    x, y, inf, irr = pladder.scalar_mult_tiles(
        torch.from_numpy(k_bm.T.copy().view(np.int32)), gtx, gty)
    gx, gy = (jnp.asarray(t) for t in jtables.gtable_np())
    pub, jirr = jax.jit(points.scalar_mult_batch_jac)(jnp.asarray(k_bm), gx, gy)
    np.testing.assert_array_equal(x.numpy().view(np.uint32).T, np.asarray(pub.x))
    np.testing.assert_array_equal(y.numpy().view(np.uint32).T, np.asarray(pub.y))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(pub.inf))
    np.testing.assert_array_equal(irr.numpy(), np.asarray(jirr))
    assert inf.numpy().tolist()[:3] == [True, False, False]
    assert irr[EDGES.index(N)]  # k = N cancels in the last window
    xs, ys = x.numpy().view(np.uint32), y.numpy().view(np.uint32)
    for j, k in enumerate(ks):
        if inf[j] or irr[j]:
            continue
        assert (fe.limbs_to_int(xs[:, j]), fe.limbs_to_int(ys[:, j])) == ecref.scalar_mult(k % N)


def test_scalar_mult_refuses_bad_inputs():
    gtx, gty = pladder.gtable_tensors("cpu")
    with pytest.raises(ValueError):
        pladder.scalar_mult_tiles(torch.zeros((8, 4), dtype=torch.int64), gtx, gty)
    with pytest.raises(ValueError):
        pladder.scalar_mult_tiles(torch.zeros((8, 4), dtype=torch.int32), gtx[:31], gty)


@pytest.fixture(scope="module")
def sequential():
    """The scalars, their limbs, scalar_mult_ref's and the JAX ladder's
    outputs (numpy) and ecref's k*G."""
    ks = _scalars()
    k_bm = np.stack([fe.int_to_limbs(k) for k in ks])
    k = torch.from_numpy(k_bm.T.copy().view(np.int32))
    gtx, gty = pladder.gtable_tensors("cpu")
    ref = [t.numpy() for t in pladder.scalar_mult_ref(k, gtx, gty)]
    gx, gy = (jnp.asarray(t) for t in jtables.gtable_np())
    pub, jirr = jax.jit(points.scalar_mult_batch_jac)(jnp.asarray(k_bm), gx, gy)
    jax_out = [np.asarray(pub.x).T, np.asarray(pub.y).T, np.asarray(pub.inf), np.asarray(jirr)]
    return ks, k, ref, jax_out, [ecref.scalar_mult(v % N) for v in ks]


def test_scalar_mult_split_ref_one_lane_is_the_sequential_ladder(sequential):
    _, k, ref, _, _ = sequential
    got = pladder.scalar_mult_split_ref(k, *pladder.gtable_tensors("cpu"), 1)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("split", [2, 4, 8])
def test_scalar_mult_split_ref_contract(sequential, split):
    ks, k, ref, jax_out, want = sequential
    x, y, inf, irr = (t.numpy() for t in pladder.scalar_mult_split_ref(
        k, *pladder.gtable_tensors("cpu"), split))
    np.testing.assert_array_equal(inf, ref[2])  # k == 0 exactly, as the ladder
    np.testing.assert_array_equal(inf, jax_out[2])
    assert inf[EDGES.index(0)]
    assert np.flatnonzero(irr).tolist() == [EDGES.index(N)]  # k = N alone cancels
    xs, ys = x.view(np.uint32), y.view(np.uint32)
    for other in (ref, jax_out):  # lanes neither flags: bit for bit
        both = ~irr & ~other[3].astype(bool)
        np.testing.assert_array_equal(xs[:, both], other[0].view(np.uint32)[:, both])
        np.testing.assert_array_equal(ys[:, both], other[1].view(np.uint32)[:, both])
    for j, pt in enumerate(want):  # every lane it leaves unflagged is k*G
        if irr[j]:
            continue
        got = None if inf[j] else (fe.limbs_to_int(xs[:, j]), fe.limbs_to_int(ys[:, j]))
        assert got == pt, hex(ks[j])
