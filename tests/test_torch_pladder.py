"""The scalar-mult ladder of the port (keyhuntm1cpu_tpu_torch/curve/pladder.py)
against the JAX package on the CPU: scalar_mult_ref against
points.scalar_mult_batch_jac (the JAX engine's CPU ladder, the same
(points, irregular) contract as pladder.scalar_mult_tiles) on x, y, inf and
irregular, edge scalars included, and the regular lanes against ecref.
Exact equality. The CUDA kernel K6 is held to scalar_mult_ref on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

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
