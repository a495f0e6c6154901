"""Port field arithmetic (keyhuntm1cpu_tpu_torch/field/fe.py) vs the JAX
package's limb-major tile ops (field/fe_tiles.py under plain XLA) and
python ints. Integer arithmetic: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.field import fe_tiles as ft  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe  # noqa: E402

torch.set_num_threads(1)
P = fe.P_INT
EDGES = [0, 1, 2, P - 1, P - 2, P - 977, P - (1 << 32), (1 << 256) - 1 - P,
         (1 << 32) - 1, ((1 << 32) - 1) * sum(1 << (32 * i) for i in range(7))]


def _values(seed, n=40):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    return vals + [v % P for v in EDGES]


def _torch(vals):
    arr = np.stack([fe.int_to_limbs(v) for v in vals])  # (B, 8)
    return torch.from_numpy(fe.to_tiles(arr).astype(np.int64))


def _jax(vals):
    arr = np.stack([fe.int_to_limbs(v) for v in vals])
    return jnp.asarray(arr.T.reshape(8, 1, len(vals)))


def _ints(t):
    return [fe.limbs_to_int(r) for r in fe.from_tiles(np.asarray(t))]


A = _values(1)
B = list(reversed(_values(2)))


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "dbl", "neg"])
def test_op_matches_fe_tiles_and_ints(op):
    want = {
        "mul": [a * b % P for a, b in zip(A, B)],
        "sqr": [a * a % P for a in A],
        "add": [(a + b) % P for a, b in zip(A, B)],
        "sub": [(a - b) % P for a, b in zip(A, B)],
        "dbl": [2 * a % P for a in A],
        "neg": [(-a) % P for a in A],
    }[op]
    unary = op in ("sqr", "dbl", "neg")
    args_t = (_torch(A),) if unary else (_torch(A), _torch(B))
    args_j = (_jax(A),) if unary else (_jax(A), _jax(B))
    got = _ints(getattr(fe, op)(*args_t))
    assert got == want
    assert got == _ints(getattr(ft, op)(*args_j))


def test_inv_and_montgomery_groups():
    vals = _values(3, n=29)[:32]
    vals = [v if v else 1 for v in vals]
    want = [pow(v, P - 2, P) for v in vals]
    assert _ints(fe.inv(_torch(vals))) == want
    assert _ints(fe.inv(_torch([0]))) == [0]
    grid = _torch(vals).reshape(8, 4, 8)  # 4 groups of 8 along dim 1
    got = fe.montgomery_inv_groups(grid, n_groups=4)
    assert _ints(got) == want
    assert _ints(got) == _ints(ft.montgomery_inv_groups(
        jnp.asarray(grid.numpy().astype(np.uint32)), n_groups=4))


def test_predicates_select_and_layout():
    ta, tz = _torch(A), torch.zeros(8, len(A), dtype=torch.int64)
    assert fe.is_zero(tz).all() and not fe.is_zero(ta)[: len(A) - len(EDGES)].any()
    assert fe.eq(ta, ta).all()
    assert _ints(fe.select(fe.is_zero(tz), ta, tz)) == A
    assert _ints(fe.one_like(ta)) == [1] * len(A)
    bm = np.stack([fe.int_to_limbs(v) for v in A])
    assert np.array_equal(fe.from_tiles(fe.to_tiles(bm)), bm)
    assert np.array_equal(fe.to_tiles(bm), np.asarray(ft.to_tiles(jnp.asarray(bm), lanes=len(A))).reshape(8, -1))
    u = torch.tensor([0, 1, 2**31, 2**32 - 1], dtype=torch.int64)
    assert torch.equal(fe.u32(fe.i32(u)), u)
