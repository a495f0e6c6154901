"""The port's walker chunk (keyhuntm1cpu_tpu_torch/engine/brute.py
_walker_chunk, through the plain versions of its kernels) against the JAX
package's _brute_chunk_impl, word for word over the (K, 2C + 3W + 1)
summary and the next centers, in every mode: from centers with C == ADV
(the doubling lane) and C == -ADV (the flag, then garbage centers), with
dx == 0 lanes at C == 20G and C == -5G, and from the engine's own first
centers on a range that ends at N. The shapes are tests/test_brute.py's
(W = 2, U = 64, K = 2, chain_len = 8, keys 1..32 as targets), so the JAX
compiles are shared. Integer arithmetic: the tolerance is exact
equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.engine import brute as jbrute  # noqa: E402
from keyhuntm1cpu_tpu.utils.targets import targets_from_ints  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve.points import point_batch_from_ints  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402

torch.set_num_threads(1)
JPARAMS = jbrute.BruteParams(walkers=2, block_u=64, steps_per_chunk=2, chain_len=8,
                             pallas="off")
ARTIFACT = {
    "rmd160": lambda pt: hashref.pubkey_to_hash160(pt, compressed=True),
    "xpoint": lambda pt: pt[0].to_bytes(32, "big"),
    "eth": hashref.pubkey_to_eth_address,
    "address_u": lambda pt: hashref.pubkey_to_hash160(pt, compressed=False),
    "rmd160_both": lambda pt: hashref.pubkey_to_hash160(pt, compressed=False),
}
KIND = {"xpoint": "xpoint", "eth": "eth"}
ADV_K = 2 * 64 + 1  # ADV = (2U + 1) * stride * G


def engines(mode, keys, a, b, jparams=JPARAMS):
    """(JAX engine, port engine) over the same targets, range and params."""
    jts = targets_from_ints(KIND.get(mode, "hash160"),
                            [ARTIFACT[mode](ecref.scalar_mult(k)) for k in keys])
    jeng = jbrute.BruteEngine(jts, a, b, mode=mode, params=jparams)
    eng = BruteEngine(convert.targets_from_jax(jts), a, b, mode=mode,
                      params=convert.brute_params_from_jax(jparams), device="cpu")
    assert eng._walker and not jeng._fast
    return jeng, eng


def _jax_pts(pts):
    limbs = [[(p[c] >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for p in pts for c in (0, 1)]
    arr = np.array(limbs, dtype=np.uint32).reshape(len(pts), 2, 8)
    return jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1])


def assert_chunks_equal(jeng, eng, pts, chunks=1):
    """Run `chunks` chained chunks from centers pts on both engines."""
    jx, jy = _jax_pts(pts)
    c = point_batch_from_ints(pts)
    cx, cy = c.x, c.y
    outs = []
    for _ in range(chunks):
        jx, jy, want = jeng._chunk_fn(jx, jy)
        cx, cy, got = eng._walker_chunk(cx, cy)
        assert np.array_equal(got.numpy(), np.asarray(want).view(np.int32))
        assert np.array_equal(cx.numpy().view(np.uint32).T, np.asarray(jx))
        assert np.array_equal(cy.numpy().view(np.uint32).T, np.asarray(jy))
        outs.append(got.numpy())
    return outs


@pytest.mark.parametrize("mode", list(ARTIFACT))
def test_walker_chunk_summary_matches_jax(mode):
    jeng, eng = engines(mode, list(range(1, 33)), 1, 4096)
    C, W = 256, 2
    # walker 0 at ADV (doubling), walker 1 at 20G: keys 1..32 in its window,
    # dx == 0 at u = 20 (C - 20G is infinity)
    (got,) = assert_chunks_equal(jeng, eng, [ecref.scalar_mult(ADV_K), ecref.scalar_mult(20)])
    assert (got[0, :C] < eng.n_qsets * W * eng.window).sum() >= 32  # the planted keys
    assert got[0, 2 * C + 1] == 1 and got[0, 2 * C + W + 1] == 19  # walker 1: u = 20
    # walker 0 at -ADV (flagged; its next center is garbage), walker 1 at -5G
    (got,) = assert_chunks_equal(jeng, eng, [ecref.scalar_mult(ecref.N - ADV_K),
                                             ecref.scalar_mult(ecref.N - 5)])
    assert got[0, 2 * C + 2 * W] == 1 and got[0, 2 * C + W + 1] == 4


def test_walker_chunks_at_the_end_of_the_range():
    """A range ending at N: walker 0's first center is N - 5 (dx == 0 at
    u = 5), walker 1's lies past N (reduced mod N, as in the JAX engine)."""
    a = ecref.N - 69
    jeng, eng = engines("rmd160", [ecref.N - 3, ecref.N - 60] + list(range(1, 31)), a, ecref.N)
    bases = eng._sequential_bases(0)
    assert bases == jeng._sequential_bases(0)
    pts = [ecref.scalar_mult(a + (b + 64)) for b in bases]
    assert pts[0] == ecref.scalar_mult(ecref.N - 5)
    c = eng._centers_for_bases(bases)
    assert np.array_equal(c.x.numpy().view(np.uint32).T,
                          np.asarray(jeng._centers_for_bases(bases).x))
    outs = assert_chunks_equal(jeng, eng, pts, chunks=2)
    assert outs[0][0, 2 * 256] == 1 and outs[0][0, 2 * 256 + 2] == 4  # u = 5
    assert (outs[0][:, :256] < eng.n_qsets * 2 * eng.window).sum() >= 2
