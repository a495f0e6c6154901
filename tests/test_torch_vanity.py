"""Vanity prefixes in the port (keyhuntm1cpu_tpu_torch/engine/vanity.py and
BruteEngine(intervals=, prefixes=)) against the JAX package, on the CPU:

- vanity_intervals and _h160_to_words_be equal the JAX functions, and the
  same prefixes raise;
- the fused chunk's packed summary with real intervals beside point
  targets equals pbrute.xla_brute_chunk's word for word (rmd160,
  address_u);
- the engine finds the same keys as the JAX VanityEngine, alone and
  composed with exact targets; intervals past the compare budget, beside
  more than bucket_max targets or with an untiled U raise;
- the one-scalar-mult host check and the K6 batch (its plain version
  here) agree with ecref and with the JAX engine's two-scalar-mult check.

Integer arithmetic: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import pbrute as jpbrute  # noqa: E402
from keyhuntm1cpu_tpu.engine import vanity as jvanity  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import pbrute, pladder, pwalk, tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import vanity  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402

torch.set_num_threads(1)
K, U, C = 4, 256, 64  # tests/test_torch_pbrute.py's chunk shape
B0 = 10
EMPTY = TargetSet(kind="hash160", raw=[], labels=[])


def _addr(k, compressed=True):
    return hashref.pubkey_to_address(ecref.scalar_mult(k), compressed)


def _ivs(prefixes):
    return [iv for p in prefixes for iv in vanity.vanity_intervals(p)]


def _h160_targets(keys):
    return TargetSet(kind="hash160", labels=[str(k) for k in keys],
                     raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(k)) for k in keys])


@pytest.mark.parametrize("prefix", ["1", "1BgG", "1Bh", "14myH", "1BgGZ9tcN4", "1zzzzzzzzzz",
                                    "1" + "z" * 30])
def test_vanity_intervals_match_jax(prefix):
    got = vanity.vanity_intervals(prefix)
    assert got == jvanity.vanity_intervals(prefix)
    for lo, hi in got:
        assert np.array_equal(vanity._h160_to_words_be(lo), jvanity._h160_to_words_be(lo))
        assert np.array_equal(vanity._h160_to_words_be(hi), jvanity._h160_to_words_be(hi))
    if prefix in ("1BgG", "1BgGZ9tcN4", "1Bh"):
        h = hashref.pubkey_to_hash160(ecref.G)  # key 1: 1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH
        assert any(lo <= h <= hi for lo, hi in got) == (prefix != "1Bh")


@pytest.mark.parametrize("prefix", ["3abc", "bc1q", "1" * 35, "1z" * 20])
def test_vanity_intervals_refuse_like_jax(prefix):
    with pytest.raises(ValueError):
        jvanity.vanity_intervals(prefix)
    with pytest.raises(ValueError):
        vanity.vanity_intervals(prefix)


def _i32(v):
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())


@pytest.mark.parametrize("mode", ["rmd160", "address_u"])
def test_fused_summary_with_real_intervals_matches_xla(mode):
    """Point targets (keys at steps 0 and 3) beside the intervals of two
    prefixes (a key at step 1, and one at step 2 for the other form)."""
    compressed = mode == "rmd160"
    tab_x, tab_y = tables.step_table(ecref.G, U)
    adv, base = ecref.scalar_mult(U), ecref.scalar_mult(B0)
    keys = [B0 + 1, B0 + 3 * U + 256]
    vals = [int.from_bytes(hashref.pubkey_to_hash160(ecref.scalar_mult(k), compressed)[:8],
                           "big") for k in keys]
    ivs = _ivs([_addr(B0 + U + 77, compressed)[:6], _addr(B0 + 2 * U + 5, compressed)[:5]])
    lo = vals + [int.from_bytes(a[:8], "big") for a, _ in ivs]
    hi = vals + [int.from_bytes(b[:8], "big") for _, b in ivs]
    assert any(a < b for a, b in zip(lo, hi))  # real ranges
    tgt = pbrute.pack_intervals(lo, hi)
    _, _, want = jpbrute.xla_brute_chunk(
        jnp.asarray(fe.int_to_limbs(base[0])), jnp.asarray(fe.int_to_limbs(base[1])),
        jnp.asarray(tab_x), jnp.asarray(tab_y), jnp.asarray(fe.int_to_limbs(adv[0])),
        jnp.asarray(fe.int_to_limbs(adv[1])), jnp.asarray(tgt),
        K=K, U=U, C=C, mode=mode, n_endo=1)
    _, _, got = pbrute.brute_chunk(
        _i32(base[0]), _i32(base[1]), pwalk.table_to_limb_major(tab_x, "cpu"),
        pwalk.table_to_limb_major(tab_y, "cpu"), _i32(adv[0]), _i32(adv[1]),
        torch.from_numpy(tgt.view(np.int32)), torch.zeros((8, 128), dtype=torch.int32),
        K=K, U=U, C=C, mode=mode, n_endo=1)
    want = np.asarray(want)
    assert got.numpy().tolist() == want.tolist()
    pos = set(want[:C][want[:C] < K * U].tolist())
    assert {0, 3 * U + 255, U + 76, 2 * U + 4} <= pos  # every planted hit


def test_engine_vanity_matches_jax_vanity_engine():
    """Key 41's 6-character prefix over [1, 512) (tests/test_minikeys_vanity.py)."""
    prefix = _addr(41)[:6]
    jeng = jvanity.VanityEngine([prefix], 1, 512, params=jvanity.VanityParams(
        walkers=2, block_u=32, steps_per_chunk=2, chain_len=8))
    want = sorted(f.private_key for f in jeng.search())
    eng = BruteEngine(EMPTY, 1, 512, mode="rmd160", device="cpu",
                      params=BruteParams(block_u=128, steps_per_chunk=2),
                      intervals=vanity.vanity_intervals(prefix), prefixes=[prefix])
    found = eng.search()
    assert 41 in want and sorted(f.private_key for f in found) == want
    assert all(f.target.startswith(prefix) and f.target == _addr(f.private_key)
               for f in found)


def test_vanity_composed_with_exact_targets_finds_both():
    prefix = _addr(700)[:6]
    eng = BruteEngine(_h160_targets([100, 900]), 1, 1025, mode="rmd160", device="cpu",
                      params=BruteParams(block_u=128, steps_per_chunk=2),
                      intervals=vanity.vanity_intervals(prefix), prefixes=[prefix])
    assert not eng._walker and not eng._bucketed
    found = {f.private_key: f.target for f in eng.search()}
    assert found[100] == "100" and found[900] == "900" and found[700] == _addr(700)


def test_interval_path_decision_and_refusals():
    ivs = _ivs(["1BgG"])
    # intervals beside a set past compare_max: bucketed, intervals in the compare
    eng = BruteEngine(_h160_targets([5, 6, 7]), 1, 1025, mode="rmd160", device="cpu",
                      params=BruteParams(block_u=128, compare_max=10), intervals=ivs)
    assert eng._bucketed and eng._tgt.shape[1] == 16
    with pytest.raises(ValueError):  # past bucket_max (the JAX engine's 65,536)
        BruteEngine(_h160_targets([5]), 1, 1025, mode="rmd160", device="cpu",
                    params=BruteParams(block_u=128, compare_max=0, bucket_max=0),
                    intervals=ivs)
    big = TargetSet(kind="hash160", raw=[i.to_bytes(20, "big") for i in range(65537)],
                    labels=["d"] * 65537)
    with pytest.raises(ValueError):
        BruteEngine(big, 1, 1025, mode="rmd160", device="cpu", intervals=ivs)
    with pytest.raises(ValueError):  # an untiled U has no interval path
        BruteEngine(EMPTY, 1, 1025, mode="rmd160", device="cpu",
                    params=BruteParams(block_u=100), intervals=ivs)
    with pytest.raises(ValueError):  # intervals past the compare budget
        BruteEngine(EMPTY, 1, 1025, mode="rmd160", device="cpu",
                    params=BruteParams(block_u=128, compare_max=8), intervals=ivs)
    with pytest.raises(ValueError, match="no targets"):
        BruteEngine(EMPTY, 1, 1025, mode="rmd160", device="cpu")


@pytest.mark.parametrize("mode", ["rmd160", "address_u", "rmd160_both"])
def test_one_scalar_mult_check_matches_jax_check(mode):
    """_verify checks k and N - k with one scalar mult; the JAX engine's
    _verify (two) gives the same key, form and label, for exact targets
    and prefixes, when either of the two matches."""
    from keyhuntm1cpu_tpu.engine.brute import BruteEngine as JBrute

    keys = [1234, ecref.N - 777]
    ts = _h160_targets([1234]) if mode != "address_u" else TargetSet(
        kind="hash160", labels=["1234"],
        raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(1234), False)])
    prefixes = [_addr(ecref.N - 777, mode == "rmd160")[:7]]
    eng = BruteEngine(ts, 1, 1025, mode=mode, device="cpu", intervals=_ivs(prefixes),
                      prefixes=prefixes, params=BruteParams(block_u=128))
    jeng = JBrute.__new__(JBrute)
    jeng.mode, jeng.targets, jeng.prefixes = eng.mode, ts, prefixes
    jeng._raw_index = eng._raw_index
    for k in keys + [ecref.N - 1234, 777, 5, 0, ecref.N]:
        got, want = eng._verify(k), jeng._verify(k, 0)
        assert (got is None) == (want is None), k
        if got is not None:
            assert (got.private_key, got.compressed, got.target, got.pubkey) == (
                want.private_key, want.compressed, want.target, want.pubkey)
    pts = pladder.scalar_mult_points([k % ecref.N for k in keys], *pladder.gtable_tensors("cpu"))
    for k, pt in zip(keys, pts):
        assert pt == ecref.scalar_mult(k)
        assert eng._verify(k, 0, pt) == eng._verify(k)


def test_scalar_mult_points_matches_ecref_on_edge_scalars():
    ks = [0, 1, 2, ecref.N - 1, ecref.N, ecref.N + 5, 255, 256, 1 << 255, 0xFF00FF]
    got = pladder.scalar_mult_points(ks, *pladder.gtable_tensors("cpu"))
    assert got == [ecref.scalar_mult(k) if k % ecref.N else None for k in ks]
