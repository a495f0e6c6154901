"""Port BSGS past T = 128 targets (keyhuntm1cpu_tpu_torch/engine/bsgs.py)
vs the JAX engine, in both resolve modes, on the CPU at tests/test_bsgs.py's
shapes (m = 512, U = 16, K = 4): T = 129 and T = 1024 targets, a few of
them with keys in the range (one on a giant-step center, which the walk
flags as a degenerate lane, and one in the second chunk), the rest with
keys outside it. The found keys equal the JAX engine's, each reported for
its own target: the decode's target index t = block // K, the initial and
the scheduled bases (search_scheduled, random order) keep every row's
target.

Integer arithmetic: the tolerance is exact equality."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.engine import bsgs as jbsgs  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import host_table as ht  # noqa: E402

torch.set_num_threads(1)
JPARAMS = jbsgs.BSGSParams(m=512, block_u=16, steps_per_chunk=4, build_block=128, chain_len=8)
A, B = 0xA00000, 0xA20000  # two chunks of K*U*2m keys


def _center(step, u):
    return A + JPARAMS.m + (step * JPARAMS.block_u + u - 1) * 2 * JPARAMS.m


def _targets(T):
    """{t: key in [A, B)} for a few t, the others' keys far outside."""
    planted = {0: 0xA01234, T // 2: _center(1, 5), T - 1: 0xA1FEDC}
    keys = [planted.get(t, (1 << 200) + 7919 * t) for t in range(T)]
    return [ecref.scalar_mult(k) for k in keys], planted


@pytest.fixture(scope="module")
def jax_found():
    """The JAX engine's found keys per T (search_scheduled, random order)."""
    table = jbsgs.host_baby_table(JPARAMS.m)
    out = {}
    for T in (129, 1024):
        pubs, _ = _targets(T)
        eng = jbsgs.BSGSEngine(pubs, A, B, JPARAMS, table=table)
        out[T] = sorted((f.private_key, f.target)
                        for f in eng.search_scheduled("random", seed=5, stop_on_first=False))
    return out


@pytest.mark.parametrize("resolve", ["device", "host"])
@pytest.mark.parametrize("T", [129, 1024])
def test_multitarget_found_keys_match_jax(jax_found, tmp_path, T, resolve):
    pubs, planted = _targets(T)
    params = dataclasses.replace(convert.params_from_jax(JPARAMS), resolve=resolve)
    eng = bsgs.BSGSEngine(pubs, A, B, params, device="cpu",
                          host_table=(ht.ensure_host_table(params.m, str(tmp_path))
                                      if resolve == "host" else None))
    assert eng.p.steps_per_chunk == 4  # T*K*U far under the chunk cap
    # the scheduled bases keep every target's row: equal to _initial_base
    got = eng._scheduled_bases([1])[1]
    want = eng._initial_base(4)
    assert got[0].shape == (T, 8) and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    found = eng.search_scheduled("random", seed=5, stop_on_first=False)
    assert sorted((f.private_key, f.target) for f in found) == jax_found[T]
    by_key = {f.private_key: f for f in found}
    assert sorted(by_key) == sorted(planted.values())
    for t, k in planted.items():
        assert by_key[k].pubkey == pubs[t] and by_key[k].target == f"{pubs[t][0]:064x}"
    assert eng.stats.keys_covered == 2 * 4 * 16 * 2 * JPARAMS.m
