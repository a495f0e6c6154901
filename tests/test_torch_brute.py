"""The port's BruteEngine (keyhuntm1cpu_tpu_torch/engine/brute.py) on the
CPU, through the plain versions of its kernels: keys 1..32 recovered in
every mode, the -e lambda*k keys, a stride scan, random order with
seq_per_base, the engine's refusals and path choice, and its found set
against the JAX package's BruteEngine (its CPU XLA path) over the same
range. Found keys
are compared exactly."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.engine import brute as jbrute  # noqa: E402
from keyhuntm1cpu_tpu.utils.targets import TargetSet as JTargetSet  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402

torch.set_num_threads(1)
PARAMS = BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64)
ARTIFACT = {
    "rmd160": lambda pt: hashref.pubkey_to_hash160(pt, compressed=True),
    "xpoint": lambda pt: pt[0].to_bytes(32, "big"),
    "eth": hashref.pubkey_to_eth_address,
    "address_u": lambda pt: hashref.pubkey_to_hash160(pt, compressed=False),
    "rmd160_both": lambda pt: hashref.pubkey_to_hash160(pt, compressed=False),
}
KIND = {"xpoint": "xpoint", "eth": "eth"}


def _targets(mode, keys, cls=TargetSet):
    raw = [ARTIFACT[mode](ecref.scalar_mult(k)) for k in keys]
    return cls(kind=KIND.get(mode, "hash160"), raw=raw, labels=[str(k) for k in keys])


@pytest.mark.parametrize("mode", list(ARTIFACT))
def test_recover_keys_1_to_32(mode):
    keys = list(range(1, 33))
    eng = BruteEngine(_targets(mode, keys), 1, 1025, mode=mode, params=PARAMS,
                      device="cpu")
    assert eng._fast_prefix == [1]  # base(0) would be infinity: key 1 on the host
    assert sorted(f.private_key for f in eng.search()) == keys
    assert eng.stats.keys_covered == 1024  # whole steps of U keys
    assert eng.stats.multiplier == {"rmd160": 2, "rmd160_both": 3}.get(mode, 1)


@pytest.mark.parametrize("mode", ["rmd160", "xpoint"])
def test_endomorphism_finds_lambda_keys(mode):
    ks = [5, 600]
    lam_keys = [ecref.LAMBDA * k % ecref.N for k in ks]
    lam2_key = ecref.LAMBDA * ecref.LAMBDA * 900 % ecref.N
    ts = _targets(mode, lam_keys + [lam2_key])
    p = BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64, endo=True)
    eng = BruteEngine(ts, 2, 1026, mode=mode, params=p, device="cpu")
    assert eng.stats.multiplier == (6 if mode == "rmd160" else 3)
    found = sorted(f.private_key for f in eng.search())
    assert found == sorted(lam_keys + [lam2_key])
    plain = BruteEngine(ts, 2, 1026, mode=mode, params=PARAMS, device="cpu")
    assert plain.search() == []  # without -e those keys are out of reach


def test_stride_scan():
    stride, a = 7, 1000
    keys = [a + 7 * 3, a + 7 * 500, a + 7 * 1023]
    p = BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64, stride=stride)
    eng = BruteEngine(_targets("rmd160", keys + [a + 7 * 200 + 1]), a, a + 7 * 1024,
                      mode="rmd160", params=p, device="cpu")
    assert sorted(f.private_key for f in eng.search()) == keys  # off-stride key skipped


def test_random_mode_seq_per_base_follows_its_schedule():
    K, U, seed = 2, 256, 3
    a, b = 1000, 1000 + 6 * K * U  # 12 steps, 6 chunks
    keys = [a + 10, a + 3 * U + 5, a + 7 * U + 100, a + 11 * U + 255]
    p = BruteParams(block_u=U, steps_per_chunk=K, chunk_cand=64, random_mode=True,
                    seed=seed, seq_per_base=2 * K * U)
    eng = BruteEngine(_targets("eth", keys), a, b, mode="eth", params=p, device="cpu")
    found = sorted(f.private_key for f in eng.search())
    # the schedule: one draw per group of 2 chunks, a fresh draw past the end
    rng = np.random.default_rng(seed)
    steps, left, s_next = set(), 0, 0
    for _ in range(math.ceil(12 / K)):
        if left <= 0 or s_next + K > 12:
            s0, left = int(rng.integers(0, 12 - K + 1)), 2
        else:
            s0 = s_next
        left -= 1
        s_next = s0 + K
        steps.update(range(s0, s0 + K))
    assert found == [k for k in keys if (k - a) // U in steps]
    assert found and eng.stats.keys_covered == 6 * K * U


def test_refusals():
    ts = _targets("rmd160", [5])
    # past bucket_max the walker path runs (here for one target), any U
    walker = BruteEngine(ts, 1, 1025, mode="rmd160", device="cpu",
                         params=BruteParams(block_u=200, compare_max=0, bucket_max=0))
    assert walker._walker and walker.window == 401
    # a U the fused path cannot tile runs the walker path, as the JAX engine
    # does on an accelerator, and finds the planted key
    untiled = BruteEngine(ts, 1, 1025, mode="rmd160", device="cpu",
                          params=BruteParams(walkers=1, block_u=200))
    assert untiled._walker and untiled.window == 401
    assert [f.private_key for f in untiled.search()] == [5]
    with pytest.raises(ValueError):
        BruteEngine(ts, 1, 1025, mode="minikeys", device="cpu")
    off = convert.brute_params_from_jax(jbrute.BruteParams(pallas="off"))
    assert off.compare_max == off.bucket_max == 0
    assert BruteEngine(ts, 1, 1025, mode="rmd160", params=off, device="cpu")._walker


@pytest.mark.parametrize("mode", ["rmd160", "eth"])
def test_found_set_matches_jax_engine(mode):
    keys = [1, 2, 33, 300, 511, 1024]
    jts = _targets(mode, keys + [5000], cls=JTargetSet)
    jp = jbrute.BruteParams(walkers=2, block_u=256, steps_per_chunk=4, chunk_cand=64)
    want = jbrute.BruteEngine(jts, 1, 1025, mode=mode, params=jp).search()
    eng = BruteEngine(convert.targets_from_jax(jts), 1, 1025, mode=mode,
                      params=convert.brute_params_from_jax(jp), device="cpu")
    got = eng.search()
    assert sorted(f.private_key for f in got) == sorted(f.private_key for f in want)
    assert sorted(f.private_key for f in got) == keys
    assert {f.target for f in got} == {f.target for f in want}
