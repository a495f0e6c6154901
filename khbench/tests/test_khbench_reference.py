"""The reference: its curve and hashes against published values, its
restated filter layouts against the structures the program builds, and
its checks on tiny CPU runs of every cell, sound and with the timed path
broken underneath (khbench/faults.py)."""

import hashlib

import numpy as np
import pytest
import torch

from khbench import generator, run
from khbench.reference import bsgs as rbsgs
from khbench.reference import brute as rbrute
from khbench.reference import filters, hashes
from khbench.reference import secp256k1 as ec
from khbench.tests.tiny import cells, make_bench

# 2*G and the hash160 of G's compressed key (the address 1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH)
G2 = (0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5,
      0x1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A)
H160_G = "751e76e8199196d454941c45d1b3a323f1433bd6"


def test_curve_and_hashes():
    assert ec.on_curve(ec.G) and ec.mul(2) == G2 and ec.add(ec.G, ec.G) == G2
    assert ec.mul(ec.N) is None and ec.mul(ec.N - 1) == ec.neg(ec.G)
    assert ec.add(ec.mul(5), ec.mul(7)) == ec.mul(12)
    assert hashes.ripemd160(b"abc").hex() == "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"
    assert hashes.ripemd160(b"").hex() == "9c1185a5c5e9fc54612808977ee8f548b2258d31"
    assert hashes.hash160(ec.compressed(ec.G)).hex() == H160_G
    assert hashlib.sha256(b"").hexdigest().startswith("e3b0c442")


@pytest.mark.parametrize("bits", [16, 32, 35])
def test_filter_layouts_match_the_program(bits):
    """The restated bitmap and bloom2 indices are those of the structures
    the program builds (its plain versions, on the CPU)."""
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    keys = [ec.trunc64(ec.mul(j)) for j in range(1, 40)] + [0, (1 << 64) - 1, 0x80000000]
    hi = torch.tensor([k >> 32 for k in keys], dtype=torch.int64)
    lo = torch.tensor([k & 0xFFFFFFFF for k in keys], dtype=torch.int64)
    w1, b1 = bmp.bitmap_bit_planes(hi, lo, bits)
    w2, b2 = bmp.bloom2_bit_planes(hi, lo, bits)
    n = len(keys)
    for i, k in enumerate(keys):
        idx = filters.bitmap_bit(k, bits)
        assert (int(w1[i]), int(b1[i])) == (idx >> 5, 1 << (idx & 31))
        for h, b in enumerate(filters.bloom2_bits(k, bits)):
            assert (int(w2[h * n + i]), int(b2[h * n + i])) == (b >> 5, 1 << (b & 31))


def test_bucket_layout_matches_the_program():
    from keyhuntm1cpu_tpu_torch.curve import pbrute

    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(0, 2**63, 600, dtype=np.int64)] + [5, 5 + (9 << 32)]
    btab = pbrute.pack_buckets(vals)
    assert btab.shape[0] == filters.bucket_rows(vals)
    assert rbrute.target_table_errors(vals, np.zeros((4, 8), np.uint32), btab, btab.shape[0]) == 0
    lanes = filters.bucket_lanes(vals)
    for lane in range(128):
        assert set(int(x) for x in btab[:, lane]) == (lanes.get(lane) or {0})
    broken = btab.copy()
    broken[:, vals[0] & 127] = 0
    assert rbrute.target_table_errors(vals, np.zeros((4, 8), np.uint32), broken,
                                      btab.shape[0]) >= 1


def test_survivor_rates():
    # the main cell: 4,194,304 queries, m = 2^28 into 2^35 + 2^32 bits
    e = filters.bsgs_survivors_per_chunk(1 << 22, 1 << 28, 35, 32)
    assert 440 < e < 460
    lanes = filters.bucket_lanes(range(0, 65536 << 32, 1 << 32))  # one lane, 65,536 words
    assert filters.brute_hit_words_per_chunk(1 << 22, 2, lanes) == pytest.approx(
        (1 << 22) * 2 * (65536 + 127) / 128 / 2**32, rel=1e-4)


def test_bsgs_layout_finds_the_planted_match():
    lay = rbsgs.Layout(a=10**6, m=64, U=4, K=2, T=1)
    k = 10**6 + 3 * 128 + 77
    (chunk, pos, j), = [h for h in lay.expected_hits(k, 0) if h[2] <= 64]
    c = lay.centre(chunk * lay.K + pos // lay.U, pos % lay.U)
    assert abs(k - c) == j
    q = ec.mul(k)
    base = lay.base(q, 5)
    assert ec.add(base, ec.neg(ec.mul(k - lay.centre(5, -1)))) is None


def test_brute_candidates():
    lay = rbrute.Layout(a=1000, U=128, K=2)
    k = 1000 + 300
    chunk, pos, bit = lay.expected_hit(k)
    v = rbrute.query_values(k, bit)[bit]
    assert rbrute.candidate_errors(lay, [(chunk, pos, bit)], {v}, None) == 0
    assert rbrute.candidate_errors(lay, [(chunk, pos ^ 1, bit)], {v}, None) == 1
    assert rbrute.candidate_errors(lay, [(chunk, pos, 3 - bit)], {v}, None) == 1


# every cell of BENCHMARK.json, then those whose files wait (tiny.WAITING)
CELLS = [w["name"] for w in cells()]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_bench(str(tmp_path_factory.mktemp("tiny")))


def odd_lane_seed(bench, cell) -> int:
    """A seed whose planted key sits in an odd lane, the half the
    half_batch fault drops, where a cell plants one key (the tiny cells do
    not hold the survivor rate that sees the fault on the card); any seed
    where the mix spreads several."""
    from khbench import spec

    c = spec.load(bench, cell)
    if c.mix.get("planted", 1) > 1:
        return 2718281828
    for seed in range(1, 200):
        inp = generator.generate(c.mix, c.config, seed)
        k = inp.planted[0]
        if c.config["engine"] == "brute":
            odd = rbrute.Layout(inp.a, c.config["block_u"], c.config["steps_per_chunk"]) \
                .expected_hit(k)[1] % 2
        else:
            lay = rbsgs.Layout(inp.a, c.config["m_babies"], c.config["block_u"],
                               c.config["steps_per_chunk"], 1)
            start = max(s for s in inp.slice_starts if s <= k)
            hits = lay.expected_hits(k, 0, (start - inp.a) // (lay.U * lay.stride))
            odd = hits and all(p % 2 for _, p, _ in hits)
        if odd:
            return seed
    raise AssertionError("no seed with the planted key in an odd lane")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = run.run_cell(tiny, cell, 3141592653, 1.0, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


FAULTS = [(c, f) for c in CELLS for f in ("state_unchanged", "altered_answer", "half_batch")]
FAULTS += [(w["name"], "no_exchange") for w in cells() if w["chips"] > 1]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(tiny, cell, fault):
    """With the harness's look for a chip skipped and the timed path
    broken underneath, the rest of a run reports correct false."""
    seed = odd_lane_seed(tiny, cell) if fault == "half_batch" else 2718281828
    r = run.run_cell(tiny, cell, seed, 1.0, False, fault=fault, device="cpu")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 7, 3900000001])
def test_half_batch_fails_the_spread_cell_on_any_seed(tiny, seed):
    """rmd160_71_seq_t4 holds only exact checks: its spread planted keys
    make the control fail whatever the seed."""
    r = run.run_cell(tiny, "rmd160_71_seq_t4", seed, 1.0, False, fault="half_batch",
                     device="cpu")
    assert not r["correct"] and r["checks"]["found_missing"]["value"] >= 1, r["checks"]


@pytest.mark.parametrize("seed", [5, 2**31 + 11, 3900000002])
def test_spread_planted_keys_cover_both_halves(seed):
    """At the cell's own sizes, the planted keys sit in both lane parities,
    both lane halves and both step halves of a chunk, in its first 2^32
    keys, with their hash160s among the targets."""
    import json
    import os

    from khbench.tests.tiny import DATA

    mix = json.load(open(os.path.join(DATA, "traffic", "rmd160_seq_t4.json")))
    cfg = json.load(open(os.path.join(DATA, "configs", "rmd160_puzzle71.json")))
    inp = generator.generate(mix, cfg, seed)
    K, U = cfg["steps_per_chunk"], cfg["block_u"]
    assert len(set(inp.planted)) == mix["planted"] == len(inp.digests)
    pos = [(k - inp.a) % (K * U) for k in inp.planted]
    assert all(0 <= k - inp.a < 1 << mix["plant_span_log2"] for k in inp.planted)
    for part in (lambda p: p % U % 2, lambda p: p % U >= U // 2, lambda p: p // U >= K // 2):
        assert {part(p) for p in pos} == {0, 1}
    assert {hashes.hash160(ec.compressed(ec.mul(k))) for k in inp.planted} == set(inp.digests)


def test_seeds_pack_the_same_lane_table():
    """Every seed of the t65536 mix packs the same number of lane rows, so
    the seed moves the planted key and the window, not the work."""
    import json
    import os

    from khbench.tests.tiny import DATA

    mix = json.load(open(os.path.join(DATA, "traffic", "rmd160_seq_t65536.json")))
    cfg = json.load(open(os.path.join(DATA, "configs", "rmd160_puzzle71.json")))
    rows = {filters.bucket_rows([hashes.cmp64(d) for d in generator.generate(mix, cfg, s).digests])
            for s in (1, 2**31 + 5, 3500000000)}
    assert len(rows) == 1
