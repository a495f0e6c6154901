"""The minikeys slice of the port (keyhuntm1cpu_tpu_torch/engine/minikeys.py)
against the JAX package on the CPU: the chunk summary of minikey_finish
against _minikey_finish_impl (XLA path) word for word, the sorted target
table against filter/sorted_table.lookup, the exact valid-lane compaction,
and the engine's planted-minikey recovery, validity gate, custom alphabet,
counter_end and overflow rescan (tests/test_minikeys_vanity.py's cases).
Exact comparisons throughout."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import tables as jtables  # noqa: E402
from keyhuntm1cpu_tpu.engine import minikeys as jmk  # noqa: E402
from keyhuntm1cpu_tpu.filter import bitmap as jbmp  # noqa: E402
from keyhuntm1cpu_tpu.filter import sorted_table as jst  # noqa: E402
from keyhuntm1cpu_tpu.utils import targets as jtargets  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import pladder  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import minikeys as mk  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as st  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter.bitmap import compact_positions  # noqa: E402
from keyhuntm1cpu_tpu_torch.hash import pminikey  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet, targets_from_ints  # noqa: E402

torch.set_num_threads(1)
PREFIX = "SkeyhuntTPUx"
SMALL = mk.MinikeyParams(batch=4096, valid_max=128)


def _mk(prefix, counter, alphabet=mk._B58):
    return (prefix + mk._b58_digits(counter // mk.LOW_SPAN, 5, alphabet)
            + mk._b58_digits(counter % mk.LOW_SPAN, 5, alphabet))


def _valid(s):
    return hashlib.sha256((s + "?").encode()).digest()[0] == 0


def _key(s):
    return int.from_bytes(hashlib.sha256(s.encode()).digest(), "big")


def _first_valid(prefix, start=0, alphabet=mk._B58):
    c = start
    while not _valid(_mk(prefix, c, alphabet)):
        c += 1
    return _mk(prefix, c, alphabet), c


def _target(s, compressed):
    return hashref.pubkey_to_hash160(ecref.scalar_mult(_key(s)), compressed=compressed)


def test_finish_summary_matches_jax_word_for_word():
    B, V, HM, low = 4096, 2048, 64, 58 ** 4 - 1000  # the lanes cross a digit carry
    prefix17 = PREFIX + mk._b58_digits(3, 5)
    valid_lanes = [i for i in range(B) if _valid(prefix17 + mk._b58_digits(low + i, 5))]
    assert len(valid_lanes) >= 4
    planted = {valid_lanes[1]: True, valid_lanes[-2]: False}  # lane -> compressed
    rng = np.random.default_rng(5)
    raw = [_target(prefix17 + mk._b58_digits(low + lane, 5), c) for lane, c in planted.items()]
    raw += [rng.bytes(20) for _ in range(300)]  # decoys
    raw.append(raw[0])  # a duplicated key: found2
    eng = mk.MinikeyEngine(targets_from_ints("hash160", raw), prefix=PREFIX,
                           params=mk.MinikeyParams(batch=B, valid_max=V, hit_max=HM),
                           device="cpu")
    w22, w23 = eng._base_words(prefix17)
    valid = pminikey.minikey_valid(low, w23, B, mk._B58)
    got = mk.minikey_finish(low, valid, w22, eng._gx, eng._gy, eng.table, B=B, V=V, HM=HM)

    jts = jtargets.targets_from_ints("hash160", raw)
    t = jts.build_table()
    gx, gy = (jnp.asarray(a) for a in jtables.gtable_np())
    jw22 = jnp.asarray(w22.numpy().view(np.uint32))
    jvalid = jmk._xla_valid_impl(jnp.uint32(low), jnp.asarray(w23.numpy().view(np.uint32)),
                                 B=B, alphabet=mk._B58)
    want = jmk._minikey_finish_impl(jnp.uint32(low), jvalid, jw22, gx, gy, t.hi, t.lo, t.idx,
                                    B=B, V=V, HM=HM, chain=32, alphabet=mk._B58,
                                    tile_hash=False, tile_ladder=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    arr = got.numpy()
    assert arr[0] == len(valid_lanes) and arr[1] == 2
    assert sorted(arr[2:4].tolist()) == sorted(planted) and (arr[4:] == B).all()


def test_sorted_table_lookup_matches_jax():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)
    hi[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]  # around the sign flip
    hi[10], lo[10] = hi[11], lo[11]  # a duplicated key
    idx = np.arange(500, dtype=np.uint32)
    qhi = np.concatenate([hi, rng.integers(0, 2 ** 32, 200, dtype=np.uint64).astype(np.uint32),
                          [0xFFFFFFFF, 0]]).astype(np.uint32)
    qlo = np.concatenate([lo, rng.integers(0, 2 ** 32, 200, dtype=np.uint64).astype(np.uint32),
                          [0xFFFFFFFF, 0]]).astype(np.uint32)
    table = st.build_sorted_table(hi, lo, idx)
    got = st.lookup(table, torch.from_numpy(qhi.view(np.int32)),
                    torch.from_numpy(qlo.view(np.int32)))
    want = jst.lookup(jst.build_sorted_table(hi, lo, idx), jnp.asarray(qhi), jnp.asarray(qlo))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    assert got.found[:500].all() and got.found2[10] and got.found2[11]


def test_compaction_is_exact_where_the_jax_one_drops_lanes():
    """The deliberate difference: compact_positions_dense keeps at most
    kmax = 8 valid lanes per 128-lane row and flags the chunk lost; the
    port's prefix-sum compaction keeps every position."""
    rng = np.random.default_rng(1)
    mask = rng.random(4096) < 1 / 256
    mask[128:148] = True  # one row with 20 valid lanes
    got = compact_positions(torch.from_numpy(mask), 64, 4096).numpy()
    want = np.full(64, 4096)
    nz = np.nonzero(mask)[0][:64]
    want[: len(nz)] = nz
    np.testing.assert_array_equal(got, want)
    pos, lost = jbmp.compact_positions_dense(jnp.asarray(mask), 64, 4096)
    assert bool(lost) and not np.array_equal(np.asarray(pos), want)
    mask[136:148] = False  # 8 in the row: the two agree
    pos, lost = jbmp.compact_positions_dense(jnp.asarray(mask), 64, 4096)
    assert not bool(lost)
    np.testing.assert_array_equal(
        compact_positions(torch.from_numpy(mask), 64, 4096).numpy(), np.asarray(pos))


@pytest.mark.parametrize("compressed", [False, True])
def test_minikey_recovery(compressed):
    s, counter = _first_valid(PREFIX)
    ts = targets_from_ints("hash160", [_target(s, compressed)])
    eng = mk.MinikeyEngine(ts, prefix=PREFIX, params=SMALL, device="cpu")
    found = eng.search(max_chunks=counter // SMALL.batch + 2)
    assert [f.private_key for f in found] == [_key(s)]
    assert found[0].compressed == compressed and s in found[0].target


def test_minikey_validity_gate():
    """An invalid minikey whose key hashes to a target is not reported."""
    prefix = "Stpufilterxy"
    c = 0
    while _valid(_mk(prefix, c)):
        c += 1
    ts = targets_from_ints("hash160", [_target(_mk(prefix, c), False)])
    eng = mk.MinikeyEngine(ts, prefix=prefix, params=SMALL, device="cpu")
    assert eng.search(max_chunks=1) == []


def test_minikey_custom_alphabet():
    custom = mk._B58[29:] + mk._B58[:29]
    prefix = "SkeyhuntALTx"
    s, c = _first_valid(prefix, alphabet=custom)
    ts = targets_from_ints("hash160", [_target(s, False)])
    eng = mk.MinikeyEngine(ts, prefix=prefix, params=SMALL, alphabet=custom, device="cpu")
    found = eng.search(max_chunks=c // SMALL.batch + 2)
    assert [f.private_key for f in found] == [_key(s)] and s in found[0].target
    # the same scan under the canonical alphabet does not produce it
    eng2 = mk.MinikeyEngine(ts, prefix=prefix, params=SMALL, device="cpu")
    assert eng2.search(max_chunks=c // SMALL.batch + 2) == []


def test_minikey_counter_end_bounds_scan():
    s, counter = _first_valid(PREFIX, start=5000)
    ts = targets_from_ints("hash160", [_target(s, False)])
    params = mk.MinikeyParams(batch=1024, valid_max=64)
    eng = mk.MinikeyEngine(ts, prefix=PREFIX, params=params, device="cpu")
    eng.counter = 4096
    assert eng.search(counter_end=(counter // 1024) * 1024, stop_on_first=False) == []
    eng2 = mk.MinikeyEngine(ts, prefix=PREFIX, params=params, device="cpu")
    eng2.counter = (counter // 1024) * 1024
    found = eng2.search(counter_end=counter + 1)
    assert [f.private_key for f in found] == [_key(s)]


def test_budget_overflow_rescans_on_the_host():
    """More valid lanes than valid_max: the host rescan still finds the key
    past the budget."""
    prefix17 = PREFIX + mk._b58_digits(0, 5)
    lanes = [i for i in range(4096) if _valid(prefix17 + mk._b58_digits(i, 5))]
    s = prefix17 + mk._b58_digits(lanes[-1], 5)  # past a budget of 4
    ts = targets_from_ints("hash160", [_target(s, False)])
    eng = mk.MinikeyEngine(ts, prefix=PREFIX,
                           params=mk.MinikeyParams(batch=4096, valid_max=4), device="cpu")
    assert [f.private_key for f in eng.search(max_chunks=1)] == [_key(s)]


def test_params_tuning_and_conversion(tmp_path):
    for b in (256, 4096, 1 << 22, 1 << 23):
        assert mk.valid_budget(b) == jmk.valid_budget(b)
    assert mk.tuned_params(device="cpu") == mk.MinikeyParams()
    p = mk.tuned_params(device="cuda")
    assert (p.batch, p.valid_max) == (1 << 23, jmk.valid_budget(1 << 23)) == (1 << 23, 34816)
    jp = jmk.MinikeyParams(batch=1 << 20, valid_max=9216, hit_max=32, pipeline_depth=4,
                           chain_len=8, pallas="off")
    assert convert.minikey_params_from_jax(jp) == mk.MinikeyParams(
        batch=1 << 20, valid_max=9216, hit_max=32, pipeline_depth=4)
    ts = TargetSet(kind="hash160", raw=[b"\x01" * 20], labels=["t"])
    with pytest.raises(ValueError):
        mk.MinikeyEngine(ts, alphabet="abc", device="cpu")
    with pytest.raises(ValueError):
        mk.MinikeyEngine(ts, alphabet="a" * 58, device="cpu")
    with pytest.raises(ValueError):
        mk.MinikeyEngine(ts, prefix="Xshort", device="cpu")
    # a checkpoint of another run (here another mode) is refused
    from keyhuntm1cpu_tpu_torch.core.checkpoint import (Checkpoint, CheckpointError,
                                                         CheckpointManager)

    mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)
    mgr.save(Checkpoint(mode="bsgs", range_start=1, range_end=2, policy="sequential", seed=0,
                        params_fp="", targets_fp=""))
    with pytest.raises(CheckpointError):
        mk.MinikeyEngine(ts, params=SMALL, device="cpu").search(checkpoint=mgr)
    assert pladder.gtable_tensors("cpu")[0].shape == (32, 256, 8)
