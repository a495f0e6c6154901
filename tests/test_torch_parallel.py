"""Port range partitioning and range-sharded BSGS
(keyhuntm1cpu_tpu_torch/parallel) vs the JAX package's, on the CPU: the
JAX engines on the conftest's 8 CPU devices, the port's on
[torch.device("cpu")] * D with the plain versions of its kernels.

- split_equal / split_by_weight equal the JAX partitioner's on seeded
  random ranges, windows, shard counts and weights (more shards than
  windows included);
- ShardedBSGSEngine finds the same keys as the JAX ShardedBSGSEngine
  (key low, mid and high in the range), and each shard's summary of a
  sharded chunk equals, word for word, the single-device chunk at its
  slice's base;
- checkpoints: a cut run resumes in a fresh engine, a mismatched run
  raises, and a checkpoint the JAX sharded engine wrote resumes in the port;
- a zero deadline dispatches nothing; a shard whose advance chain
  degenerates has the rest of its chunk rescanned and every shard rebased;
- repeated devices hold one table.

Integer arithmetic: the tolerance is exact equality."""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.core.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from keyhuntm1cpu_tpu.engine import BSGSEngine as JBSGSEngine  # noqa: E402
from keyhuntm1cpu_tpu.engine import BSGSParams as JBSGSParams  # noqa: E402
from keyhuntm1cpu_tpu.parallel import RangePartitioner as JPartitioner  # noqa: E402
from keyhuntm1cpu_tpu.parallel import ShardedBSGSEngine as JShardedBSGSEngine  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from keyhuntm1cpu_tpu_torch.core.errors import CheckpointError  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine, BSGSParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as st  # noqa: E402
from keyhuntm1cpu_tpu_torch.parallel import (RangePartitioner, RangeSlice,  # noqa: E402
                                             ShardedBSGSEngine)

torch.set_num_threads(1)

# tests/test_parallel.py's shape; the port's K = 8 walks a 2^19 range in
# one chunk a shard over 4 shards
JPARAMS = JBSGSParams(m=512, block_u=16, steps_per_chunk=2, build_block=128, chain_len=8)
PARAMS = BSGSParams(m=512, block_u=16, steps_per_chunk=8, build_block=128)
CPU4 = [torch.device("cpu")] * 4
A = 0x500000
WINDOW = 16 * 2 * 512  # U * stride


@pytest.fixture(scope="module")
def jtable():
    return JBSGSEngine([ecref.scalar_mult(12345)], 1, 2, JPARAMS).table


@pytest.fixture(scope="module")
def table(jtable):
    return st.table_from_planes(*(np.asarray(t) for t in (jtable.hi, jtable.lo, jtable.idx)))


def _keys(found):
    return sorted(f.private_key for f in found)


def _slice(s):
    """A JAX RangeSlice as the port's."""
    return RangeSlice(s.start, s.end, s.step0)


@pytest.mark.parametrize("seed", range(6))
def test_partition_equals_jax(seed):
    rng = random.Random(seed)
    for _ in range(50):
        window = rng.choice([1, 7, 1024, 16 * 1024])
        start = rng.randrange(1, 1 << 40)
        end = start + rng.randrange(1, 64 * window)
        n = rng.randrange(1, 12)
        assert (RangePartitioner.split_equal(start, end, n, window)
                == [_slice(s) for s in JPartitioner.split_equal(start, end, n, window)])
        weights = [rng.uniform(0.1, 4.0) for _ in range(n)]
        assert (RangePartitioner.split_by_weight(start, end, weights, window)
                == [_slice(s) for s in JPartitioner.split_by_weight(start, end, weights,
                                                                    window)])


def test_partition_more_shards_than_windows():
    got = RangePartitioner.split_equal(0x1000, 0x1000 + 10, 8, 1 << 20)
    assert got == [_slice(s) for s in JPartitioner.split_equal(0x1000, 0x1000 + 10, 8, 1 << 20)]
    assert len(got) == 8 and all(s.step0 == 0 and s.end == 0x1000 + 10 for s in got)


@pytest.mark.parametrize("key_pos", ["low", "mid", "high"])
def test_sharded_found_sets_equal_jax(table, jtable, key_pos):
    b = A + 2**19  # 32 windows: 8 local steps a shard
    key = {"low": A + 123, "mid": A + 2**18 + 777, "high": b - 55}[key_pos]
    pub = [ecref.scalar_mult(key)]
    want = _keys(JShardedBSGSEngine(pub, A, b, JPARAMS, table=jtable)
                 .search_sharded(stop_on_first=False))
    eng = ShardedBSGSEngine(pub, A, b, PARAMS, table=table, devices=CPU4)
    assert eng.local_steps == 8 and len(eng.slices) == 4
    assert _keys(eng.search_sharded(stop_on_first=False)) == want == [key]


def test_shard_summaries_equal_single_device_chunk(table):
    """One sharded chunk: shard d's summary is the single-device chunk at
    slice d's base, word for word; the appended interest counts them."""
    b = A + 2**19
    keys = [A + 123, A + 2 * 8 * WINDOW + 4321]  # shards 0 and 2
    pubs = [ecref.scalar_mult(k) for k in keys]
    eng = ShardedBSGSEngine(pubs, A, b, PARAMS, table=table, devices=CPU4)
    _, (host, ev) = eng._sharded_chunk(eng._bases_at(0))
    assert ev is None
    arr = host.numpy()
    rows = arr[:-1].reshape(4, -1)
    single = BSGSEngine(pubs, A, b, PARAMS, device="cpu", table=table)
    B = len(pubs) * PARAMS.steps_per_chunk * PARAMS.block_u
    for d, sl in enumerate(eng.slices):
        want = single._chunk_fn(*single._initial_base(sl.step0))[2].numpy()
        assert np.array_equal(rows[d], want), d
    interest = sum(int((r[:eng.C2] < B).sum()) + int(r[3 * eng.C2: 3 * eng.C2 + B // 16].sum())
                   + int(r[-1] > eng.C2) for r in rows)
    assert int(arr[-1]) == interest > 0
    found, rebase = eng._decode_sharded(rows, 0, PARAMS.steps_per_chunk)
    assert _keys(found) == keys and not rebase


def test_repeated_devices_hold_one_table(table):
    eng = ShardedBSGSEngine([ecref.scalar_mult(A + 5)], A, A + 2**19, PARAMS, table=table,
                            devices=CPU4)
    assert list(eng._filters) == [torch.device("cpu")] and list(eng._walk) == [
        torch.device("cpu")]
    assert eng._filters[torch.device("cpu")].table.key.data_ptr() == table.key.data_ptr()


@pytest.mark.parametrize("cls_name", ["range", "table"])
def test_sharded_checkpoint_resume(table, cls_name, tmp_path):
    """A run cut after one chunk saves chunks_done = 1 and its find; a fresh
    engine resumes past it, reports the saved key and finds the late one."""
    from keyhuntm1cpu_tpu_torch.parallel import ShardedTableBSGSEngine

    cls = ShardedTableBSGSEngine if cls_name == "table" else ShardedBSGSEngine
    path = str(tmp_path / "ck.json")
    b = A + 2**20  # 16 local steps a shard: two chunks
    early = A + 123
    late = A + 3 * 16 * WINDOW + 15 * WINDOW + 55  # the last step of shard 3
    pubs = [ecref.scalar_mult(early), ecref.scalar_mult(late)]
    f1 = cls(pubs, A, b, PARAMS, table=table, devices=CPU4).search_sharded(
        max_steps=8, stop_on_first=False, checkpoint=CheckpointManager(path, every_s=0))
    assert _keys(f1) == [early]
    ck = CheckpointManager(path).load()
    assert ck.chunks_done == 1 and f"{early:x}" in ck.found and ck.mode == "bsgs-sharded"
    f2 = cls(pubs, A, b, PARAMS, table=table, devices=CPU4).search_sharded(
        stop_on_first=False, checkpoint=CheckpointManager(path, every_s=0))
    assert _keys(f2) == [early, late]
    assert CheckpointManager(path).load().chunks_done == 2


def test_sharded_checkpoint_mismatch_raises(table, tmp_path):
    path = str(tmp_path / "ck.json")
    pub = [ecref.scalar_mult(A + 123)]
    eng = ShardedBSGSEngine(pub, A, A + 2**20, PARAMS, table=table, devices=CPU4)
    assert eng.search_sharded(max_seconds=0.0, checkpoint=CheckpointManager(path, every_s=0)) == []
    assert CheckpointManager(path).load().chunks_done == 0
    for other in (ShardedBSGSEngine(pub, A, A + 2**19, PARAMS, table=table, devices=CPU4),
                  ShardedBSGSEngine(pub, A, A + 2**20, PARAMS, table=table, devices=CPU4[:2])):
        with pytest.raises(CheckpointError):
            other.search_sharded(checkpoint=CheckpointManager(path, every_s=0))


def test_jax_sharded_checkpoint_resumes_in_port(table, jtable, tmp_path):
    """The JAX engine on 4 devices stops after 6 chunks of K = 2; the port
    (same m, U, K, shard count and class name) resumes at local step 12,
    re-reports the JAX run's key and finds the one in the last steps."""
    path = str(tmp_path / "ck.json")
    b = A + 2**20
    early = A + 2 * 16 * WINDOW + 3 * WINDOW + 99  # shard 2, local step 3
    late = A + 1 * 16 * WINDOW + 14 * WINDOW + 7  # shard 1, local step 14
    pubs = [ecref.scalar_mult(early), ecref.scalar_mult(late)]
    import jax

    jeng = JShardedBSGSEngine(pubs, A, b, JPARAMS, table=jtable, devices=jax.devices()[:4])
    got = jeng.search_sharded(max_steps=12, stop_on_first=False,
                              checkpoint=JCheckpointManager(path, every_s=0))
    assert _keys(got) == [early]
    assert JCheckpointManager(path).load().chunks_done == 6
    p2 = dataclasses.replace(PARAMS, steps_per_chunk=2)
    eng = ShardedBSGSEngine(pubs, A, b, p2, table=table, devices=CPU4)
    calls = []
    inner = eng._sharded_chunk
    eng._sharded_chunk = lambda bases: calls.append(1) or inner(bases)
    found = eng.search_sharded(stop_on_first=False, checkpoint=CheckpointManager(path, every_s=0))
    assert _keys(found) == sorted([early, late]) and len(calls) == 2
    assert CheckpointManager(path).load().chunks_done == 8


def test_sharded_deadline_stops(table):
    eng = ShardedBSGSEngine([ecref.scalar_mult(A + 123)], A, A + 2**19, PARAMS, table=table,
                            devices=CPU4)
    calls = []
    eng._sharded_chunk = lambda bases: calls.append(1)
    assert eng.search_sharded(stop_on_first=False, max_seconds=0.0) == [] and not calls


def test_degenerate_shard_rescans_and_rebases(table):
    """A synthetic chunk (the real summary layout): shard 2's advance chain
    degenerates in local step 1, so steps 2..K-1 of its chunk are rescanned
    on the host (the planted key sits in step 2) and every shard rebases at
    the next chunk."""
    from keyhuntm1cpu_tpu_torch.engine.common import summary_to_host

    b = A + 2**20
    K, U = PARAMS.steps_per_chunk, PARAMS.block_u
    probe = ShardedBSGSEngine([ecref.scalar_mult(A + 1)], A, b, PARAMS, table=table,
                              devices=CPU4)
    key = probe._center(probe.slices[2].step0 + 2, 5) + 100
    eng = ShardedBSGSEngine([ecref.scalar_mult(key)], A, b, PARAMS, table=table, devices=CPU4)
    C2, B = eng.C2, K * U
    width = 3 * C2 + 3 * K + 1
    rescans, rebases, first = [], [], [True]
    orig_rescan, orig_bases = eng._host_rescan_step, eng._bases_at
    eng._host_rescan_step = lambda s: rescans.append(s) or orig_rescan(s)
    eng._bases_at = lambda s: rebases.append(s) or orig_bases(s)

    def fake_chunk(bases):
        rows = np.zeros((4, width), np.int32)
        rows[:, :C2] = B
        if first[0]:
            first[0] = False
            rows[2, 3 * C2 + 1] = 1  # n_deg of step 1
            rows[2, 3 * C2 + K + 1] = U - 1  # its first degenerate lane
            rows[2, 3 * C2 + 2 * K + 1] = 1  # the advance flag
        interest = np.int32((rows[:, :C2] < B).sum() + rows[:, 3 * C2: 3 * C2 + K].sum())
        return bases, summary_to_host(torch.from_numpy(np.append(rows.reshape(-1), interest)))

    eng._sharded_chunk = fake_chunk
    found = eng.search_sharded(stop_on_first=False)
    g0 = eng.slices[2].step0
    assert rescans == list(range(g0 + 2, g0 + K)) and rebases == [0, K]
    assert _keys(found) == [key]

