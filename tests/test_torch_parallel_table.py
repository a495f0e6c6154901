"""Port table-sharded BSGS (keyhuntm1cpu_tpu_torch/parallel/mesh.py
ShardedTableBSGSEngine) vs the JAX package's, on the CPU: the JAX engine
on the conftest's CPU devices, the port's on [torch.device("cpu")] * D
with the plain versions of its kernels.

- the found sets equal the JAX engine's (all_gather), and the ring
  schedule finds what all_gather finds, with and without the bloom2 stage;
- the ring's first chunk equals all_gather's as a set of (prober,
  position, j, j2), and the union of the probers' live hits, as (global
  position, j), equals the single-device chunk's hits for each source
  slice;
- the row shards and their bitmaps and bloom2s equal, word for word, the
  JAX engine's host build (_shard_structures), pad rows included;
- shards on the table's device are views of it; the host copy (-S, the
  exact rescan) equals the table; search and search_scheduled raise;
- dryrun_multichip(4) on CPU devices.

Integer arithmetic: the tolerance is exact equality."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from keyhuntm1cpu_tpu.engine import BSGSEngine as JBSGSEngine  # noqa: E402
from keyhuntm1cpu_tpu.engine import BSGSParams as JBSGSParams  # noqa: E402
from keyhuntm1cpu_tpu.parallel import ShardedTableBSGSEngine as JShardedTable  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine, BSGSParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as st  # noqa: E402
from keyhuntm1cpu_tpu_torch.parallel import ShardedTableBSGSEngine  # noqa: E402

torch.set_num_threads(1)

JPARAMS = JBSGSParams(m=512, block_u=16, steps_per_chunk=2, build_block=128, chain_len=8)
PARAMS = BSGSParams(m=512, block_u=16, steps_per_chunk=8, build_block=128)
CPU4 = [torch.device("cpu")] * 4
A = 0x500000
B_END = A + 2**19  # 32 windows: one chunk of 8 steps a shard over 4 shards
KEYS = [A + 123, A + 2**18 + 777, B_END - 5]


@pytest.fixture(scope="module")
def jtable():
    return JBSGSEngine([ecref.scalar_mult(12345)], 1, 2, JPARAMS).table


@pytest.fixture(scope="module")
def table(jtable):
    return st.table_from_planes(*(np.asarray(t) for t in (jtable.hi, jtable.lo, jtable.idx)))


def _keys(found):
    return sorted(f.private_key for f in found)


def _engine(table, pubs, **kw):
    return ShardedTableBSGSEngine(pubs, A, B_END, dataclasses.replace(PARAMS, **kw),
                                  table=table, devices=CPU4)


@pytest.mark.parametrize("key_pos", ["low", "high"])
def test_found_sets_equal_jax(table, jtable, key_pos):
    key = {"low": A + 123, "high": B_END - 55}[key_pos]
    pub = [ecref.scalar_mult(key)]
    want = _keys(JShardedTable(pub, A, B_END, JPARAMS, table=jtable)
                 .search_sharded(stop_on_first=False))
    assert _keys(_engine(table, pub).search_sharded(stop_on_first=False)) == want == [key]


@pytest.mark.parametrize("cascade2", ["auto", "on"])
def test_ring_equals_all_gather(table, cascade2):
    """The first chunk's summaries hold the same (position, j, j2) for each
    prober under both schedules, and both find the three planted keys."""
    pubs = [ecref.scalar_mult(k) for k in KEYS]
    rows, degs, found = {}, {}, {}
    for comm in ("all_gather", "ring"):
        eng = _engine(table, pubs, table_comm=comm, cascade2=cascade2)
        assert eng._use_bloom2 == (cascade2 == "on")
        _, (host, _) = eng._sharded_chunk(eng._bases_at(0))
        r = host.numpy()[:-1].reshape(4, -1)
        C2 = eng.C2
        rows[comm] = [{(int(p), int(j), int(j2)) for p, j, j2 in zip(*row[:3 * C2].reshape(3, C2))
                       if p < 4 * len(KEYS) * 8 * 16} for row in r]
        degs[comm] = r[:, 3 * C2: -1].tolist()  # each prober's own walk's
        found[comm] = _keys(eng.search_sharded(stop_on_first=False))
    assert rows["ring"] == rows["all_gather"] and any(rows["ring"])
    assert degs["ring"] == degs["all_gather"]
    assert found["ring"] == found["all_gather"] == KEYS


def test_probers_hits_equal_single_device_chunk(table):
    """Union over the probers of the live (global position, j) hits of one
    all_gather chunk == the single-device chunk's (d*B + position, j) over
    the whole table for each source slice d."""
    pubs = [ecref.scalar_mult(k) for k in KEYS]
    eng = _engine(table, pubs)
    _, (host, _) = eng._sharded_chunk(eng._bases_at(0))
    rows, C2 = host.numpy()[:-1].reshape(4, -1), eng.C2
    B = len(pubs) * PARAMS.steps_per_chunk * PARAMS.block_u
    got = {(int(p), int(j)) for row in rows for p, *js in zip(*row[:3 * C2].reshape(3, C2))
           for j in js if p < 4 * B and j}
    single = BSGSEngine(pubs, A, B_END, PARAMS, device="cpu", table=table)
    want = set()
    for d, sl in enumerate(eng.slices):
        out = single._chunk_fn(*single._initial_base(sl.step0))[2].numpy()
        c2 = single.C2
        want |= {(d * B + int(p), int(j)) for p, *js in zip(*out[:3 * c2].reshape(3, c2))
                 for j in js if p < B and j}
    assert got == want and len(got) >= len(KEYS)


@pytest.mark.parametrize("n_dev", [3, 8])
def test_shard_structures_equal_jax(table, jtable, n_dev):
    """m = 512 over 3 devices pads one row; the bitmaps (bits_log2 as JAX
    sizes them for 171 or 64 rows) and the bloom2s word for word."""
    p = dataclasses.replace(PARAMS, cascade2="on")
    jp = dataclasses.replace(JPARAMS, cascade2="on")
    pub = [ecref.scalar_mult(A + 1)]
    jeng = JShardedTable(pub, A, B_END, jp, table=jtable, devices=jax.devices()[:n_dev])
    eng = ShardedTableBSGSEngine(pub, A, B_END, p, table=table,
                                 devices=[torch.device("cpu")] * n_dev)
    assert eng.rows == jeng.tbl_hi.shape[1] and eng.shard_bits == jeng._shard_bits
    assert eng.shard_b2_bits == jeng._shard_b2_bits
    jhi, jlo, jidx = (np.asarray(t) for t in (jeng.tbl_hi, jeng.tbl_lo, jeng.tbl_idx))
    for d in range(n_dev):
        key = eng.shards[d].key.numpy().view(np.uint64) ^ np.uint64(1 << 63)
        assert np.array_equal((key >> np.uint64(32)).astype(np.uint32), jhi[d])
        assert np.array_equal(key.astype(np.uint32), jlo[d])
        assert np.array_equal(eng.shards[d].idx.numpy().view(np.uint32), jidx[d])
        assert np.array_equal(eng.shard_bitmaps[d].words.numpy().view(np.uint32),
                              np.asarray(jeng.bmp_words)[d])
        assert np.array_equal(eng.shard_blooms[d].words.numpy().view(np.uint32),
                              np.asarray(jeng.b2_words)[d])


def test_shards_are_views_and_host_copy(table, tmp_path):
    eng = _engine(table, [ecref.scalar_mult(A + 1)])
    base = table.key.untyped_storage().data_ptr()
    assert all(s.key.untyped_storage().data_ptr() == base for s in eng.shards)
    assert eng.table is None
    host = eng._host_table()
    assert torch.equal(host.key, table.key) and torch.equal(host.idx, table.idx)
    eng.save_table(str(tmp_path / "t.npz"))
    loaded = BSGSEngine.load_table(str(tmp_path / "t.npz"), device="cpu")
    assert torch.equal(loaded.key, table.key) and torch.equal(loaded.idx, table.idx)
    with pytest.raises(NotImplementedError):
        eng.search()
    with pytest.raises(NotImplementedError):
        eng.search_scheduled()
    with pytest.raises(ValueError):
        _engine(table, [ecref.scalar_mult(A + 1)], table_comm="tree")


def test_dryrun_multichip_cpu(capsys):
    from keyhuntm1cpu_tpu_torch.dryrun import dryrun_multichip, entry

    fn, base = entry("cpu")
    assert fn(*base)[2].dtype == torch.int32
    dryrun_multichip(4, device="cpu")
    assert capsys.readouterr().out.count("recovered the planted key") == 4
