"""Port BSGS host-resolve engine (keyhuntm1cpu_tpu_torch/engine/bsgs.py) vs
the JAX package, on the CPU at the shapes of tests/test_host_resolve.py
(m = 2^12, U = 16, K = 4):

- the port's streaming filter build equals the JAX host-derived filters
  (build_bitmap(on_device=False) + build_bloom2_host) word for word;
- the port's chunk summary equals, word for word, the reference
  composition: walk.walk_fused keys for all T*K*U points fed flat into the
  JAX filtered_survivors with the same C1/C2, packed as
  bsgs._pallas_chunk_impl_host packs them;
- found keys equal the JAX engine's: one key, three keys (with a dx == 0
  lane and a P == -ADV advance), a key at the initial base
  (_ImmediateHit), and the exact host rescan after a cascade overflow.

Integer arithmetic: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import points, walk  # noqa: E402
from keyhuntm1cpu_tpu.engine import bsgs as jbsgs  # noqa: E402
from keyhuntm1cpu_tpu.filter import bitmap as jb  # noqa: E402
from keyhuntm1cpu_tpu.filter import host_table as jht  # noqa: E402
from keyhuntm1cpu_tpu.filter import sorted_table as st  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import host_table as ht  # noqa: E402

torch.set_num_threads(1)
M, U, K = 1 << 12, 16, 4
A, B = 0xA00000, 0xB00000


def _center(step, u):
    return A + M + (step * U + u - 1) * 2 * M


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(port HostTable, the same planes as a JAX HostTable, cache dir)."""
    cache = str(tmp_path_factory.mktemp("tc"))
    tab = ht.ensure_host_table(M, cache_dir=cache)
    return tab, jht.HostTable(tab.keys, tab.idx), cache


@pytest.fixture(scope="module")
def jax_filters(tables):
    """Filters as the JAX engine derives them on the CPU (bits 24, b2 17)."""
    keys = np.asarray(tables[0].keys)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = keys.astype(np.uint32)
    bm = jb.build_bitmap(hi, lo, None, on_device=False)
    b2 = jb.build_bloom2_host(hi, lo, jb.bloom2_bits_log2_host(M))
    return bm, b2


def _params(**kw):
    return jbsgs.BSGSParams(m=M, block_u=U, steps_per_chunk=K, resolve="host", **kw)


def _port_engine(pubs, tables, jax_filters, a=A, b=B, **kw):
    bm, b2 = jax_filters
    fb, f2 = convert.filters_from_jax(np.asarray(bm.words), bm.bits_log2,
                                      np.asarray(b2.words), b2.bits_log2, "cpu")
    return bsgs.BSGSEngine(pubs, a, b, convert.params_from_jax(_params(**kw)),
                           device="cpu", host_table=tables[0], bitmap=fb, bloom2=f2)


def _keys(found):
    return sorted(f.private_key for f in found)


@pytest.mark.parametrize("build_block,blocks,slice_", [(64, None, None), (48, 16, "2")],
                         ids=["one_step", "sliced_tail"])
def test_streaming_build_matches_jax_host_filters(tables, jax_filters, monkeypatch,
                                                  build_block, blocks, slice_):
    if blocks is not None:  # several walk steps, a masked tail, 2-step slices
        monkeypatch.setattr(bsgs, "BUILD_BLOCKS", blocks)
        monkeypatch.setenv("KEYHUNT_STREAM_SLICE", slice_)
    params = bsgs.BSGSParams(m=M, block_u=U, steps_per_chunk=K, build_block=build_block,
                             resolve="host")
    eng = bsgs.BSGSEngine([ecref.G], A, B, params, device="cpu",
                          host_table=tables[0])
    bm, b2 = jax_filters
    assert (eng.bitmap.bits_log2, eng.bloom2.bits_log2) == (bm.bits_log2, b2.bits_log2)
    assert np.array_equal(eng.bitmap.words.numpy().view(np.uint32), np.asarray(bm.words))
    assert np.array_equal(eng.bloom2.words.numpy().view(np.uint32), np.asarray(b2.words))


@pytest.mark.parametrize("ones", [False, True], ids=["real_filters", "all_pass_overflow"])
def test_chunk_summary_matches_reference_composition(tables, jax_filters, ones):
    """Targets: a plain key, a key on a walk lane (dx == 0 at step 1,
    u = 5) and a key that makes the LAST advance of the chunk hit
    P == -ADV (so every walked row is valid in both implementations)."""
    ks = [0xA12345, _center(1, 5), _center(K - 1, U)]
    T = len(ks)
    pubs = [ecref.scalar_mult(k) for k in ks]
    eng = _port_engine(pubs, tables, jax_filters)
    bm, b2 = jax_filters
    C1, C2 = eng.C1, eng.C2
    if ones:  # every query survives both levels: poison and C2 overflow
        bm = jb.DeviceBitmap(jnp.full_like(bm.words, 0xFFFFFFFF), bm.bits_log2)
        b2 = jb.DeviceBloom2(jnp.full_like(b2.words, 0xFFFFFFFF), b2.bits_log2)
        eng.bitmap.words.fill_(-1)
        eng.bloom2.words.fill_(-1)
        C1, C2 = 128, 32
    px, py = eng._initial_base(0)
    _, _, got = bsgs.chunk_impl_host(
        px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, eng.bitmap,
        eng.bloom2, U=U, K=K, T=T, C1=C1, C2=C2)

    jeng = jbsgs.BSGSEngine(pubs, A, B, _params(), host_table=tables[1],
                            bitmap=bm, bloom2=b2)
    base = jeng._initial_base(0)
    cx, cy = base.x, base.y
    qh, ql, dg, ad = [], [], [], []
    wf = jax.jit(walk.walk_fused)
    for _ in range(K):
        r = wf(points.PointBatch(cx, cy, jnp.zeros((T,), bool)), jeng.tab_x,
               jeng.tab_y, jeng.adv_x, jeng.adv_y)
        hi, lo = st.trunc64_from_limbs(r.x_plus)
        qh.append(hi), ql.append(lo), dg.append(r.degenerate), ad.append(r.adv_degenerate)
        cx, cy = r.adv_x, r.adv_y
    qhi = jnp.stack(qh, 1).reshape(-1)  # rows t*K + s
    qlo = jnp.stack(ql, 1).reshape(-1)
    deg = jnp.stack(dg, 1).reshape(T * K, U)
    adv_flat = jnp.stack(ad, 1).reshape(-1)
    deg = deg.at[:, U - 1].set(deg[:, U - 1] | adv_flat)
    fs = jb.filtered_survivors(bm, qhi, qlo, C2, bm2=b2, stage1_max=C1)
    Bq = T * K * U
    live = ~deg.reshape(-1)[jnp.minimum(fs.pos, Bq - 1)]
    want = np.asarray(jnp.concatenate([
        jnp.where((fs.pos < Bq) & live, fs.pos, Bq).astype(jnp.int32),
        jax.lax.bitcast_convert_type(fs.qhi, jnp.int32),
        jax.lax.bitcast_convert_type(fs.qlo, jnp.int32),
        jnp.stack([deg.sum(axis=1).astype(jnp.int32),
                   jnp.argmax(deg, axis=1).astype(jnp.int32),
                   adv_flat.astype(jnp.int32)]).reshape(-1),
        fs.n_candidates[None],
    ]))
    assert got.shape == want.shape == (3 * C2 + 3 * T * K + 1,)
    assert np.array_equal(got.numpy(), want)
    degsum = want[3 * C2: 3 * C2 + 3 * T * K].reshape(3, T, K)
    assert degsum[0, 1, 1] == 1 and degsum[1, 1, 1] == 4  # the dx == 0 lane
    assert degsum[2, 2, K - 1] == 1  # the P == -ADV advance
    if ones:
        assert want[-1] > C1  # stage-1 overflow poisoned past cand_max


def test_engine_recovers_key(tables, jax_filters):
    k = 0xABC123
    pub = ecref.scalar_mult(k)
    found = _port_engine([pub], tables, jax_filters).search()
    jeng = jbsgs.BSGSEngine([pub], A, B, _params(cascade2="on"), host_table=tables[1])
    assert _keys(found) == _keys(jeng.search()) == [k]


def test_engine_multitarget_with_degenerate_lanes(tables, jax_filters):
    ks = [0xA12345, _center(3, 5), _center(6, U)]
    pubs = [ecref.scalar_mult(k) for k in ks]
    found = _port_engine(pubs, tables, jax_filters).search(stop_on_first=False)
    jeng = jbsgs.BSGSEngine(pubs, A, B, _params(), host_table=tables[1])
    assert _keys(found) == _keys(jeng.search(stop_on_first=False)) == sorted(ks)


def test_engine_immediate_hit_base(tables, jax_filters):
    """The key sits exactly on the initial base center of start_step 4."""
    k = _center(4, 0)
    pub = ecref.scalar_mult(k)
    eng = _port_engine([pub], tables, jax_filters)
    with pytest.raises(bsgs._ImmediateHit):
        eng._initial_base(4)
    found = eng.search(start_step=4, stop_on_first=False)
    jeng = jbsgs.BSGSEngine([pub], A, B, _params(), host_table=tables[1])
    assert _keys(found) == _keys(jeng.search(start_step=4, stop_on_first=False)) == [k]


@pytest.mark.parametrize("C1,C2", [(8, 4), (4096, 4)], ids=["n1_gt_C1", "n2_gt_C2"])
def test_engine_overflow_rescan(tables, jax_filters, C1, C2):
    """All-pass filters with tiny budgets: every chunk overflows and the
    engine must recover the keys through _host_rescan_step alone."""
    ks = [0xA12345, 0xAFEDCB]
    pubs = [ecref.scalar_mult(k) for k in ks]
    eng = _port_engine(pubs, tables, jax_filters, b=0xA80000)
    eng.bitmap.words.fill_(-1)
    eng.bloom2.words.fill_(-1)
    eng.C1, eng.C2 = C1, C2
    found = eng.search(stop_on_first=False)
    jeng = jbsgs.BSGSEngine(pubs, A, 0xA80000, _params(), host_table=tables[1])
    jfound = [f for s in range(jeng.n_steps) for f in jeng._host_rescan_step(s)]
    assert _keys(found) == _keys(jbsgs.BSGSEngine._dedupe_found(jfound)) == [0xA12345]


# ---------------------------------------------------------------------------
# range orders (chunk_order, search_scheduled) and checkpoints
# ---------------------------------------------------------------------------

B4 = 0xC00000  # 4 chunks of K*U*2m = 2^19 keys
LATE = 0xBF1234  # in the last chunk (tests/test_host_resolve.py:126)
POLICIES = ["sequential", "backward", "both", "random", "dance"]


@pytest.mark.parametrize("policy", POLICIES)
def test_chunk_order_matches_jax(policy):
    """Element for element, for several seeds and chunk counts (a stub
    engine holds the two attributes chunk_order reads)."""
    from types import SimpleNamespace

    for n_steps in (1, 4, 7, 64, 1000, 4096 * K):
        for seed in (0, 1, 3, 12345):
            stub = SimpleNamespace(n_steps=n_steps, p=SimpleNamespace(steps_per_chunk=K))
            got = bsgs.BSGSEngine.chunk_order(stub, policy, seed)
            assert got == jbsgs.BSGSEngine.chunk_order(stub, policy, seed)
            assert sorted(got) == list(range(-(-n_steps // K)))
    with pytest.raises(ValueError):
        bsgs.BSGSEngine.chunk_order(stub, "sideways", 0)


@pytest.mark.parametrize("policy", POLICIES)
def test_search_scheduled_policies_recover_key(tables, jax_filters, policy):
    """Every range order finds the planted key, as the JAX engine's does
    (tests/test_bsgs.py:120); the keys covered count each chunk once."""
    pub = ecref.scalar_mult(LATE)
    eng = _port_engine([pub], tables, jax_filters, b=B4)
    found = eng.search_scheduled(policy=policy, seed=3)
    jeng = jbsgs.BSGSEngine([pub], A, B4, _params(), host_table=tables[1])
    assert _keys(found) == _keys(jeng.search_scheduled(policy=policy, seed=3)) == [LATE]
    n_before = eng.chunk_order(policy, 3).index((LATE - A) // (K * U * 2 * M)) + 1
    assert eng.stats.keys_covered == n_before * K * U * 2 * M


def test_scheduled_bases_equal_initial_bases(tables, jax_filters):
    """The host table's bases equal _initial_base exactly, for two targets,
    and a target at chunk 2's base center is an _ImmediateHit there."""
    hit = _center(2 * K, 0)
    pubs = [ecref.scalar_mult(0xA12345), ecref.scalar_mult(0xB00001)]
    for targets in (pubs, pubs + [ecref.scalar_mult(hit)]):
        eng = _port_engine(targets, tables, jax_filters, b=B4)
        got = eng._scheduled_bases([3, 0, 2, 1])
        for c in range(4):
            try:
                want = eng._initial_base(c * K)
            except bsgs._ImmediateHit as e:
                assert isinstance(got[c], bsgs._ImmediateHit) and got[c].scalar == e.scalar == hit
            else:
                assert torch.equal(got[c][0], want[0]) and torch.equal(got[c][1], want[1])
    found = eng.search_scheduled(policy="random", seed=1, stop_on_first=False)
    assert _keys(found) == sorted([hit, 0xA12345, 0xB00001])


@pytest.mark.parametrize("policy", ["sequential", "random"])
def test_search_scheduled_checkpoint_resume(tables, jax_filters, tmp_path, policy):
    """Kill and resume (tests/test_bsgs.py:147, tests/test_host_resolve.py:
    126): the first run does half the order and stops short of the key's
    chunk; a fresh engine resumes from the file, finds the key once and
    covers each chunk once. A run of another range raises."""
    from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointError, CheckpointManager

    pub = ecref.scalar_mult(LATE)
    seed = next(s for s in range(100) if policy == "sequential" or
                _port_engine([pub], tables, jax_filters, b=B4).chunk_order(policy, s).index(3) >= 2)
    mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)
    eng = _port_engine([pub], tables, jax_filters, b=B4)
    assert eng.search_scheduled(policy, seed, max_chunks=2, checkpoint=mgr,
                                stop_on_first=False) == []
    ck = mgr.load()
    assert (ck.chunks_done, ck.n_chunks, ck.mode, ck.policy) == (2, 4, "bsgs", policy)
    assert ck.keys_covered == 2 * K * U * 2 * M
    eng2 = _port_engine([pub], tables, jax_filters, b=B4)
    found = eng2.search_scheduled(policy, seed, checkpoint=mgr, stop_on_first=False)
    assert _keys(found) == [LATE] and mgr.load().found == [f"{LATE:x}"]
    assert mgr.load().chunks_done == 4 and eng2.stats.keys_covered == 4 * K * U * 2 * M
    # a resumed finished run reports the saved key again
    eng3 = _port_engine([pub], tables, jax_filters, b=B4)
    assert _keys(eng3.search_scheduled(policy, seed, checkpoint=mgr)) == [LATE]
    other = _port_engine([pub], tables, jax_filters, b=0xF00000)
    with pytest.raises(CheckpointError):
        other.search_scheduled(policy, seed, checkpoint=mgr)
