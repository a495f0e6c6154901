"""The BSGS chunk's cascade after the level-1 probe in the port
(keyhuntm1cpu_tpu_torch/filter/bitmap.py bloom2_compact, the bloom2 stage;
engine/bsgs.py chunk_summary and chunk_summary_host, the summary with the
exact search) vs the JAX package, on the CPU, each at its own input
contract, through its plain version and through its routed wrapper (which
runs the plain version for CPU tensors):

- the bloom2 stage on the level-1 output of the JAX composition (JAX
  probe and compact_positions, gathers, count) equals the JAX
  filtered_survivors with the same C1, C2: stage-1 padding (the padding's
  key words are the fill key's, as host resolve ships them), a full stage
  1 (they are stage-1 entry C1 - 1's) and no survivors at all;
- the summary of survivors of tests/bsgs_cascade_cases.py (deg without the
  lane U - 1 fix-up, and the advance flags) equals the packing of
  bsgs._pallas_chunk_impl (JAX sorted_table.lookup and the packing ops,
  restated in jnp) and of _pallas_chunk_impl_host, at T = 3, K = 4: rows
  of different first degenerate lanes, lanes that only the advance flag
  makes degenerate, and no survivors; and at the summary kernel's row
  layouts (R not a multiple of the rows a block takes, U not a multiple
  of 16, U = 1, the rows the card reads unaligned);
- the bloom2 stage at its kernel's tile edges (C1 one below, at and one
  above a tile boundary, a single tile);
- the chunk's level-1 stage in its fused form (K2's walk keys and the
  survivor mask of its bitmap probe, pwalk.chunk_multi with a bitmap; the
  mask's ordered compaction, bitmap.mask_compact) equals probe_compact_ref
  over the same keys and the JAX probe and compact_positions, and the
  cascade after it the unfused cascade and the JAX filtered_survivors:
  ragged rows (T*K not a multiple of K2's 64) and columns (U not a
  multiple of 32), T > 1, a C1 overflow with the bloom2 stage's poison,
  and planted dx == 0 lanes;
- the sharded prober (parallel/mesh.py ShardedTableBSGSEngine._probe) on
  2 CPU shards: each prober's all_gather summary equals the JAX
  filtered_lookup of the gathered queries against its shard packed with
  its own walk's rows; the ring's row words and candidates agree with it.

Integer arithmetic: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.filter import bitmap as jb  # noqa: E402
from keyhuntm1cpu_tpu.filter import sorted_table as jst  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import pwalk, tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams, _chunk_walk, _limbs  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as st  # noqa: E402
from keyhuntm1cpu_tpu_torch.parallel import ShardedTableBSGSEngine  # noqa: E402
from bsgs_cascade_cases import (SUMMARY_SHAPES, TILE_EDGES, flags, survivors,  # noqa: E402
                                table_keys)

torch.set_num_threads(1)
T, K, U = 3, 4, 64
R, B = T * K, T * K * U


def _t(a):
    """numpy u32 / int32 / bool -> a torch tensor of the port's dtype."""
    a = np.array(a)  # a writable copy
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _random_words(rng, bits, density):
    """2^(bits-5) filter words, each bit set with probability 1 - 2^-density
    (density 0: all zero)."""
    n = 1 << (bits - 5)
    if density == 0:
        return np.zeros(n, np.uint32)
    w = np.zeros(n, np.uint32)
    for _ in range(density):
        w |= rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return w


@pytest.mark.parametrize("case", ["half", "full", "none"])
def test_bloom2_stage_matches_jax(case):
    """bloom2_compact(_ref) on the JAX level-1 output equals the JAX
    filtered_survivors' bloom2 stage word for word, its padding's key
    words included."""
    rng = np.random.default_rng(16)
    nq, bits, b2bits = 4096, 12, 14
    qhi, qlo = (rng.integers(0, 1 << 32, nq, dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    jbm = jb.DeviceBitmap(jnp.asarray(_random_words(rng, bits, 0 if case == "none" else 1)),
                          bits)
    jb2 = jb.DeviceBloom2(jnp.asarray(_random_words(rng, b2bits, 2)), b2bits)
    mask = jb.probe(jbm, jnp.asarray(qhi), jnp.asarray(qlo))
    n1 = int(mask.sum())
    C1 = {"half": 2 * n1, "full": n1, "none": 64}[case]
    C2 = C1  # room for every survivor: the stage-2 output ends in padding
    pos1 = jb.compact_positions(mask, C1, nq)
    safe1 = np.minimum(np.asarray(pos1), nq - 1)
    stage1 = bmp.ProbeCompact(_t(np.asarray(pos1)), _t(qhi[safe1]), _t(qlo[safe1]),
                              torch.tensor(n1, dtype=torch.int32))
    want = jb.filtered_survivors(jbm, jnp.asarray(qhi), jnp.asarray(qlo), C2, bm2=jb2,
                                 stage1_max=C1)
    b2 = bmp.DeviceBloom2(_t(np.asarray(jb2.words)), b2bits)
    n2 = int(want.n_candidates)
    assert n2 < C2 and (n2 > 0) == (case != "none")
    pad_key = (qhi[safe1[-1]], qlo[safe1[-1]])  # stage-1 entry C1 - 1
    assert (pad_key == (qhi[-1], qlo[-1])) == (case != "full")  # else a real survivor's
    for fn in (bmp.bloom2_compact_ref, bmp.bloom2_compact):
        got = fn(b2, stage1, nq, C2)
        assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
        assert np.array_equal(got.qhi.numpy().view(np.uint32), np.asarray(want.qhi))
        assert np.array_equal(got.qlo.numpy().view(np.uint32), np.asarray(want.qlo))
        assert int(got.n) == n2
        assert (got.qhi.numpy()[n2:].view(np.uint32) == pad_key[0]).all()


@pytest.mark.parametrize("edge", list(TILE_EDGES))
def test_bloom2_stage_tile_edges_match_jax(edge):
    """bloom2_compact(_ref) against the JAX filtered_survivors at C1 one
    below, at and one above a two-tile boundary (n1 = C1: every query
    passes an all-ones bitmap) and in a single tile with stage-1 padding."""
    C1, n1 = TILE_EDGES[edge]
    rng = np.random.default_rng(17 + C1)
    bits, b2bits = 12, 14
    qhi, qlo = (rng.integers(0, 1 << 32, n1, dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    jbm = jb.DeviceBitmap(jnp.asarray(np.full(1 << (bits - 5), 0xFFFFFFFF, np.uint32)), bits)
    jb2 = jb.DeviceBloom2(jnp.asarray(_random_words(rng, b2bits, 2)), b2bits)
    mask = jb.probe(jbm, jnp.asarray(qhi), jnp.asarray(qlo))
    assert int(mask.sum()) == n1
    pos1 = jb.compact_positions(mask, C1, n1)
    safe1 = np.minimum(np.asarray(pos1), n1 - 1)
    stage1 = bmp.ProbeCompact(_t(np.asarray(pos1)), _t(qhi[safe1]), _t(qlo[safe1]),
                              torch.tensor(n1, dtype=torch.int32))
    want = jb.filtered_survivors(jbm, jnp.asarray(qhi), jnp.asarray(qlo), C1, bm2=jb2,
                                 stage1_max=C1)
    b2 = bmp.DeviceBloom2(_t(np.asarray(jb2.words)), b2bits)
    assert 0 < int(want.n_candidates) < n1
    for fn in (bmp.bloom2_compact_ref, bmp.bloom2_compact):
        got = fn(b2, stage1, n1, C1)
        assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
        assert np.array_equal(got.qhi.numpy().view(np.uint32), np.asarray(want.qhi))
        assert np.array_equal(got.qlo.numpy().view(np.uint32), np.asarray(want.qlo))
        assert int(got.n) == int(want.n_candidates)


# (T, K, U, planted dx == 0 lanes (t, s, u, sign: base t*K + s at sign *
# tab[u]; one a target), an all-ones level-1 bitmap (else ~1/4 of its bits
# set), C1 from the survivors n1)
FUSED_CASES = {"ragged": (1, 5, 40, (), False, lambda n1: n1 + 7),
               "multi": (3, 4, 64, (), False, lambda n1: n1),
               "overflow": (2, 3, 48, (), True, lambda n1: n1 // 2),
               "degenerate": (3, 3, 40, ((0, 0, 5, 1), (1, 2, 39, -1), (2, 1, 0, 1)), False,
                              lambda n1: 2 * n1)}


def _fused_walk(T, K, U, plants, bm):
    """pwalk.chunk_multi with the bitmap on the CPU: T targets k_t*G, K
    steps of U columns, step S = 7G (tab[u] = (u + 1)*S), ADV = U*S; each
    plant (t, s, u, sign) moves target t so that its base s is sign *
    tab[u]."""
    ks = [1000003 * (t + 1) for t in range(T)]
    for t, step, u, sign in plants:
        ks[t] = (sign * (u + 1) * 7 - step * U * 7) % ecref.N
    pts = [ecref.scalar_mult(k) for k in ks]
    px = torch.stack([_limbs(p[0], "cpu") for p in pts])
    py = torch.stack([_limbs(p[1], "cpu") for p in pts])
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(7), U)
    adv = ecref.scalar_mult(U * 7)
    return pwalk.chunk_multi(px, py, pwalk.table_to_limb_major(tab_x, "cpu"),
                             pwalk.table_to_limb_major(tab_y, "cpu"), _limbs(adv[0], "cpu"),
                             _limbs(adv[1], "cpu"), K=K, U=U, T=T,
                             adv_tab=pwalk.adv_multiples(adv, K, "cpu"), bitmap=bm)


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_level1_stage_matches_probe_compact_and_jax(case):
    """The level-1 stage with K2's probe: the survivor mask of
    chunk_multi(bitmap=...) compacted by mask_compact(_ref) equals
    probe_compact_ref of the same keys (positions, keys, padding, count)
    and the JAX probe's compact_positions; the cascade through it, with
    the bloom2 stage, equals the unfused cascade and the JAX
    filtered_survivors word for word, the overflow's poison included."""
    T, K, U, plants, ones, c1_of = FUSED_CASES[case]
    rng = np.random.default_rng(22 + len(case))
    bits, b2bits = 12, 14
    words = np.full(1 << (bits - 5), 0xFFFFFFFF, np.uint32)
    if not ones:  # ~1/4 of the keys pass
        words = _random_words(rng, bits, 1) & _random_words(rng, bits, 1)
    bm = bmp.DeviceBitmap(_t(words), bits)
    res = _fused_walk(T, K, U, plants, bm)
    R, B = T * K, T * K * U
    qhi, qlo = res.qhi.reshape(-1), res.qlo.reshape(-1)
    mask = res.survivor_mask
    assert mask.shape == (R, -(-U // 32)) and mask.dtype == torch.int32
    assert torch.equal(mask, bmp.survivor_mask_ref(bm, res.qhi, res.qlo))
    for t, step, u, _ in plants:
        assert bool(res.degenerate[t * K + step, u])
    jq = [jnp.asarray(x.numpy().view(np.uint32)) for x in (qhi, qlo)]
    jbm = jb.DeviceBitmap(jnp.asarray(words), bits)
    jmask = jb.probe(jbm, *jq)
    n1 = int(jmask.sum())
    C1 = c1_of(n1)
    want = bmp.probe_compact_ref(bm, qhi, qlo, C1)
    assert np.array_equal(want.pos.numpy(), np.asarray(jb.compact_positions(jmask, C1, B)))
    assert int(want.n) == n1 and (n1 > C1) == (case == "overflow")
    for fn in (bmp.mask_compact_ref, bmp.mask_compact):
        got = fn(mask, qhi, qlo, C1)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    b2 = _random_words(rng, b2bits, 2)
    jb2 = jb.DeviceBloom2(jnp.asarray(b2), b2bits)
    b2 = bmp.DeviceBloom2(_t(b2), b2bits)
    C2 = C1
    jwant = jb.filtered_survivors(jbm, *jq, C2, bm2=jb2, stage1_max=C1)
    unfused = bmp.filtered_survivors(bm, qhi, qlo, C2, bm2=b2, stage1_max=C1)
    got = bmp.filtered_survivors(bm, qhi, qlo, C2, bm2=b2, stage1_max=C1, mask=mask)
    for a, b, name in zip(got, unfused, got._fields):
        assert torch.equal(a, b)
        w = np.asarray(getattr(jwant, name))
        assert np.array_equal(a.numpy().view(np.uint32) if name in ("qhi", "qlo")
                              else a.numpy(), w)
    assert (int(got.n_candidates) == n1 + C2) == (case == "overflow")


def test_mask_compact_checks_its_inputs():
    """mask_compact raises on a mask whose shape is not (R, ceil(U/32)) for
    R*U keys, on keys of another dtype or shape, and on a negative size."""
    mask = torch.zeros((3, 2), dtype=torch.int32)
    keys = torch.zeros(3 * 40, dtype=torch.int32)
    assert int(bmp.mask_compact(mask, keys, keys, 4).n) == 0
    for m, k, size in ((torch.zeros((3, 1), dtype=torch.int32), keys, 4),  # U = 40: 2 words
                       (torch.zeros((4, 2), dtype=torch.int32), keys, 4),  # 120 keys in 4 rows
                       (mask, keys.to(torch.int64), 4), (mask, keys[:-1], 4),
                       (mask.reshape(-1), keys, 4), (mask, keys, -1)):
        with pytest.raises(ValueError):
            bmp.mask_compact(m, k, k, size)


def _jax_summary(jtable, pos, qhi, qlo, n, deg, adv, rows=None):
    """bsgs._pallas_chunk_impl's packing (jtable None: _pallas_chunk_impl_host's)
    of survivors (pos, qhi, qlo, n) over queries with flags deg (Rc, U),
    adv (Rc,); rows: the summary rows' (deg, adv), default the same."""
    Bq, Uq = deg.size, deg.shape[1]
    rdeg, radv = rows if rows is not None else (deg, adv)
    fix = lambda d, a: jnp.asarray(d).at[:, Uq - 1].set(jnp.asarray(d)[:, Uq - 1]
                                                         | jnp.asarray(a))
    deg, rdeg = fix(deg, adv), fix(rdeg, radv)
    pos = jnp.asarray(pos)
    live = ~deg.reshape(-1)[jnp.minimum(pos, Bq - 1)]
    if jtable is None:
        words = [jnp.where((pos < Bq) & live, pos, Bq).astype(jnp.int32),
                 jax.lax.bitcast_convert_type(jnp.asarray(qhi), jnp.int32),
                 jax.lax.bitcast_convert_type(jnp.asarray(qlo), jnp.int32)]
    else:  # filtered_lookup's search of the survivors, then the packing
        r = jst.lookup(jtable, jnp.asarray(qhi), jnp.asarray(qlo))
        valid = pos < Bq
        found, found2 = r.found & valid, r.found2 & valid
        words = [jnp.where((found | found2) & live, pos, Bq).astype(jnp.int32),
                 jnp.where(found & live, r.idx, 0).astype(jnp.int32),
                 jnp.where(found2 & live, r.idx2, 0).astype(jnp.int32)]
    degsum = jnp.stack([rdeg.sum(axis=1).astype(jnp.int32),
                        jnp.argmax(rdeg, axis=1).astype(jnp.int32),
                        jnp.asarray(radv).astype(jnp.int32)])
    return np.asarray(jnp.concatenate(words + [degsum.reshape(-1),
                                               jnp.asarray([n], dtype=jnp.int32)]))


@pytest.fixture(scope="module")
def small_table():
    """(port table, JAX table, (k,) uint64 hit keys, the last one duplicated)."""
    keys, idx = table_keys(1000)
    hi, lo = (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32)
    hits = np.concatenate([keys[:-2:5], keys[-1:]])
    return st.build_sorted_table(hi, lo, idx), jst.build_sorted_table(hi, lo, idx), hits


@pytest.mark.parametrize("resolve", ["device", "host"])
@pytest.mark.parametrize("case", ["mixed", "adv_only", "none"])
def test_summary_matches_jax(small_table, resolve, case):
    """chunk_summary(_host) and chunk_summary_ref against the JAX packing,
    T*K = 12 rows of U = 64 lanes, C = 64 survivors."""
    table, jtable, hits = small_table
    deg, adv = flags(case, R, U)
    deg0 = deg.copy()
    pos, qhi, qlo, n = survivors(case, 64, deg, adv, hits)
    want = _jax_summary(jtable if resolve == "device" else None, pos, qhi, qlo, n, deg, adv)
    tdeg, tadv = _t(deg), _t(adv)
    args = (_t(pos), _t(qhi), _t(qlo), torch.tensor(n, dtype=torch.int32), tdeg, tadv,
            (tdeg, tadv))
    tab = table if resolve == "device" else None
    routed = (bsgs.chunk_summary(table, *args) if resolve == "device"
              else bsgs.chunk_summary_host(*args))
    for got in (bsgs.chunk_summary_ref(tab, *args), routed):
        assert got.dtype == torch.int32 and got.shape == (3 * 64 + 3 * R + 1,)
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(deg, deg0)  # the caller's flags are not fixed up in place
    C = 64
    degsum = want[3 * C: 3 * C + 3 * R].reshape(3, R)
    if case == "mixed":  # rows 1, 5, 9 start at lanes 37, 59 and 18; rows 2, 6, 10 at U - 1
        assert degsum[1, 1::4].tolist() == [37, 59, 18]
        assert degsum[1, 2::4].tolist() == [U - 1] * 3 and degsum[0, 3::4].tolist() == [1] * 3
    if case == "adv_only":  # only the advance flags: lane U - 1 of every third row
        assert degsum[0].tolist() == degsum[2].tolist() == [1, 0, 0] * 4
        dropped = [c for c in range(C) if pos[c] % U == U - 1 and adv[pos[c] // U]]
        assert dropped and all(want[c] == B for c in dropped)
    if resolve == "device" and case != "none":
        live_hits = want[:C] < B
        assert live_hits.any() and (want[2 * C: 3 * C] > 0).any()  # found2 too
    if case == "none":
        assert (want[:C] == B).all() and want[-1] == 0


@pytest.mark.parametrize("resolve", ["device", "host"])
@pytest.mark.parametrize("shape", list(SUMMARY_SHAPES))
def test_summary_shapes_match_jax(small_table, resolve, shape):
    """chunk_summary(_host) and chunk_summary_ref against the JAX packing
    at the summary kernel's row layouts (tests/bsgs_cascade_cases.py
    SUMMARY_SHAPES), the mixed flags and survivors."""
    table, jtable, hits = small_table
    Rs, Us, C = SUMMARY_SHAPES[shape]
    deg, adv = flags("mixed", Rs, Us)
    pos, qhi, qlo, n = survivors("mixed", C, deg, adv, hits)
    want = _jax_summary(jtable if resolve == "device" else None, pos, qhi, qlo, n, deg, adv)
    tdeg, tadv = _t(deg), _t(adv)
    args = (_t(pos), _t(qhi), _t(qlo), torch.tensor(n, dtype=torch.int32), tdeg, tadv,
            (tdeg, tadv))
    tab = table if resolve == "device" else None
    routed = (bsgs.chunk_summary(table, *args) if resolve == "device"
              else bsgs.chunk_summary_host(*args))
    for got in (bsgs.chunk_summary_ref(tab, *args), routed):
        assert got.shape == (3 * C + 3 * Rs + 1,)
        assert np.array_equal(got.numpy(), want)
    live = want[:C] < Rs * Us
    assert live.any() and (live.sum() < n)  # planted dead lanes dropped
    assert want[3 * C: 3 * C + Rs].sum() > 0  # rows with set flags


@pytest.mark.parametrize("comm", ["all_gather", "ring"])
def test_sharded_probe_matches_jax(comm):
    """2 CPU shards of a baby table, a key in the first sharded chunk, through ShardedTableBSGSEngine._sharded_chunk: each
    prober's summary equals the JAX filtered_lookup of the D sources'
    gathered queries against its table shard, bitmap and bloom2, packed with
    its own walk's rows (all_gather word for word; the ring: the same row
    words and live candidates as a set)."""
    D, m, u, k = 2, 2048, 16, 8
    params = BSGSParams(m=m, block_u=u, steps_per_chunk=k, build_block=256, cascade2="on",
                        table_comm=comm)
    a = 0x500000
    eng = ShardedTableBSGSEngine([ecref.scalar_mult(a + 999)], a, a + D * k * u * 2 * m,
                                 params, devices=[torch.device("cpu")] * D)
    bases = eng._bases_at(0)
    walks = [_chunk_walk(px, py, eng._walk[d].tab_x, eng._walk[d].tab_y, eng._walk[d].adv_x,
                         eng._walk[d].adv_y, u, k, 1, eng._walk[d].adv_tab)
             for (px, py), d in zip(bases, eng.devices)]
    Bs = k * u
    _, (host, _) = eng._sharded_chunk(bases)
    rows = host.numpy()[:-1].reshape(D, -1)
    gq = [np.concatenate([getattr(w[0], f).reshape(-1).numpy().view(np.uint32)
                          for w in walks]) for f in ("qhi", "qlo")]
    gdeg = np.concatenate([w[1].numpy() for w in walks])
    gadv = np.concatenate([w[2].numpy() for w in walks])
    C2 = eng.C2
    n_live = 0
    for e in range(D):
        hi, lo, idx = st.table_planes(eng.shards[e])
        jt = jst.SortedXTable(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx))
        jbm = jb.DeviceBitmap(jnp.asarray(eng.shard_bitmaps[e].words.numpy().view(np.uint32)),
                              eng.shard_bits)
        jb2 = jb.DeviceBloom2(jnp.asarray(eng.shard_blooms[e].words.numpy().view(np.uint32)),
                              eng.shard_b2_bits)
        fs = jb.filtered_survivors(jbm, jnp.asarray(gq[0]), jnp.asarray(gq[1]), C2, bm2=jb2,
                                   stage1_max=eng.C1)
        want = _jax_summary(jt, fs.pos, fs.qhi, fs.qlo, int(fs.n_candidates), gdeg, gadv,
                            rows=(walks[e][1].numpy(), walks[e][2].numpy()))
        n_live += int((want[:C2] < D * Bs).sum())
        if comm == "all_gather":
            assert np.array_equal(rows[e], want)
        else:
            assert np.array_equal(rows[e][3 * C2:-1], want[3 * C2:-1])
            live = lambda r: {tuple(c) for c in r[:3 * C2].reshape(3, C2).T if c[0] < D * Bs}
            assert live(rows[e]) == live(want)
    assert n_live and eng._use_bloom2 and gdeg.shape == (D * k, u)
