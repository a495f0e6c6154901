"""Port BSGS device resolve (keyhuntm1cpu_tpu_torch) vs the JAX package, on
the CPU, its pieces:

- the baby table the port builds (native seed, the K1/K2 walk, one stable
  sort) equals JAX host_baby_table(m) and the JAX engine's device build
  word for word (hi, lo, idx), at m = 512 and at m not a multiple of
  build_block (a kept prefix; several walk steps in slices);
- the bitmap and bloom2 built from the table (K3's bitmap-only and
  bloom-only forms) equal JAX build_bitmap_device / build_bloom2_device;
- filtered_lookup with and without its bloom2 stage equals the JAX one,
  the all-pass overflow poison included;
- the device-resolve chunk summary equals, word for word, the reference
  composition: walk.walk_fused keys into JAX filtered_lookup, packed as
  bsgs._pallas_chunk_impl packs them, with real and all-ones filters;
- table files load in both packages; a bad checksum raises ValueError
  unless the check is skipped (-6).

Integer arithmetic: the tolerance is exact equality."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import points, walk  # noqa: E402
from keyhuntm1cpu_tpu.engine import bsgs as jbsgs  # noqa: E402
from keyhuntm1cpu_tpu.filter import bitmap as jb  # noqa: E402
from keyhuntm1cpu_tpu.filter import sorted_table as jst  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as st  # noqa: E402

torch.set_num_threads(1)
U, K = 16, 4
A, B = 0xA00000, 0xB00000


def _jax_params(m, **kw):
    return jbsgs.BSGSParams(m=m, block_u=U, steps_per_chunk=K, chain_len=8, **kw)


def _port_table(m, build_block):
    params = bsgs.BSGSParams(m=m, block_u=U, steps_per_chunk=K, build_block=build_block)
    return bsgs.BSGSEngine([ecref.G], 1, 2, params, device="cpu").table


def _planes(table):
    return [np.asarray(a) for a in (table.hi, table.lo, table.idx)]


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("m,build_block,blocks,slice_", [
    (512, 128, None, None), (700, 128, None, None), (700, 64, 2, "2")],
    ids=["m512", "m700_prefix", "m700_sliced_steps"])
def test_baby_table_matches_jax(monkeypatch, m, build_block, blocks, slice_):
    if blocks is not None:  # five walk steps of 2 blocks, 2-step slices, a kept prefix
        monkeypatch.setattr(bsgs, "BUILD_BLOCKS", blocks)
        monkeypatch.setenv("KEYHUNT_STREAM_SLICE", slice_)
    got = st.table_planes(_port_table(m, build_block))
    for want in (_planes(jbsgs.host_baby_table(m)),
                 _planes(jbsgs.BSGSEngine([ecref.G], 1, 2, _jax_params(
                     m, build_block=build_block)).table) if blocks is None else None):
        if want is not None:
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert sorted(got[2].tolist()) == list(range(1, m + 1))


@pytest.fixture(scope="module")
def table700():
    """The port's table at m = 700 and the JAX SortedXTable of its planes."""
    t = _port_table(700, 128)
    hi, lo, idx = st.table_planes(t)
    return t, jst.SortedXTable(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx))


@pytest.mark.parametrize("bits,b2bits", [(None, None), (12, 20), (24, 32)])
def test_filters_from_table_match_jax(table700, bits, b2bits):
    t, jt = table700
    bm = bmp.build_bitmap_device(t, bits)
    jbm = jb.build_bitmap_device(jt.hi, jt.lo, bits)
    assert bm.bits_log2 == jbm.bits_log2
    assert np.array_equal(_u32(bm.words), np.asarray(jbm.words))
    b2 = bmp.build_bloom2_device(t, b2bits)
    jb2 = jb.build_bloom2_device(jt.hi, jt.lo, b2bits)
    assert b2.bits_log2 == jb2.bits_log2 == (b2bits or jb.bloom2_bits_log2(700))
    assert np.array_equal(_u32(b2.words), np.asarray(jb2.words))
    assert bmp.bloom2_bits_log2(700) == jb.bloom2_bits_log2(700)
    assert [bmp.bloom2_bits_log2(1 << e) for e in (10, 28, 30)] == [16, 32, 32]


def _lookup_inputs(seed=3):
    """A table with duplicated keys (found2), and 4096 queries: table keys
    (duplicates among them), near misses and random keys."""
    rng = np.random.default_rng(seed)
    n = 1500
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    dup = rng.choice(n, 40, replace=False)
    hi[dup[20:]], lo[dup[20:]] = hi[dup[:20]], lo[dup[:20]]
    idx = rng.permutation(n).astype(np.uint32) + 1
    pick = rng.integers(0, n, 1200)
    qhi = np.concatenate([hi[pick], hi[pick[:300]], rng.integers(0, 1 << 32, 2596,
                                                                 dtype=np.uint64).astype(np.uint32)])
    qlo = np.concatenate([lo[pick], lo[pick[:300]] ^ 1, rng.integers(0, 1 << 32, 2596,
                                                                     dtype=np.uint64).astype(np.uint32)])
    perm = rng.permutation(len(qhi))
    return hi, lo, idx, qhi[perm], qlo[perm]


def test_sorted_table_device_matches_jax():
    """build_sorted_table_device (one stable device sort) equals the JAX
    one and the host build, duplicated keys kept in payload order."""
    hi, lo, idx, _, _ = _lookup_inputs()
    got = st.build_sorted_table_device(*(torch.from_numpy(a.view(np.int32)) for a in (hi, lo, idx)))
    want = jst.build_sorted_table_device(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx))
    assert all(np.array_equal(g, w) for g, w in zip(st.table_planes(got), _planes(want)))
    host = st.build_sorted_table(hi, lo, idx)
    assert torch.equal(got.key, host.key) and torch.equal(got.idx, host.idx)


@pytest.mark.parametrize("bm2,C,C1,ones", [
    (False, 2048, None, False), (False, 256, None, False), (True, 512, 2048, False),
    (True, 64, 2048, False), (True, 512, 1024, False), (True, 512, None, True),
    (False, 512, None, True)],
    ids=["one_stage", "one_stage_overflow", "two_stage", "stage2_overflow",
         "stage1_overflow", "all_pass_two_stage", "all_pass_one_stage"])
def test_filtered_lookup_matches_jax(bm2, C, C1, ones):
    hi, lo, idx, qhi, qlo = _lookup_inputs()
    table = st.build_sorted_table(hi, lo, idx)
    jtable = jst.build_sorted_table(hi, lo, idx)
    bits, b2bits = 12, 13  # ~1/3 of the random queries pass the bitmap
    bm, b2 = bmp.build_bitmap_device(table, bits), bmp.build_bloom2_device(table, b2bits)
    if ones:
        bm.words.fill_(-1)
        b2.words.fill_(-1)
    jbm = jb.DeviceBitmap(jnp.asarray(_u32(bm.words)), bits)
    jb2 = jb.DeviceBloom2(jnp.asarray(_u32(b2.words)), b2bits)
    q = [torch.from_numpy(a.view(np.int32)) for a in (qhi, qlo)]
    got = bmp.filtered_lookup(bm, table, *q, C, bm2=b2 if bm2 else None, stage1_max=C1)
    want = jb.filtered_lookup(jbm, jtable, jnp.asarray(qhi), jnp.asarray(qlo), C,
                              bm2=jb2 if bm2 else None, stage1_max=C1)
    assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
    for g, w in zip(got.result, want.result):
        assert np.array_equal(g.numpy().view(np.uint32) if g.dtype == torch.int32
                              else g.numpy(), np.asarray(w))
    assert int(got.n_candidates) == int(want.n_candidates)
    n_true = int(want.n_candidates)
    assert bool(np.asarray(want.result.found2).any()) or ones or n_true > C
    if ones and bm2:
        assert n_true > (C1 or 4 * C)  # the stage-1 overflow is poisoned past C


M2 = 1 << 12


@pytest.fixture(scope="module")
def dev_engine_parts():
    """The port's table at m = 2^12 and its filters (bitmap 2^24 bits,
    bloom2 2^16), beside the JAX structures of the same words."""
    t = _port_table(M2, 4096)
    bm, b2 = bmp.build_bitmap_device(t, 24), bmp.build_bloom2_device(t)
    hi, lo, idx = st.table_planes(t)
    return (t, bm, b2), (jst.SortedXTable(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx)),
                         jb.DeviceBitmap(jnp.asarray(_u32(bm.words)), 24),
                         jb.DeviceBloom2(jnp.asarray(_u32(b2.words)), b2.bits_log2))


def _center(step, u):
    return A + M2 + (step * U + u - 1) * 2 * M2


@pytest.mark.parametrize("two_stage,ones", [(True, False), (False, False), (True, True)],
                         ids=["bloom2", "one_stage", "all_pass_overflow"])
def test_chunk_summary_matches_reference_composition(dev_engine_parts, two_stage, ones):
    """Targets: a plain key, a key on a walk lane (dx == 0 at step 1,
    u = 5) and a key that makes the LAST advance of the chunk hit
    P == -ADV (every walked row stays valid in both implementations)."""
    (t, bm, b2), (jt, jbm, jb2) = dev_engine_parts
    ks = [0xA12345, _center(1, 5), _center(K - 1, U)]
    T = len(ks)
    pubs = [ecref.scalar_mult(k) for k in ks]
    params = bsgs.BSGSParams(m=M2, block_u=U, steps_per_chunk=K,
                             cascade2="on" if two_stage else "off")
    eng = bsgs.BSGSEngine(pubs, A, B, params, device="cpu", table=t, bitmap=bm)
    C1, C2 = eng.C1, eng.C2
    if ones:  # every query survives both levels: poison and C2 overflow
        bm, b2 = (bmp.DeviceBitmap(torch.full_like(bm.words, -1), bm.bits_log2),
                  bmp.DeviceBloom2(torch.full_like(b2.words, -1), b2.bits_log2))
        jbm = jb.DeviceBitmap(jnp.full_like(jbm.words, 0xFFFFFFFF), jbm.bits_log2)
        jb2 = jb.DeviceBloom2(jnp.full_like(jb2.words, 0xFFFFFFFF), jb2.bits_log2)
        C1, C2 = 128, 32
    px, py = eng._initial_base(0)
    _, _, got = bsgs.chunk_impl(px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, bm, t,
                                b2 if two_stage else None, U=U, K=K, T=T, C1=C1, C2=C2)

    jeng = jbsgs.BSGSEngine(pubs, A, B, _jax_params(M2), table=jt, bitmap=jbm)
    base = jeng._initial_base(0)
    cx, cy = base.x, base.y
    qh, ql, dg, ad = [], [], [], []
    wf = jax.jit(walk.walk_fused)
    for _ in range(K):
        r = wf(points.PointBatch(cx, cy, jnp.zeros((T,), bool)), jeng.tab_x,
               jeng.tab_y, jeng.adv_x, jeng.adv_y)
        hi, lo = jst.trunc64_from_limbs(r.x_plus)
        qh.append(hi), ql.append(lo), dg.append(r.degenerate), ad.append(r.adv_degenerate)
        cx, cy = r.adv_x, r.adv_y
    qhi = jnp.stack(qh, 1).reshape(-1)  # rows t*K + s
    qlo = jnp.stack(ql, 1).reshape(-1)
    deg = jnp.stack(dg, 1).reshape(T * K, U)
    adv_flat = jnp.stack(ad, 1).reshape(-1)
    deg = deg.at[:, U - 1].set(deg[:, U - 1] | adv_flat)
    fl = jb.filtered_lookup(jbm, jt, qhi, qlo, C2, bm2=jb2 if two_stage else None,
                            stage1_max=C1)
    Bq = T * K * U
    live = ~deg.reshape(-1)[jnp.minimum(fl.pos, Bq - 1)]
    r = fl.result
    want = np.asarray(jnp.concatenate([
        jnp.where((r.found | r.found2) & live, fl.pos, Bq).astype(jnp.int32),
        jnp.where(r.found & live, r.idx, 0).astype(jnp.int32),
        jnp.where(r.found2 & live, r.idx2, 0).astype(jnp.int32),
        jnp.stack([deg.sum(axis=1).astype(jnp.int32),
                   jnp.argmax(deg, axis=1).astype(jnp.int32),
                   adv_flat.astype(jnp.int32)]).reshape(-1),
        fl.n_candidates[None],
    ]))
    assert got.shape == want.shape == (3 * C2 + 3 * T * K + 1,)
    assert np.array_equal(got.numpy(), want)
    degsum = want[3 * C2: 3 * C2 + 3 * T * K].reshape(3, T, K)
    assert degsum[0, 1, 1] == 1 and degsum[1, 1, 1] == 4  # the dx == 0 lane
    assert degsum[2, 2, K - 1] == 1  # the P == -ADV advance
    if ones:
        assert want[-1] > C2
    else:  # the plain key's lane is a live match: its j is the baby index
        hit = np.nonzero(want[:C2] < Bq)[0]
        assert len(hit) and all(want[C2 + c] or want[2 * C2 + c] for c in hit)


def test_table_files_load_in_both_packages(tmp_path, table700):
    """A port file loads in the JAX package and a JAX file in the port, the
    same planes and checksum either way; a bad checksum raises ValueError
    in both unless it is skipped."""
    t, jt = table700
    jparams = _jax_params(700)
    eng = bsgs.BSGSEngine([ecref.G], 1, 2, convert.params_from_jax(jparams), device="cpu",
                          table=t)
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    eng.save_table(port_file)
    jbsgs.BSGSEngine.save_table(SimpleNamespace(table=jt, p=jparams), jax_file)
    with np.load(port_file) as zp, np.load(jax_file) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].dtype == zj[k].dtype and np.array_equal(zp[k], zj[k])
    assert all(np.array_equal(a, b) for a, b in zip(
        _planes(jbsgs.BSGSEngine.load_table(port_file)), st.table_planes(t)))
    for got in (bsgs.BSGSEngine.load_table(jax_file, device="cpu"),
                convert.table_from_jax(*_planes(jt), "cpu")):
        assert torch.equal(got.key, t.key) and torch.equal(got.idx, t.idx)

    with np.load(port_file) as z:
        parts = {k: z[k] for k in z.files}
    parts["idx"] = parts["idx"].copy()
    parts["idx"][[3, 4]] = parts["idx"][[4, 3]]  # two payloads swapped
    bad_file = str(tmp_path / "bad.npz")
    np.savez(bad_file, **parts)
    with pytest.raises(ValueError, match="checksum"):
        bsgs.BSGSEngine.load_table(bad_file, device="cpu")
    with pytest.raises(ValueError, match="checksum"):
        jbsgs.BSGSEngine.load_table(bad_file)
    skipped = bsgs.BSGSEngine.load_table(bad_file, verify_checksum=False, device="cpu")
    assert skipped.idx[3] == t.idx[4] and torch.equal(skipped.key, t.key)
    with pytest.raises(ValueError, match="not sorted"):
        st.table_from_planes(*(a[::-1] for a in st.table_planes(t)))
