"""Port filter cascade (keyhuntm1cpu_tpu_torch/filter/bitmap.py) vs the JAX
package's filter/bitmap.py: bit planes, insert_keys (plain K3: the count
form, the degeneracy counter and the bitmap-only form) against
np.bitwise_or.at, the mask form it replaced, or_bits_into and
build_bitmap, probes, compaction and filtered_survivors in both overflow
regimes. Integer arithmetic: the
tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.filter import bitmap as jb  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as tb  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(11)
N = 4096
HI = RNG.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
LO = RNG.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32).copy())


def _np(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("bits", [16, 32, 33, 35])
def test_bit_planes_match_jax(bits):
    for jfn, tfn in ((jb.bitmap_bit_planes, tb.bitmap_bit_planes),
                     (jb.bloom2_bit_planes, tb.bloom2_bit_planes)):
        jw, jv = jfn(jnp.asarray(HI), jnp.asarray(LO), bits)
        tw, tv = tfn(tb.u32(_t(HI)), tb.u32(_t(LO)), bits)
        assert np.array_equal(np.asarray(jw).astype(np.int64), tw.numpy())
        assert np.array_equal(np.asarray(jv).astype(np.int64), tv.numpy())


def _or_at(bits, hi, lo):
    """np.bitwise_or.at of the keys' bitmap bits into 2^bits zero bits."""
    want = np.zeros(1 << (bits - 5), np.uint32)
    idx = jb._bit_indices(hi, lo, bits)
    np.bitwise_or.at(want, (idx >> np.uint64(5)).astype(np.int64),
                     np.uint32(1) << (idx & np.uint64(31)).astype(np.uint32))
    return want


@pytest.mark.parametrize("bits,b2bits", [(14, 13), (21, 33)])
def test_insert_keys_matches_bitwise_or_at_and_or_bits_into(bits, b2bits):
    w1, w2 = tb.empty_filter(bits, "cpu"), tb.empty_filter(b2bits, "cpu")
    # two batches, each keeping a prefix: the second ORs into words that
    # already hold bits
    half = N // 2
    keeps = (half - 300, half - 17)
    keep = np.zeros(N, bool)
    for start, n_keep in zip((0, half), keeps):
        tb.insert_keys(w1, bits, w2, b2bits, _t(HI[start:start + half]),
                       _t(LO[start:start + half]), n_keep)
        keep[start:start + n_keep] = True
    hi, lo = HI[keep], LO[keep]
    want1 = _or_at(bits, hi, lo)
    want2 = np.zeros(1 << (b2bits - 5), np.uint32)
    np.bitwise_or.at(want2, *jb.bloom2_word_bit_np(hi, lo, b2bits))
    assert np.array_equal(_np(w1), want1)
    assert np.array_equal(_np(w2), want2)
    if b2bits <= 32:  # the JAX scatter-OR on the same keys (keep as OOB index)
        wi, bv = jb.bitmap_bit_planes(jnp.asarray(HI), jnp.asarray(LO), bits)
        wi = jnp.where(jnp.asarray(keep), wi, want1.shape[0])
        got = jb.or_bits_into(jnp.zeros(want1.shape, jnp.uint32), wi, bv)
        assert np.array_equal(np.asarray(got), want1)


def _mask_form(words1, bits, words2, b2bits, qhi, qlo, keep, deg, adeg, bad):
    """K3's plain version before the count form: a (n,) keep mask, and the
    build step's degeneracy count as torch ops."""
    hi, lo = tb.u32(qhi)[keep], tb.u32(qlo)[keep]
    tb._or_into(words1, *tb.bitmap_bit_planes(hi, lo, bits))
    tb._or_into(words2, *tb.bloom2_bit_planes(hi, lo, b2bits))
    bad += (deg & keep).sum()
    bad += adeg.sum()


@pytest.mark.parametrize("bits,b2bits", [(16, 15), (20, 35)])
@pytest.mark.parametrize("n_keep", [0, 1000, N])
def test_insert_keys_count_form_and_bad_counter_match_mask_form(bits, b2bits, n_keep):
    """The count form with the degeneracy counter against the mask form
    it replaced (keep = lane < n_keep, the streaming build's mask) and
    against the JAX or_bits_into; degenerate lanes are planted inside and
    past the kept prefix."""
    rng = np.random.default_rng(bits + n_keep)
    deg = np.zeros(N, bool)
    deg[[0, 999, 1000, N - 1]] = True
    deg[rng.choice(N, 20, replace=False)] = True
    adeg = rng.random(37) < 0.2
    got = [tb.empty_filter(bits, "cpu"), tb.empty_filter(b2bits, "cpu"),
           torch.full((), 5, dtype=torch.int64)]
    want = [t.clone() for t in got]
    tb.insert_keys(got[0], bits, got[1], b2bits, _t(HI), _t(LO), n_keep,
                   torch.from_numpy(deg), torch.from_numpy(adeg), got[2])
    keep = torch.arange(N) < n_keep
    _mask_form(want[0], bits, want[1], b2bits, _t(HI), _t(LO), keep, torch.from_numpy(deg),
               torch.from_numpy(adeg), want[2])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2]) == 5 + int(deg[:n_keep].sum()) + int(adeg.sum())
    wi, bv = jb.bitmap_bit_planes(jnp.asarray(HI), jnp.asarray(LO), bits)
    wi = jnp.where(jnp.arange(N) < n_keep, wi, 1 << (bits - 5))
    jw = jb.or_bits_into(jnp.zeros(1 << (bits - 5), jnp.uint32), wi, bv)
    assert np.array_equal(_np(got[0]), np.asarray(jw))
    assert tb.insert_keys.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("bits", [14, 33])
def test_insert_keys_bitmap_only_matches_jax_build_bitmap(bits):
    """words2 = None: the brute target bitmap's form, duplicates included."""
    hi, lo = np.concatenate([HI, HI[:50]]), np.concatenate([LO, LO[:50]])
    words = tb.empty_filter(bits, "cpu")
    tb.insert_keys(words, bits, None, 0, _t(hi), _t(lo), len(hi))
    jbm = jb.build_bitmap(hi, lo, bits, on_device=False)
    assert np.array_equal(_np(words), np.asarray(jbm.words))


def test_insert_keys_checks_its_inputs():
    w1, w2 = tb.empty_filter(14, "cpu"), tb.empty_filter(13, "cpu")
    hi, lo = _t(HI[:64]), _t(LO[:64])
    deg, adeg = torch.zeros(64, dtype=torch.bool), torch.zeros(3, dtype=torch.bool)
    bad = torch.zeros((), dtype=torch.int64)
    for n_keep in (-1, 65):
        with pytest.raises(ValueError):
            tb.insert_keys(w1, 14, w2, 13, hi, lo, n_keep)
    with pytest.raises(ValueError):  # the flags go together
        tb.insert_keys(w1, 14, w2, 13, hi, lo, 64, deg, None, bad)
    with pytest.raises(ValueError):  # the counter is int64
        tb.insert_keys(w1, 14, w2, 13, hi, lo, 64, deg, adeg, bad.to(torch.int32))
    with pytest.raises(ValueError):
        tb.insert_keys(w1, 14, w2, 13, hi, lo, 64, deg[:63], adeg, bad)
    with pytest.raises(ValueError):
        tb.insert_keys(w1, 15, None, 0, hi, lo, 64)


@pytest.fixture(scope="module")
def filters():
    """Filters over the first 1000 keys, built by the JAX host builders."""
    bm = jb.build_bitmap(HI[:1000], LO[:1000], 14, on_device=False)
    b2 = jb.build_bloom2_host(HI[:1000], LO[:1000], 13)
    return bm, b2, (tb.DeviceBitmap(_t(np.asarray(bm.words)), 14),
                    tb.DeviceBloom2(_t(np.asarray(b2.words)), 13))


def test_probes_match_jax(filters):
    bm, b2, (tbm, tb2) = filters
    assert np.array_equal(np.asarray(jb.probe(bm, jnp.asarray(HI), jnp.asarray(LO))),
                          tb.probe(tbm, _t(HI), _t(LO)).numpy())
    assert np.array_equal(np.asarray(jb.probe_bloom2(b2, jnp.asarray(HI), jnp.asarray(LO))),
                          tb.probe_bloom2(tb2, _t(HI), _t(LO)).numpy())
    assert tb.probe(tbm, _t(HI[:1000]), _t(LO[:1000])).all()


@pytest.mark.parametrize("size", [1, 7, 64, 5000])
def test_compact_positions_matches_jax(size):
    mask = RNG.random(1024) < 0.05
    want = np.asarray(jb.compact_positions(jnp.asarray(mask), size, 1024))
    got = tb.compact_positions(torch.from_numpy(mask), size, 1024)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("C2,C1", [(1024, 4096), (16, 4096), (64, 512)],
                         ids=["no_overflow", "n2_gt_C2", "n1_gt_C1_poison"])
def test_filtered_survivors_matches_jax(filters, C2, C1):
    bm, b2, (tbm, tb2) = filters
    want = jb.filtered_survivors(bm, jnp.asarray(HI), jnp.asarray(LO), C2,
                                 bm2=b2, stage1_max=C1)
    got = tb.filtered_survivors(tbm, _t(HI), _t(LO), C2, bm2=tb2, stage1_max=C1)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.int32), g.numpy())
    n = int(want.n_candidates)
    if C1 == 512:
        assert n > C1 + C2  # stage-1 overflow is poisoned past cand_max
    elif C2 == 16:
        assert C2 < n <= C1
    else:
        assert n <= C2
    # level 1 only (no bloom2)
    want = jb.filtered_survivors(bm, jnp.asarray(HI), jnp.asarray(LO), C2)
    got = tb.filtered_survivors(tbm, _t(HI), _t(LO), C2)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.int32), g.numpy())


TILE = 2048  # keys a block of csrc/probe.cu's fused form takes: kProbeQ * kProbeThreads


@pytest.mark.parametrize("bits", [16, 20])
@pytest.mark.parametrize("case", ["zero", "below", "at", "past", "tile_edge"])
def test_probe_compact_matches_jax(case, bits):
    """The fused probe + compaction's plain version (probe_compact, CPU
    tensors) against the JAX level-1 filtered_survivors, and the port's
    filtered_survivors (level 1, and the cascade with bloom2 whose stage
    1 budget is the case's: an overflow is poisoned to n + cand_max) and
    filtered_lookup through it against the JAX ones. B = 2 tiles + 5 (not
    a multiple of the kernel's tile); no survivors, fewer than the budget,
    exactly the budget, past it, and survivors on both sides of a tile
    boundary."""
    from keyhuntm1cpu_tpu.filter import sorted_table as jst
    from keyhuntm1cpu_tpu_torch.filter import sorted_table as tst

    rng = np.random.default_rng(bits + len(case))
    B = 2 * TILE + 5
    hi = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    members = {"zero": [], "tile_edge": [TILE - 2, TILE - 1, TILE, TILE + 1, B - 1]}.get(
        case, sorted(rng.choice(B, 60, replace=False)))
    words = np.zeros(1 << (bits - 5), np.uint32)
    idx = jb._bit_indices(hi[members], lo[members], bits)
    np.bitwise_or.at(words, (idx >> np.uint64(5)).astype(np.int64),
                     np.uint32(1) << (idx & np.uint64(31)).astype(np.uint32))
    jbm = jb.DeviceBitmap(jnp.asarray(words), bits)
    tbm = tb.DeviceBitmap(_t(words), bits)
    n = int(tb.probe_ref(tbm, _t(hi), _t(lo)).sum())
    assert n >= len(members) and (n == 0) == (case == "zero")
    C = {"zero": 64, "below": n + 40, "at": n, "past": n // 2, "tile_edge": 64}[case]
    got = tb.probe_compact(tbm, _t(hi), _t(lo), C)
    want = jb.filtered_survivors(jbm, jnp.asarray(hi), jnp.asarray(lo), C)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.int32), g.numpy())
    assert int(got.n) == n and tb.probe.launches == 0
    pos = got.pos.numpy()
    assert np.array_equal(pos[: min(n, C)], np.flatnonzero(tb.probe_ref(tbm, _t(hi), _t(lo))
                                                           .numpy())[:C])
    assert (pos[min(n, C):] == B).all()
    if case == "tile_edge":
        assert set(members) <= set(pos.tolist())
    if case == "zero":
        with pytest.raises(ValueError):
            tb.probe_compact(tbm, _t(hi[:0]), _t(lo[:0]), C)
    # the cascade with the case's stage-1 budget, and the exact lookup
    b2 = jb.build_bloom2_host(hi[members[:3]], lo[members[:3]], 13)
    want = jb.filtered_survivors(jbm, jnp.asarray(hi), jnp.asarray(lo), 16, bm2=b2,
                                 stage1_max=max(C, 1))
    got = tb.filtered_survivors(tbm, _t(hi), _t(lo), 16,
                                bm2=tb.DeviceBloom2(_t(np.asarray(b2.words)), 13),
                                stage1_max=max(C, 1))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.int32), g.numpy())
    if n > max(C, 1):
        assert int(got.n_candidates) == n + 16
    keys = np.arange(len(members) + 1, dtype=np.uint32)
    thi, tlo = np.append(hi[members], 7), np.append(lo[members], 9)
    want = jb.filtered_lookup(jbm, jst.build_sorted_table(thi, tlo, keys), jnp.asarray(hi),
                              jnp.asarray(lo), C)
    got = tb.filtered_lookup(tbm, tst.build_sorted_table(thi, tlo, keys), _t(hi), _t(lo), C)
    assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
    for name in ("found", "found2"):
        assert np.array_equal(getattr(got.result, name).numpy(),
                              np.asarray(getattr(want.result, name)))
    for name in ("idx", "idx2"):
        assert np.array_equal(getattr(got.result, name).numpy().view(np.uint32),
                              np.asarray(getattr(want.result, name)))
    assert int(got.n_candidates) == int(want.n_candidates) == n
