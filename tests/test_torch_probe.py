"""The large-target lookup of the port (keyhuntm1cpu_tpu_torch/filter/
bitmap.py, sorted_table.py, utils/targets.py) against the JAX package on
the CPU: probe and probe_bloom2 (the probe kernel's plain versions)
against bitmap.probe (elem mode) and dma_gather in interpret mode plus the
bit test, at bits <= 32 and > 32; build_bitmap (at 2^14 and 2^34 bits)
and TargetSet.build_bitmap against the JAX host builds; filtered_lookup
against bitmap.filtered_lookup with and without overflow and with
duplicate keys; trunc64_from_limbs.
Inputs come from numpy seeds; integer arithmetic, so the tolerance is
exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.filter import bitmap as jb  # noqa: E402
from keyhuntm1cpu_tpu.filter import sorted_table as jst  # noqa: E402
from keyhuntm1cpu_tpu.utils.targets import TargetSet as JTargetSet  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as tb  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as tst  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(31)
N = 3000
HI = RNG.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
LO = RNG.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
M = 700  # the first M keys are the members
G = 800  # queries through the interpreted TPU gather (members and not)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32).copy())


@pytest.mark.parametrize("bits", [14, 20])
def test_build_bitmap_and_probe_match_jax(bits):
    jbm = jb.build_bitmap(HI[:M], LO[:M], bits, on_device=False)
    bm = tb.build_bitmap(HI[:M], LO[:M], bits)
    assert bm.bits_log2 == bits
    assert np.array_equal(bm.words.numpy().view(np.uint32), np.asarray(jbm.words))
    got = tb.probe(bm, _t(HI), _t(LO))
    assert got.dtype == torch.bool and got[:M].all()
    assert np.array_equal(got.numpy(), np.asarray(jb.probe(jbm, jnp.asarray(HI),
                                                            jnp.asarray(LO), mode="elem")))
    # the TPU kernel's gather (interpret mode) plus the bit test
    wi, bv = jb.bitmap_bit_planes(jnp.asarray(HI[:G]), jnp.asarray(LO[:G]), bits)
    words = jb.dma_gather(wi, jbm.words, BQ=64, interpret=True)
    assert np.array_equal(got[:G].numpy(), (np.asarray(words) & np.asarray(bv)) != 0)
    assert tb.probe.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("bits", [14, 34])
def test_build_bitmap_matches_jax_host_build(bits):
    """build_bitmap on the CPU (the host build the card's K3 build is held
    to) against the JAX build_bitmap(on_device=False), word for word, with
    duplicate keys; at 2^34 bits (2 GiB) by the set words and their values."""
    hi, lo = np.concatenate([HI[:M], HI[:9]]), np.concatenate([LO[:M], LO[:9]])
    jw = np.asarray(jb.build_bitmap(hi, lo, bits, on_device=False).words)
    bm = tb.build_bitmap(hi, lo, bits)
    tw = bm.words.numpy().view(np.uint32)
    assert bm.bits_log2 == bits and tw.shape == jw.shape == (1 << (bits - 5),)
    nz = np.flatnonzero(jw)
    assert np.array_equal(np.flatnonzero(tw), nz) and np.array_equal(tw[nz], jw[nz])
    assert len(nz) > M // 2


def test_probe_bloom2_matches_jax():
    b2 = jb.build_bloom2_host(HI[:M], LO[:M], 15)
    t2 = tb.DeviceBloom2(_t(np.asarray(b2.words)), 15)
    got = tb.probe_bloom2(t2, _t(HI), _t(LO))
    assert got[:M].all()
    assert np.array_equal(got.numpy(), np.asarray(jb.probe_bloom2(b2, jnp.asarray(HI),
                                                                  jnp.asarray(LO))))
    wi, bv = jb.bloom2_bit_planes(jnp.asarray(HI[:G]), jnp.asarray(LO[:G]), 15)
    words = np.asarray(jb.dma_gather(wi, b2.words, BQ=64, interpret=True))
    hit = (words & np.asarray(bv)) != 0
    assert np.array_equal(got[:G].numpy(), hit[:G] & hit[G:])
    with pytest.raises(ValueError):
        tb.probe_bloom2(t2, _t(HI).to(torch.int64), _t(LO))


def test_probes_past_32_bits_match_jax_index_math():
    """bits = 33: the word index takes the key's (or its extension mix's)
    high bits. One 1 GiB word array serves both filters; the reference is
    the JAX package's bit planes read from it."""
    bits = 33
    words = torch.zeros(1 << (bits - 5), dtype=torch.int32)
    w_np = words.numpy().view(np.uint32)  # shares the tensor's memory
    for planes in (jb.bitmap_bit_planes, jb.bloom2_bit_planes):
        wi, bv = planes(jnp.asarray(HI[:M]), jnp.asarray(LO[:M]), bits)
        np.bitwise_or.at(w_np, np.asarray(wi).astype(np.int64), np.asarray(bv))
    got1 = tb.probe(tb.DeviceBitmap(words, bits), _t(HI), _t(LO))
    got2 = tb.probe_bloom2(tb.DeviceBloom2(words, bits), _t(HI), _t(LO))
    wi, bv = jb.bitmap_bit_planes(jnp.asarray(HI), jnp.asarray(LO), bits)
    want1 = (w_np[np.asarray(wi).astype(np.int64)] & np.asarray(bv)) != 0
    wi, bv = jb.bloom2_bit_planes(jnp.asarray(HI), jnp.asarray(LO), bits)
    hit = (w_np[np.asarray(wi).astype(np.int64)] & np.asarray(bv)) != 0
    assert np.array_equal(got1.numpy(), want1) and got1[:M].all()
    assert np.array_equal(got2.numpy(), hit[:N] & hit[N:]) and got2[:M].all()


@pytest.mark.parametrize("cand_max", [2048, 64], ids=["fits", "overflow"])
def test_filtered_lookup_matches_jax(cand_max):
    hi, lo = HI[:M].copy(), LO[:M].copy()
    hi[7], lo[7] = hi[3], lo[3]  # a duplicated 64-bit key: found and found2
    idx = np.arange(M, dtype=np.uint32)
    jbm = jb.build_bitmap(hi, lo, 12, on_device=False)  # fp ~ 1/6: survivors
    jtab = jst.build_sorted_table(hi, lo, idx)
    want = jb.filtered_lookup(jbm, jtab, jnp.asarray(HI), jnp.asarray(LO), cand_max)
    got = tb.filtered_lookup(tb.build_bitmap(hi, lo, 12), tst.build_sorted_table(hi, lo, idx),
                             _t(HI), _t(LO), cand_max)
    assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
    for name in ("found", "found2"):
        assert np.array_equal(getattr(got.result, name).numpy(),
                              np.asarray(getattr(want.result, name)))
    for name in ("idx", "idx2"):
        assert np.array_equal(getattr(got.result, name).numpy().view(np.uint32),
                              np.asarray(getattr(want.result, name)))
    assert int(got.n_candidates) == int(want.n_candidates)
    assert (int(want.n_candidates) > cand_max) == (cand_max == 64)
    assert got.result.found2.any()  # the duplicated key, among the first survivors


def test_target_bitmap_and_trunc64_match_jax():
    rng = np.random.default_rng(8)
    for kind, width in (("hash160", 20), ("xpoint", 32)):
        raw = [rng.bytes(width) for _ in range(40)]
        jbm = JTargetSet(kind=kind, raw=raw, labels=["t"] * 40).build_bitmap()
        ts = TargetSet(kind=kind, raw=raw, labels=["t"] * 40)
        bm = ts.build_bitmap()
        assert bm.bits_log2 == jbm.bits_log2 == 18
        assert np.array_equal(bm.words.numpy().view(np.uint32), np.asarray(jbm.words))
        assert ts.build_bitmap() is bm  # memoized per size and device
    x = RNG.integers(0, 2**32, (5, 8), dtype=np.uint64).astype(np.uint32)
    jhi, jlo = jst.trunc64_from_limbs(jnp.asarray(x))
    hi, lo = tst.trunc64_from_limbs(_t(x.T))
    assert np.array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
    assert np.array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
