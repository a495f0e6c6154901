"""Reference file interop of the port (keyhuntm1cpu_tpu_torch/utils/
{legacy,xxhash}.py, filter/bloom.py, native.py and the target caches of
utils/targets.py) held to the JAX package byte for byte: XXH64 vectors,
the .blm (v4 and the old _3_ layout with its migration), .tbl and .dat
files written with the same sha256 from the same inputs and read by the
other package, export_reference_files at m = 4096, K6's x32 assembly (its
plain version here) against the host walk, the npz target caches, and the
native bulk address parse. Exact checks."""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.filter import bloom as jbloom  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu.utils import legacy as jleg  # noqa: E402
from keyhuntm1cpu_tpu.utils import targets as jtargets  # noqa: E402
from keyhuntm1cpu_tpu.utils.xxhash import xxh64 as jxxh64  # noqa: E402
from keyhuntm1cpu_tpu_torch import native  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bloom as tbloom  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils import legacy as tleg  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils import targets as ttargets  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.xxhash import xxh64 as txxh64  # noqa: E402

torch.set_num_threads(1)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_xxh64_vectors_match_jax():
    """The canonical vectors of tests/test_legacy.py and the vectorized
    specializations, in both packages."""
    msg = bytes((i * 13 + 1) & 0xFF for i in range(100))
    for n, want in [(0, 5285565135405403709), (8, 12390309947818504701),
                    (31, 7449453051459588252), (32, 3871888702456516128),
                    (100, 7272568505423433165)]:
        assert txxh64(msg[:n], 0x9747B28C) == jxxh64(msg[:n], 0x9747B28C) == want
    m1 = np.array([(i * 7 + 3) & 0xFF for i in range(32)], dtype=np.uint8)[None, :]
    assert int(tleg.xxh64_32bytes(m1, 0x59F2815B16F81798)[0]) == 18418651583189093914
    rng = np.random.default_rng(5)
    x32 = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    h20 = rng.integers(0, 256, (64, 20), dtype=np.uint8)
    seeds = rng.integers(0, 2**63, 64, dtype=np.uint64)
    assert np.array_equal(tleg.xxh64_32bytes(x32, seeds), jleg.xxh64_32bytes(x32, seeds))
    assert np.array_equal(tleg.xxh64_20bytes(h20, seeds), jleg.xxh64_20bytes(h20, seeds))
    v = rng.integers(0, 2**63, 64, dtype=np.uint64)
    assert np.array_equal(tbloom.xxh64_u64(v, 7), jbloom.xxh64_u64(v, 7))
    assert txxh64(h20[3].tobytes(), 11) == int(tleg.xxh64_20bytes(h20[3:4], 11)[0])


def test_bloom_filter_npz_loads_in_either_package(tmp_path):
    keys = np.arange(1, 5001, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    t = tbloom.BloomFilter.create(5000)
    t.add(keys)
    j = jbloom.BloomFilter.create(5000)
    j.add(keys)
    assert np.array_equal(t.array, j.array) and (t.bits, t.hashes) == (j.bits, j.hashes)
    t.save(str(tmp_path / "t.npz"))
    j.save(str(tmp_path / "j.npz"))
    a = jbloom.BloomFilter.load(str(tmp_path / "t.npz"))
    b = tbloom.BloomFilter.load(str(tmp_path / "j.npz"))
    assert a.check(keys).all() and b.check(keys).all()
    assert np.array_equal(a.array, b.array)


@pytest.fixture(scope="module")
def x32():
    """X(j*G) for j = 1..4096, from the JAX package's host walk."""
    return jleg.baby_x_bytes(4096)


def test_blm_tbl_dat_same_bytes_and_cross_read(tmp_path, x32):
    """Files written from the same x32 and values have the same sha256, and
    each package reads the other's (checksums verified)."""
    blooms = {}
    for tag, leg in (("j", jleg), ("t", tleg)):
        bl = [leg.LegacyBloom.create(1000) for _ in range(256)]
        for s in range(256):
            sel = x32[x32[:, 0] == s]
            if len(sel):
                bl[s].add(sel)
        blooms[tag] = bl
        leg.write_blm(str(tmp_path / f"{tag}4.blm"), bl)
        leg.write_old_blm(str(tmp_path / f"{tag}3.blm"), bl)
        order = np.lexsort(tuple(x32[:64, i] for i in range(21, 15, -1)))
        leg.write_tbl(str(tmp_path / f"{tag}.tbl"), x32[:64, 16:22][order],
                      np.arange(64, dtype=np.uint64)[order])
        leg.write_dat(str(tmp_path / f"{tag}.dat"), x32[:300, :20], multiplier=2)
    for ext in ("4.blm", "3.blm", ".tbl", ".dat"):
        assert _sha(tmp_path / f"j{ext}") == _sha(tmp_path / f"t{ext}"), ext
    for reader, other in ((tleg, "j"), (jleg, "t")):
        got = reader.read_blm(str(tmp_path / f"{other}4.blm"))
        old = reader.read_old_blm(str(tmp_path / f"{other}3.blm"))
        for g, o, w in zip(got, old, blooms["j"]):
            assert (g.entries, g.bits, g.nbytes, g.hashes) == (w.entries, w.bits, w.nbytes,
                                                               w.hashes)
            assert np.array_equal(g.bf, w.bf) and np.array_equal(o.bf, w.bf)
        value, index = reader.read_tbl(str(tmp_path / f"{other}.tbl"))
        assert sorted(index.tolist()) == list(range(64))
        assert np.array_equal(value[np.argsort(index)], x32[:64, 16:22])
        bloom, values = reader.read_dat(str(tmp_path / f"{other}.dat"))
        assert bloom.entries == 10000 and bloom.check(x32[:300, :20]).all()
        assert {v.tobytes() for v in values} == {v.tobytes() for v in x32[:300, :20]}


def test_oldbloom_migration_matches_jax(tmp_path, x32):
    """_3_ -> _4_ migration by the port writes the v4 file the JAX
    migration writes; corruption is detected by both readers."""
    for leg, d in ((jleg, "j"), (tleg, "t")):
        os.makedirs(tmp_path / d)
        leg.export_reference_files(str(tmp_path / d), 1024, x32=x32[:1024])
        blooms = leg.read_blm(str(tmp_path / d / "keyhunt_bsgs_4_1024.blm"))
        os.remove(tmp_path / d / "keyhunt_bsgs_4_1024.blm")
        leg.write_old_blm(str(tmp_path / d / "keyhunt_bsgs_3_1024.blm"), blooms)
        got, migrated = leg.load_level1_blooms(str(tmp_path / d), 1024)
        assert migrated and len(got) == 256
    assert (_sha(tmp_path / "j" / "keyhunt_bsgs_4_1024.blm")
            == _sha(tmp_path / "t" / "keyhunt_bsgs_4_1024.blm"))
    assert tleg.verify_against_ecref(str(tmp_path / "j"), 1024)
    p = tmp_path / "t" / "keyhunt_bsgs_3_1024.blm"
    data = bytearray(p.read_bytes())
    data[tleg.OLDBLOOM_STRUCT + 3] ^= 0xFF
    p.write_bytes(bytes(data))
    for leg in (jleg, tleg):
        with pytest.raises(ValueError, match="checksum"):
            leg.read_old_blm(str(p))


def test_export_reference_files_equal_to_jax_at_m_4096(tmp_path, x32):
    """The port's export on the CPU (its own host walk) is byte-identical
    to the JAX export, file for file, and verifies against ecref."""
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jp = jleg.export_reference_files(str(tmp_path / "j"), 4096, x32=x32)
    tp = tleg.export_reference_files(str(tmp_path / "t"), 4096, device="cpu")
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp] == [
        "keyhunt_bsgs_4_4096.blm", "keyhunt_bsgs_6_128.blm", "keyhunt_bsgs_7_4.blm",
        "keyhunt_bsgs_2_4.tbl"]
    for a, b in zip(jp, tp):
        assert _sha(a) == _sha(b), b
    assert tleg.verify_against_ecref(str(tmp_path / "t"), 4096, probes=32)
    assert jleg.verify_against_ecref(str(tmp_path / "t"), 4096, probes=32)


def test_x32_by_ladder_equals_the_host_walk(x32):
    """The card's assembly of baby_x_bytes (limb-0 arange scalars, K6 in
    batches, big-endian rows, one copy) run through K6's plain version on
    the CPU, at a batch that leaves a partial last batch."""
    got = tleg.x32_by_ladder(45, torch.device("cpu"), batch=16)
    assert np.array_equal(got, x32[:45])
    assert np.array_equal(tleg.baby_x_bytes(45, "cpu"), x32[:45])
    with pytest.raises(ValueError):
        tleg.baby_x_bytes(4, "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no silent fall back to the host walk
            tleg.baby_x_bytes(4, "cuda")


def _address_file(path, n, planted=(), seed=3, bad=None):
    rng = np.random.default_rng(seed)
    lines = [hashref.b58check_encode(b"\x00" + rng.bytes(20)) for _ in range(n)]
    for i, k in planted:
        lines[i] = hashref.pubkey_to_address(ecref.scalar_mult(k), True)
    if bad is not None:
        lines[bad] = "1BadAddressXXXXXXXXXXXXXXXXXXXXXXX"
    path.write_text("\n".join(lines) + "\n")
    return lines


def test_native_parse_addresses_equals_python_parse(tmp_path):
    lines = _address_file(tmp_path / "a.txt", 300, planted=[(7, 0x1234)])
    got = native.parse_addresses(("\n".join(lines) + "\n\nbogus\n").encode(), 400)
    assert got.shape == (301, 20) and not got[300].any()
    for row, ln in zip(got, lines):
        assert row.tobytes() == hashref.b58check_decode(ln)[1:]
    assert native.hash160(b"abc") == hashref.hash160(b"abc")
    assert native.sha256(b"abc") == hashlib.sha256(b"abc").digest()
    assert native.scalar_mult(0x1234) == ecref.scalar_mult(0x1234)
    assert native.scalar_mult(0) is None
    h = hashref.pubkey_to_hash160(ecref.scalar_mult(0x1234), False)
    assert native.verify_h160([0x1234, 0x1235], h, compressed=False) == [True, False]


def test_bulk_parse_past_10000_lines_matches_jax(tmp_path):
    """Past 10,000 lines the port parses addresses natively; the set equals
    the JAX parse of the same file, and a bad line is still refused."""
    p = tmp_path / "big.txt"
    _address_file(p, ttargets.NATIVE_PARSE_MIN + 1, planted=[(3, 0x77), (9000, 0x99)])
    a = ttargets.parse_target_file(str(p), "address")
    b = jtargets.parse_target_file(str(p), "address")
    assert (a.kind, a.raw, a.labels) == (b.kind, b.raw, b.labels)
    _address_file(p, ttargets.NATIVE_PARSE_MIN + 1, bad=5000)
    with pytest.raises(ValueError):
        ttargets.parse_target_file(str(p), "address")


@pytest.mark.parametrize("kind", ["rmd160", "xpoint", "pubkey"])
def test_npz_target_cache_interchangeable(tmp_path, kind):
    """A cache written by either package loads in the other to the same set."""
    keys = [0x11, 0x2222, 0x333333]
    pts = [ecref.scalar_mult(k) for k in keys]
    text = {"rmd160": [hashref.pubkey_to_hash160(p, True).hex() for p in pts],
            "xpoint": [f"{p[0]:064x}" for p in pts],
            "pubkey": [ecref.serialize_pubkey(p, True).hex() for p in pts]}[kind]
    for writer, reader in ((ttargets, jtargets), (jtargets, ttargets)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir(exist_ok=True)
        f = d / "t.txt"
        f.write_text("\n".join(text) + "\n")
        w = writer.parse_target_file_cached(str(f), kind)
        cpath = writer.cache_path_for(str(f), kind)
        assert cpath == reader.cache_path_for(str(f), kind) and os.path.exists(cpath)
        f.write_text("")  # the cache is keyed by content: point a new file at it
        os.replace(cpath, reader.cache_path_for(str(f), kind))
        r = reader.parse_target_file_cached(str(f), kind)
        assert (r.kind, r.raw, r.labels, r.pubkeys) == (w.kind, w.raw, w.labels, w.pubkeys)


def test_reference_dat_written_and_read_through(tmp_path, monkeypatch):
    """write_reference_dat writes the JAX package's bytes; each package's
    parse_target_file_cached reads the other's .dat from the cwd."""
    f = tmp_path / "addr.txt"
    _address_file(f, 50, planted=[(1, 5), (2, 6)])
    ts = ttargets.parse_target_file(str(f), "address")
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    tpath = ttargets.write_reference_dat(str(f), ts, dirpath=str(tmp_path / "t"))
    jpath = jtargets.write_reference_dat(str(f), jtargets.parse_target_file(str(f), "address"),
                                         dirpath=str(tmp_path / "j"))
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert _sha(tpath) == _sha(jpath)
    for mod, cwd in ((ttargets, "j"), (jtargets, "t")):
        monkeypatch.chdir(tmp_path / cwd)
        got = mod.parse_target_file_cached(str(f), "address")
        assert got.kind == "hash160" and sorted(got.raw) == sorted(ts.raw)
    assert not list(tmp_path.glob("data_*_address.npz"))  # the .dat answered first
    with pytest.raises(ValueError):
        ttargets.write_reference_dat(str(f), ttargets.targets_from_ints("xpoint", [5]))
