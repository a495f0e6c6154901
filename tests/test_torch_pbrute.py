"""The port's fused brute chunk (keyhuntm1cpu_tpu_torch/curve/pbrute.py: K1
plain version, K4 plain version, compaction) against the JAX package's XLA
twin pbrute.xla_brute_chunk, word for word over the packed summary, for
every mode at n_endo = 1 and rmd160 / xpoint at n_endo = 3, with planted
hits and a planted dx == 0 lane; pack_intervals / pack_buckets against the
JAX functions; the bucketed membership against the interval path through
the engine; the compaction's plain version (compact_hits_ref) against the
JAX compaction restated in jnp on the seeded cases of
tests/brute_compact_cases.py, its input checks and its row-overflow
report. Integer arithmetic: the tolerance is exact equality."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.curve import pbrute as jpbrute  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import pbrute, pwalk, tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402
from brute_compact_cases import CASES, make_case  # noqa: E402

torch.set_num_threads(1)
K, U, C = 4, 256, 64
B0 = 10  # base of step 0 = 10*G = tab[9]: dx == 0 at (s=0, u=9)


def artifact(mode, pt):
    if mode == "xpoint":
        return pt[0].to_bytes(32, "big")
    if mode == "eth":
        return hashref.pubkey_to_eth_address(pt)
    return hashref.pubkey_to_hash160(pt, compressed=mode == "rmd160")


def cmp64(mode, raw):
    return (int.from_bytes(raw, "big") & ((1 << 64) - 1) if mode == "xpoint"
            else int.from_bytes(raw[:8], "big"))


def _i32(v):
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())


@pytest.mark.parametrize("mode,n_endo", [(m, 1) for m in pbrute.MODES]
                         + [("rmd160", 3), ("xpoint", 3)])
def test_brute_chunk_summary_matches_xla(mode, n_endo):
    tab_x, tab_y = tables.step_table(ecref.G, U)
    adv = ecref.scalar_mult(U)
    base = ecref.scalar_mult(B0)
    # key(s, u) = B0 + s*U + u + 1; hits at (0, 0), (1, 100), (3, 255)
    keys = [B0 + 1, B0 + U + 101, B0 + 3 * U + 256]
    pts = [ecref.scalar_mult(k) for k in keys]
    if mode == "rmd160":
        pts[1] = ecref.point_neg(pts[1])  # found through the other parity
    vals = [cmp64(mode, artifact(mode, p)) for p in pts]
    vals.append(cmp64(mode, artifact(mode, ecref.scalar_mult(
        ecref.LAMBDA * (B0 + 2 * U + 50) % ecref.N))))  # an e = 1 hit
    tgt = pbrute.pack_intervals(vals, vals)
    assert tgt.shape == (4, 8)
    nx, ny, want = jpbrute.xla_brute_chunk(
        jnp.asarray(fe.int_to_limbs(base[0])), jnp.asarray(fe.int_to_limbs(base[1])),
        jnp.asarray(tab_x), jnp.asarray(tab_y), jnp.asarray(fe.int_to_limbs(adv[0])),
        jnp.asarray(fe.int_to_limbs(adv[1])), jnp.asarray(tgt),
        K=K, U=U, C=C, mode=mode, n_endo=n_endo)
    gx, gy, got = pbrute.brute_chunk(
        _i32(base[0]), _i32(base[1]), pwalk.table_to_limb_major(tab_x, "cpu"),
        pwalk.table_to_limb_major(tab_y, "cpu"), _i32(adv[0]), _i32(adv[1]),
        torch.from_numpy(tgt.view(np.int32)), torch.zeros((8, 128), dtype=torch.int32),
        K=K, U=U, C=C, mode=mode, n_endo=n_endo)
    want = np.asarray(want)
    assert got.numpy().tolist() == want.tolist()
    assert gx.numpy().tolist() == np.asarray(nx).view(np.int32).tolist()
    assert gy.numpy().tolist() == np.asarray(ny).view(np.int32).tolist()
    n_hits = 3 + (n_endo == 3)
    assert want[-1] == n_hits  # every planted hit, nothing else
    assert want[2 * C] == 1 and want[2 * C + K] == 9  # n_deg, first_deg of step 0


def test_pack_intervals_and_buckets_match_jax():
    rng = np.random.default_rng(4)
    for n in (1, 5, 8, 9, 33, 512):
        lo = [int(v) for v in rng.integers(0, 2**63, n)]
        hi = [v + int(d) for v, d in zip(lo, rng.integers(0, 1000, n))]
        assert np.array_equal(pbrute.pack_intervals(lo, hi), jpbrute.pack_intervals(lo, hi))
    for n in (1, 100, 4096):
        vals = [int(v) for v in rng.integers(0, 2**63, n)] + [2**64 - 1]
        assert np.array_equal(pbrute.pack_buckets(vals), jpbrute.pack_buckets(vals))
    for fn, args in ((pbrute.pack_intervals, ([], [])), (pbrute.pack_buckets, ([],))):
        with pytest.raises(ValueError):
            fn(*args)


def _targets(mode, keys, decoys=0):
    raw = [artifact(mode, ecref.scalar_mult(k)) for k in keys]
    width = 32 if mode == "xpoint" else 20
    raw += [hashlib.sha256(f"decoy{i}".encode()).digest()[:width] for i in range(decoys)]
    kind = {"xpoint": "xpoint", "eth": "eth"}.get(mode, "hash160")
    return TargetSet(kind=kind, raw=raw, labels=[str(i) for i in range(len(raw))])


@pytest.mark.parametrize("mode", ["rmd160", "xpoint"])
def test_bucketed_membership_finds_the_interval_paths_keys(mode):
    keys = [3, 77, 500, 1000]
    ts = _targets(mode, keys, decoys=40)
    params = BruteParams(block_u=U, steps_per_chunk=K, chunk_cand=C)
    iv = BruteEngine(ts, 1, 1025, mode=mode, params=params, device="cpu")
    bk = BruteEngine(ts, 1, 1025, mode=mode, device="cpu",
                     params=BruteParams(block_u=U, steps_per_chunk=K, chunk_cand=C,
                                        compare_max=8))
    assert not iv._bucketed and bk._bucketed and bk._n_bucket_rows == 8
    assert bk._tgt.shape == (4, 8) and int(bk._tgt[0, 0]) == 0 and int(bk._tgt[1, 0]) == 1
    want = sorted(f.private_key for f in iv.search())
    assert want == keys
    assert sorted(f.private_key for f in bk.search()) == want


@pytest.mark.parametrize("mode", ["rmd160", "xpoint"])
def test_bucketed_hit_words_match_jax_bucket_compare(mode):
    """K4's plain version, bucketed, word for word against the JAX kernel's
    own formulation: its hash words (hash/phash.py) and its bucket compare
    (curve/pbrute.py:185-200, the high word against btab[r][b & 127])
    written with the same jnp ops outside pallas_call. The Pallas kernel
    itself cannot be the reference here: its interpret mode does not
    compile on the CPU in useful time (xla_brute_chunk's docstring), and
    its XLA twin has interval membership only. One decoy shares a point's
    bucket and high word but not its low word: the half-compare's
    spurious hit must show in both."""
    from keyhuntm1cpu_tpu.hash.phash import _bswap
    from keyhuntm1cpu_tpu.hash import phash as jphash

    b0 = 1 << 40  # key(s, u) = b0 + s*U + u + 1; no dx == 0 lane
    pts, p = [], ecref.scalar_mult(b0 + 1)
    for _ in range(K * U):
        pts.append(p)
        p = ecref.point_add(p, ecref.G)
    planted = [(0, 3), (1, 200), (3, 255)]
    vals = [cmp64(mode, artifact(mode, pts[s * U + u])) for s, u in planted]
    spurious = cmp64(mode, artifact(mode, pts[2 * U + 17])) ^ (1 << 12)
    rng = np.random.default_rng(9)
    vals += [spurious] + [int(v) for v in rng.integers(0, 2**63, 36)]
    tgt = pbrute.pack_intervals([1], [0])  # the empty interval
    btab = pbrute.pack_buckets(vals)
    assert np.array_equal(btab, jpbrute.pack_buckets(vals)) and btab.shape == (8, 128)

    bases = [ecref.scalar_mult(b0 + s * U) for s in range(K)]
    tab_x, tab_y = tables.step_table(ecref.G, U)
    got = pbrute.brute_walk_blocks_ref(
        torch.stack([_i32(q[0]) for q in bases], dim=1),
        torch.stack([_i32(q[1]) for q in bases], dim=1),
        pwalk.table_to_limb_major(tab_x, "cpu"), pwalk.table_to_limb_major(tab_y, "cpu"),
        torch.from_numpy(tgt.view(np.int32)), torch.from_numpy(btab.view(np.int32)),
        mode, 1, btab.shape[0])

    xl = [jnp.asarray(np.array([(q[0] >> (32 * i)) & 0xFFFFFFFF for q in pts],
                               dtype=np.uint32)) for i in range(8)]
    if mode == "xpoint":
        pairs = [(xl[1], xl[0])]
    else:
        pairs = [(_bswap(lo), _bswap(hi)) for lo, hi in
                 (jphash.hash160_parity_words(xl, 2), jphash.hash160_parity_words(xl, 3))]
    jt, jb = jnp.asarray(tgt), jnp.asarray(btab)
    want = jnp.zeros((K * U // 128, 128), jnp.uint32)
    for q, (a, b) in enumerate(pairs):
        a, b = a.reshape(-1, 128), b.reshape(-1, 128)
        ge = (a > jt[0, 0]) | ((a == jt[0, 0]) & (b >= jt[1, 0]))
        le = (a < jt[2, 0]) | ((a == jt[2, 0]) & (b <= jt[3, 0]))
        m = ge & le
        idx = (b & np.uint32(127)).astype(jnp.int32)
        for r in range(btab.shape[0]):
            row = jnp.broadcast_to(jb[r][None, :], a.shape)
            m = m | (a == jnp.take_along_axis(row, idx, axis=-1))
        want = want | (m.astype(jnp.uint32) << q)
    want = np.asarray(want).reshape(K, U)
    assert got.numpy().view(np.uint32).tolist() == want.tolist()
    assert sorted(zip(*np.nonzero(want))) == sorted(planted + [(2, 17)])


def jax_compaction(hits, adeg, C):
    """The JAX chunk's compaction and summary (keyhuntm1cpu_tpu/curve/
    pbrute.py:299-343, pallas_brute_chunk after the kernel), restated with
    the same jnp ops on (K, U) uint32 hit words and (K,) advance flags."""
    LANES = 128
    K, U = hits.shape
    rows2 = hits.reshape(-1, LANES)  # (K*U/128, 128)
    qbits2 = rows2 & jnp.uint32((1 << 30) - 1)
    degf = (rows2 >> 30) & 1
    R = max(8, C // 32)  # row budget
    rowflag = qbits2.max(axis=1)  # (K*U/128,)
    n_rows_t = (rowflag != 0).sum().astype(jnp.int32)
    nr = rows2.shape[0]
    (rsel,) = jnp.nonzero(rowflag != 0, size=R, fill_value=nr)
    rsel = rsel.astype(jnp.int32)
    picked = qbits2[jnp.minimum(rsel, nr - 1)]  # (R, 128)
    picked = jnp.where((rsel < nr)[:, None], picked, 0)
    mask = (picked != 0).reshape(-1)
    n = mask.sum().astype(jnp.int32)
    n = jnp.where(n_rows_t > R, jnp.int32(C + 1), n)
    (ip,) = jnp.nonzero(mask, size=C, fill_value=R * LANES)
    ip = ip.astype(jnp.int32)
    ips = jnp.minimum(ip, R * LANES - 1)
    bits = picked.reshape(-1)[ips]
    pos = rsel[ips // LANES] * LANES + ips % LANES
    pos = jnp.where(ip < R * LANES, pos, K * U)
    bits = jnp.where(ip < R * LANES, bits, 0)
    deg = degf.reshape(K, U)
    n_deg = deg.sum(axis=1).astype(jnp.int32)
    first_deg = jnp.argmax(deg, axis=1).astype(jnp.int32)
    return jnp.concatenate([pos, bits.astype(jnp.int32), n_deg, first_deg,
                            (adeg != 0).astype(jnp.int32), n[None]])


@pytest.mark.parametrize("shape", [(16, 256, 64), (8, 384, 300)], ids=["K16_U256_C64",
                                                                      "K8_U384_C300"])
@pytest.mark.parametrize("case", CASES)
def test_compact_hits_ref_matches_jax_compaction(case, shape):
    K_, U_, C_ = shape
    hits, adeg = make_case(case, K_, U_, C_, seed=CASES.index(case))
    want = np.asarray(jax_compaction(jnp.asarray(hits), jnp.asarray(adeg), C_))
    th, ta = torch.from_numpy(hits.view(np.int32)), torch.from_numpy(adeg)
    got = pbrute.compact_hits_ref(th, ta, C_)
    assert got.dtype == torch.int32 and got.numpy().tolist() == want.tolist()
    assert torch.equal(pbrute.compact_hits(th, ta, C_), got)  # the CPU route
    R = pbrute.row_budget(C_)
    n_rows = int((hits.reshape(-1, 128) & ((1 << 30) - 1)).any(axis=1).sum())
    assert (want[-1] == C_ + 1) == (n_rows > R)
    if case == "over_c":
        assert want[-1] > C_ and (want[:C_] < K_ * U_).all()


def test_compact_hits_checks_its_inputs():
    hits = torch.zeros((4, 256), dtype=torch.int32)
    adeg = torch.zeros(4, dtype=torch.bool)
    for h, a, c in ((hits[:, :200], adeg, 64), (hits.to(torch.int64), adeg, 64),
                    (hits, adeg[:3], 64), (hits, adeg.to(torch.int32), 64), (hits, adeg, 0),
                    (hits.t(), adeg, 64)):
        with pytest.raises(ValueError):
            pbrute.compact_hits(h, a, c)


def test_row_overflow_reports_c_plus_one():
    Kc, Uc = 16, 256  # 32 rows of 128 hit words
    hits = torch.zeros((Kc, Uc), dtype=torch.int32)
    adeg = torch.zeros(Kc, dtype=torch.bool)
    R = max(8, C // 32)
    for r in range(R):  # R flagged rows: fits
        hits.view(-1, 128)[3 * r, r] = 1
    out = pbrute.compact_hits(hits, adeg, C)
    assert int(out[-1]) == R
    pos = out[:C].tolist()
    assert pos[:R] == [3 * r * 128 + r for r in range(R)] and pos[R:] == [Kc * Uc] * (C - R)
    hits.view(-1, 128)[31, 127] = 2  # one row more than the budget
    out = pbrute.compact_hits(hits, adeg, C)
    assert int(out[-1]) == C + 1
    hits[5, 7] = pbrute.HIT_DEGENERATE  # degenerate words count apart
    out = pbrute.compact_hits(hits, adeg, C)
    assert int(out[2 * C + 5]) == 1 and int(out[2 * C + Kc + 5]) == 7


def test_overflow_sends_the_engine_to_a_host_rescan(monkeypatch):
    ts = _targets("rmd160", [5])
    eng = BruteEngine(ts, 1, 1025, mode="rmd160", device="cpu",
                      params=BruteParams(block_u=U, steps_per_chunk=K, chunk_cand=C))
    calls = []
    real = eng._host_rescan_fast
    monkeypatch.setattr(eng, "_host_rescan_fast",
                        lambda s, k: calls.append((s, k)) or real(s, k))
    arr = np.zeros(2 * C + 3 * K + 1, dtype=np.int32)
    arr[:C] = K * U
    arr[-1] = C + 1
    k_eff, found = eng._decode_fast(0, arr)
    assert calls == [(0, K)] and k_eff == K
    assert [f.private_key for f in found] == [5]
