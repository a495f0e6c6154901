"""The port's plain torch hash tile functions (keyhuntm1cpu_tpu_torch/hash/
phash.py, the plain versions of csrc/hash.cuh) against the JAX package's
tile functions (hash/phash.py, run as plain XLA ops on the CPU, as
tests/test_hash.py runs them), against hashlib plus the port's ref/hashref,
and the port's hashref against the JAX package's; the batch hash160s
(K7 hash160_x2_from_batch, K8 hash160_u_from_batch, their plain versions
here) against hash160.hash160_from_x_parity / hash160_from_xy, and
keccak_eth_from_batch (its plain version) against keccak.keccak256_pubkey64,
phash.keccak_eth_words and hashref. Points come from a numpy seed. Integer and byte arithmetic: the tolerance is exact
equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.hash import hash160 as jh160  # noqa: E402
from keyhuntm1cpu_tpu.hash import keccak as jkeccak  # noqa: E402
from keyhuntm1cpu_tpu.hash import phash as jphash  # noqa: E402
from keyhuntm1cpu_tpu.ref import hashref as jhash  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve import tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.hash import phash  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402

torch.set_num_threads(1)
M32 = 0xFFFFFFFF
WORDS = ["parity2", "parity3", "hash160_u", "keccak_eth"]


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(2024)
    ks = [int.from_bytes(rng.bytes(32), "big") % ecref.N for _ in range(13)]
    return [ecref.scalar_mult(k) for k in ks + [1, 2, ecref.N - 1]]


def _limbs(pts, coord):
    return [[(p[coord] >> (32 * i)) & M32 for p in pts] for i in range(8)]


def _port_words(name, pts):
    xl = [torch.tensor(v, dtype=torch.int64) for v in _limbs(pts, 0)]
    yl = [torch.tensor(v, dtype=torch.int64) for v in _limbs(pts, 1)]
    fn = {"parity2": lambda: phash.hash160_parity_words(xl, 2),
          "parity3": lambda: phash.hash160_parity_words(xl, 3),
          "hash160_u": lambda: phash.hash160_u_words(xl, yl),
          "keccak_eth": lambda: phash.keccak_eth_words(xl, yl)}[name]
    return [w.tolist() for w in fn()]


@pytest.mark.parametrize("name", WORDS)
def test_tile_words_match_jax(name, pts):
    xl = [jnp.asarray(np.array(v, dtype=np.uint32)) for v in _limbs(pts, 0)]
    yl = [jnp.asarray(np.array(v, dtype=np.uint32)) for v in _limbs(pts, 1)]
    fn = {"parity2": lambda: jphash.hash160_parity_words(xl, 2),
          "parity3": lambda: jphash.hash160_parity_words(xl, 3),
          "hash160_u": lambda: jphash.hash160_u_words(xl, yl),
          "keccak_eth": lambda: jphash.keccak_eth_words(xl, yl)}[name]
    want = [np.asarray(w).astype(np.int64).tolist() for w in fn()]
    assert _port_words(name, pts) == want


@pytest.mark.parametrize("name", WORDS)
def test_tile_words_match_host_reference(name, pts):
    lo, hi = _port_words(name, pts)
    for j, pt in enumerate(pts):
        if name == "keccak_eth":
            digest = hashref.pubkey_to_eth_address(pt)
        elif name == "hash160_u":
            digest = hashref.hash160(b"\x04" + pt[0].to_bytes(32, "big")
                                     + pt[1].to_bytes(32, "big"))
        else:
            digest = hashref.hash160(bytes([int(name[-1])]) + pt[0].to_bytes(32, "big"))
        assert lo[j] == int.from_bytes(digest[0:4], "little")
        assert hi[j] == int.from_bytes(digest[4:8], "little")


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 33, 44, 63, 64])
def test_keccak_lane_rotation(n):
    v = 0x0123456789ABCDEF
    hi, lo = phash._k_rol64(torch.tensor(v >> 32), torch.tensor(v & M32), n)
    m = n % 64
    want = ((v << m) | (v >> (64 - m))) & ((1 << 64) - 1) if m else v
    assert (int(hi) << 32) | int(lo) == want


def test_hashref_matches_jax(pts):
    rng = np.random.default_rng(9)
    for n in (0, 1, 55, 64, 135, 136, 137, 300):
        data = rng.bytes(n)
        assert hashref.keccak256(data) == jhash.keccak256(data)
        assert hashref.hash160(data) == jhash.hash160(data)
        assert hashref.b58encode(b"\x00\x00" + data) == jhash.b58encode(b"\x00\x00" + data)
    assert hashref.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    for pt in pts:
        assert hashref.pubkey_to_eth_address(pt) == jhash.pubkey_to_eth_address(pt)
        for comp in (True, False):
            assert hashref.pubkey_to_hash160(pt, comp) == jhash.pubkey_to_hash160(pt, comp)
            addr = hashref.pubkey_to_address(pt, comp)
            assert hashref.b58check_decode(addr) == jhash.b58check_decode(addr)
    with pytest.raises(ValueError):
        hashref.b58check_decode(addr[:-1] + ("2" if addr[-1] != "2" else "3"))


def test_batch_hash160_match_jax_and_host_reference():
    rng = np.random.default_rng(77)
    start = ecref.scalar_mult(int.from_bytes(rng.bytes(32), "big") % ecref.N)
    xs, ys = tables.step_table(start, 1024)  # (1024, 8) uint32: i * start
    x = torch.from_numpy(np.ascontiguousarray(xs.T).view(np.int32))
    y = torch.from_numpy(np.ascontiguousarray(ys.T).view(np.int32))
    (le, he), (lo, ho) = phash.hash160_x2_from_batch(x)
    ul, uh = phash.hash160_u_from_batch(x, y)
    got = {name: np.stack([a.numpy().view(np.uint32), b.numpy().view(np.uint32)])
           for name, (a, b) in (("even", (le, he)), ("odd", (lo, ho)), ("u", (ul, uh)))}
    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    for name, words in (("even", jh160.hash160_from_x_parity(jx, jnp.zeros(1024, bool))),
                        ("odd", jh160.hash160_from_x_parity(jx, jnp.ones(1024, bool))),
                        ("u", jh160.hash160_from_xy(jx, jy))):
        np.testing.assert_array_equal(got[name], np.stack([np.asarray(words[0]),
                                                           np.asarray(words[1])]))
    pt = start
    for j in range(1024):
        for name, msg in (("even", b"\x02" + pt[0].to_bytes(32, "big")),
                          ("odd", b"\x03" + pt[0].to_bytes(32, "big")),
                          ("u", ecref.serialize_pubkey(pt, False))):
            d = hashref.hash160(msg)
            assert got[name][:, j].tolist() == [int.from_bytes(d[0:4], "little"),
                                               int.from_bytes(d[4:8], "little")]
        pt = ecref.point_add(pt, start)
    with pytest.raises(ValueError):
        phash.hash160_u_from_batch(x, y[:, :5].contiguous())


def test_batch_keccak_eth_matches_jax_and_host_reference():
    rng = np.random.default_rng(78)
    start = ecref.scalar_mult(int.from_bytes(rng.bytes(32), "big") % ecref.N)
    xs, ys = tables.step_table(start, 300)  # (300, 8) uint32: i * start
    x = torch.from_numpy(np.ascontiguousarray(xs.T).view(np.int32))
    y = torch.from_numpy(np.ascontiguousarray(ys.T).view(np.int32))
    lo, hi = phash.keccak_eth_from_batch(x, y)
    got = np.stack([lo.numpy().view(np.uint32), hi.numpy().view(np.uint32)])
    words = jkeccak.keccak256_pubkey64(jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_array_equal(got, np.stack([np.asarray(words[0]), np.asarray(words[1])]))
    xl = [jnp.asarray(xs[:, i]) for i in range(8)]
    yl = [jnp.asarray(ys[:, i]) for i in range(8)]
    np.testing.assert_array_equal(got, np.stack([np.asarray(w) for w in
                                                 jphash.keccak_eth_words(xl, yl)]))
    pt = start
    for j in range(300):
        d = hashref.pubkey_to_eth_address(pt)
        assert got[:, j].tolist() == [int.from_bytes(d[0:4], "little"),
                                      int.from_bytes(d[4:8], "little")]
        pt = ecref.point_add(pt, start)
    assert phash.keccak_eth_from_batch.launches == 0  # CPU tensors: the plain version
    with pytest.raises(ValueError):
        phash.keccak_eth_from_batch(x, y[:, :5].contiguous())
