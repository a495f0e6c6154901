"""Minikey validity (K5) and key derivation of the port
(keyhuntm1cpu_tpu_torch/hash/pminikey.py) against the JAX package on the
CPU: the plain torch versions against pminikey.minikey_valid_tile under
plain jnp, engine/minikeys._xla_valid_impl, the finish's compaction and
key-derivation formula (bitmap.compact_positions, minikeys.py:476-479)
and hashlib. Integer hashes: the tolerance is
exact equality. The CUDA kernels are held to these plain versions on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.engine import minikeys as jmk  # noqa: E402
from keyhuntm1cpu_tpu.hash import pminikey as jpm  # noqa: E402
from keyhuntm1cpu_tpu.hash.sha256 import sha256_block_words  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import minikeys as mk  # noqa: E402
from keyhuntm1cpu_tpu_torch.hash import pminikey  # noqa: E402

torch.set_num_threads(1)
B = 4096
BASE = 58 ** 3 - 1500  # the lanes cross a carry through three digits
PREFIX17 = "SkeyhuntTPUx1abcd"
ALPHABETS = [mk._B58, mk._B58[29:] + mk._B58[:29]]  # canonical, a custom -8 one


def _bases():
    msg = np.zeros((1, 23), dtype=np.uint8)
    msg[0, :17] = np.frombuffer(PREFIX17.encode(), dtype=np.uint8)
    w22 = mk._pack_block_words(msg[:, :22], 22)[0]
    msg[0, 22] = ord("?")
    w23 = mk._pack_block_words(msg, 23)[0]
    return w22, w23


def _t(words):
    return torch.from_numpy(words.astype(np.uint32).view(np.int32).copy())


def _minikey(v, alphabet):
    return PREFIX17 + mk._b58_digits(v, 5, alphabet)


def test_host_helpers_match_jax():
    msg = np.frombuffer(b"S" * 23, dtype=np.uint8)[None, :]
    for n in (22, 23):
        np.testing.assert_array_equal(mk._pack_block_words(msg, n),
                                      jmk._pack_block_words(msg, n))
    for alphabet in ALPHABETS + [mk._B58[::-1]]:
        assert pminikey.b58_runs(alphabet) == jpm.b58_runs(alphabet)
    for v in (0, 57, 58, BASE, 58 ** 5 - 1):
        assert mk._b58_digits(v, 5, ALPHABETS[1]) == jmk._b58_digits(v, 5, ALPHABETS[1])


def test_suffix_digits_match_jax():
    v = BASE + np.arange(B, dtype=np.int64)
    got = pminikey.suffix_digits(torch.from_numpy(v), 5)
    want = jpm.suffix_digits(jnp.asarray(v.astype(np.uint32)), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("alphabet", ALPHABETS, ids=["canonical", "custom"])
def test_minikey_valid_matches_jax_and_hashlib(alphabet):
    _, w23 = _bases()
    got = pminikey.minikey_valid(BASE, _t(w23), B, alphabet).numpy()
    assert got.dtype == np.bool_ and got.shape == (B,)
    v = jnp.asarray((BASE + np.arange(B)).astype(np.uint32))
    tile = jpm.minikey_valid_tile(v, [jnp.uint32(w) for w in w23], jpm.b58_runs(alphabet))
    np.testing.assert_array_equal(got, np.asarray(tile) != 0)
    xla = jmk._xla_valid_impl(jnp.uint32(BASE), jnp.asarray(w23), B=B, alphabet=alphabet)
    np.testing.assert_array_equal(got, np.asarray(xla))
    want = np.array([hashlib.sha256((_minikey(BASE + i, alphabet) + "?").encode()).digest()[0]
                     == 0 for i in range(B)])
    np.testing.assert_array_equal(got, want)
    assert 2 <= got.sum() <= 40  # ~B/256 valid lanes


def _jax_compact_keys(valid, V, w22, alphabet):
    """The JAX composition compact_keys replaces: the count, the exact
    compaction (filter/bitmap.compact_positions) and the key derivation
    of minikeys.py:476-479."""
    from keyhuntm1cpu_tpu.filter.bitmap import compact_positions

    vidx = compact_positions(jnp.asarray(valid), V, B)
    vv = jnp.uint32(BASE) + jnp.minimum(vidx, B - 1).astype(jnp.uint32)
    w4or, w5or = jmk._suffix_or_words(vv, alphabet)
    kw = sha256_block_words(jmk._mk_words(jnp.asarray(w22), w4or, w5or, V))
    return (int(valid.sum()), np.asarray(vidx),
            np.stack([np.asarray(kw[7 - i]) for i in range(8)]))


@pytest.mark.parametrize("case", ["none_valid", "density", "past_V"])
@pytest.mark.parametrize("alphabet", ALPHABETS, ids=["canonical", "custom"])
def test_compact_keys_match_jax_and_hashlib(alphabet, case):
    """compact_keys (its plain version on CPU tensors) against the JAX
    composition and hashlib on K5's mask: no valid lane (every slot a
    fill slot, hashing lane B - 1), the true density with room to spare,
    and more valid lanes than V (the count stays exact)."""
    w22, w23 = _bases()
    valid = pminikey.minikey_valid(BASE, _t(w23), B, alphabet).numpy()
    if case == "none_valid":
        valid[:] = False
    n = int(valid.sum())
    V = {"none_valid": 37, "density": n + 45, "past_V": n // 2}[case]
    n_valid, vidx, k = pminikey.compact_keys(torch.from_numpy(valid), V, BASE, _t(w22), B,
                                             alphabet)
    assert n_valid.dtype == vidx.dtype == k.dtype == torch.int32
    assert tuple(vidx.shape) == (V,) and tuple(k.shape) == (8, V)
    jn, jvidx, jk = _jax_compact_keys(valid, V, w22, alphabet)
    assert int(n_valid) == jn == n and (n > V) == (case == "past_V")
    np.testing.assert_array_equal(vidx.numpy(), jvidx)
    np.testing.assert_array_equal(k.numpy().view(np.uint32), jk)
    np.testing.assert_array_equal(vidx.numpy()[: min(n, V)], np.flatnonzero(valid)[:V])
    assert (vidx.numpy()[min(n, V):] == B).all()
    for j, lane in enumerate(np.minimum(vidx.numpy(), B - 1)):
        want = int.from_bytes(hashlib.sha256(_minikey(BASE + int(lane), alphabet).encode())
                              .digest(), "big")
        assert sum(int(k[i, j].numpy().view(np.uint32)) << (32 * i) for i in range(8)) == want
    assert pminikey.compact_keys.launches == 0  # CPU tensors take the plain version


def test_wrappers_refuse_bad_inputs():
    w22, w23 = _bases()
    with pytest.raises(ValueError):
        pminikey.minikey_valid(0, _t(w23)[:15], B, mk._B58)
    with pytest.raises(ValueError):
        pminikey.minikey_valid(0, _t(w23), B, "abc")
    valid = torch.zeros(B, dtype=torch.bool)
    for bad in (torch.zeros(B, dtype=torch.int64), valid[:-1], valid[::2]):
        with pytest.raises(ValueError):
            pminikey.compact_keys(bad, 64, 0, _t(w22), B, mk._B58)
    with pytest.raises(ValueError):
        pminikey.compact_keys(valid, 0, 0, _t(w22), B, mk._B58)
    with pytest.raises(ValueError):
        pminikey.compact_keys(valid, 64, 0, _t(w22)[:15], B, mk._B58)
