"""The port's copies of the host-side reference helpers (ref/ecref,
ref/hashref, core/log, core/security) against the JAX package's originals
on the same seeded inputs. Exact python-int and byte arithmetic: the
tolerance is exact equality."""

import numpy as np
import pytest

pytest.importorskip("torch")

from keyhuntm1cpu_tpu.core import log as jlog  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref as jec  # noqa: E402
from keyhuntm1cpu_tpu.ref import hashref as jhash  # noqa: E402
from keyhuntm1cpu_tpu_torch.core import log as tlog  # noqa: E402
from keyhuntm1cpu_tpu_torch.core.security import SecureBuffer  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref as tec  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import hashref as thash  # noqa: E402


def _scalars(n, seed=11):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]
    return ks + [1, 2, 3, tec.N - 1, tec.N - 2, 1 << 64, (1 << 63) + 12345]


def test_constants_match():
    for name in ("P", "N", "GX", "GY", "B", "G"):
        assert getattr(tec, name) == getattr(jec, name)


def test_point_ops_match():
    ks = _scalars(12)
    for k1, k2 in zip(ks, ks[1:] + ks[:1]):
        p1, p2 = tec.scalar_mult(k1), tec.scalar_mult(k2)
        assert p1 == jec.scalar_mult(k1) and tec.is_on_curve(p1)
        assert tec.point_add(p1, p2) == jec.point_add(p1, p2)
        assert tec.point_double(p1) == jec.point_double(p1)
        assert tec.point_add(p1, tec.point_neg(p1)) is None
        assert tec.point_add(p1, p1) == jec.point_double(p1)
    assert tec.scalar_mult(0) is None and tec.scalar_mult(tec.N) is None


@pytest.mark.parametrize("compressed", [True, False])
def test_pubkey_parse_serialize_and_address_match(compressed):
    for k in _scalars(8, seed=12):
        pt = jec.scalar_mult(k)
        raw = tec.serialize_pubkey(pt, compressed)
        assert raw == jec.serialize_pubkey(pt, compressed)
        assert tec.parse_pubkey(raw.hex()) == jec.parse_pubkey(raw.hex()) == pt
        assert thash.pubkey_to_address(pt, compressed) == jhash.pubkey_to_address(pt, compressed)
    with pytest.raises(ValueError):
        tec.parse_pubkey("05" + "00" * 32)


def test_ripemd160_and_base58check_match():
    rng = np.random.default_rng(13)
    for n in (0, 1, 55, 56, 63, 64, 65, 200):
        data = rng.bytes(n)
        assert thash.ripemd160(data) == jhash.ripemd160(data)
        payload = b"\x00\x00" + data
        assert thash.b58check_encode(payload) == jhash.b58check_encode(payload)


def test_logger_levels_match(capsys, tmp_path):
    """The port's logger prints what the JAX logger prints at every level
    (-q, default, -d), its status lines become plain lines under matrix
    mode and in a file sink, and result lines always print."""
    assert tlog.LEVELS == jlog.LEVELS and tlog._PREFIX == jlog._PREFIX
    outs = []
    for mod in (tlog, jlog):
        lg = mod.Logger()
        lg.set_level("warn")
        lg.plus("hidden")
        lg.warn("shown")
        lg.result("always")
        lg.set_level("debug")
        lg.debug("d")
        lg.info("i")
        lg.matrix = True
        lg.status("tick")
        lg.set_level("plus")
        lg.debug("hidden")
        lg.info("hidden")
        lg.add_file_sink(str(tmp_path / f"{mod.__name__}.log"))
        lg.status("tock")
        lg.error("e")
        for f in lg.__dict__.get("_files", lg.__dict__.get("_sinks"))[-1:]:
            f.close()
        outs.append(capsys.readouterr().err.splitlines())
    assert outs[0] == outs[1] == ["[W] shown", "[+] always", "[D] d", "[I] i", "[+] tick",
                                  "[+] tock", "[E] e"]
    assert ((tmp_path / f"{tlog.__name__}.log").read_text()
            == (tmp_path / f"{jlog.__name__}.log").read_text() == "[+] tock\n[E] e\n")


def test_secure_buffer_stages_and_wipes():
    with SecureBuffer(16) as sb:
        sb.write(b"secret", 2)
        assert bytes(sb.view()[:8]) == b"\0\0secret"
        with pytest.raises(ValueError):
            sb.write(b"x" * 17)
        sb.close()
    sb.close()  # idempotent
