"""The port's target parsing (keyhuntm1cpu_tpu_torch/utils/targets.py)
against the JAX package's (utils/targets.py) on the same files, for every
kind: base58 addresses and hash160 hex (address, rmd160), ETH addresses,
x coordinates and pubkeys. Exact equality of kind, digests, labels and
pubkeys; bad lines raise in both."""

import pytest

pytest.importorskip("torch")

from keyhuntm1cpu_tpu.utils import targets as jtargets  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils import targets  # noqa: E402

PTS = [ecref.scalar_mult(k) for k in (1, 7, 0xABCDEF, ecref.N - 5)]


def _lines(kind):
    if kind in ("address", "rmd160"):
        return ([hashref.pubkey_to_address(p, c) for p in PTS for c in (True, False)]
                + [hashref.pubkey_to_hash160(PTS[1]).hex() + " label"])
    if kind == "eth":
        return (["0x" + hashref.pubkey_to_eth_address(p).hex() for p in PTS[:2]]
                + [hashref.pubkey_to_eth_address(p).hex().upper() for p in PTS[2:]])
    if kind == "xpoint":
        return ([f"{PTS[0][0]:064x}", f"{2 + (PTS[1][1] & 1):02x}{PTS[1][0]:064x}",
                 f"04{PTS[2][0]:064x}{PTS[2][1]:064x} comment"])
    return [f"{2 + (p[1] & 1):02x}{p[0]:064x}" for p in PTS]  # pubkey


@pytest.mark.parametrize("kind", ["address", "rmd160", "eth", "xpoint", "pubkey"])
def test_parse_target_file_matches_jax(kind, tmp_path):
    f = tmp_path / "t.txt"
    f.write_text("\n".join(_lines(kind)) + "\n\n")
    got = targets.parse_target_file(str(f), kind)
    want = jtargets.parse_target_file(str(f), kind)
    assert (got.kind, got.raw, got.labels, got.pubkeys) == (
        want.kind, want.raw, want.labels, want.pubkeys)
    assert len(got) == len(_lines(kind))
    conv = convert.targets_from_jax(want)
    assert (conv.kind, conv.raw, conv.labels, conv.pubkeys) == (
        got.kind, got.raw, got.labels, got.pubkeys)


@pytest.mark.parametrize("kind,line", [("address", "1NotAnAddressXXXXXXXXXXXXXXXXXXXX"),
                                       ("eth", "0x1234"), ("xpoint", "abcd")])
def test_bad_lines_raise_in_both(kind, line, tmp_path):
    f = tmp_path / "t.txt"
    f.write_text(line + "\n")
    for mod in (targets, jtargets):
        with pytest.raises(ValueError):
            mod.parse_target_file(str(f), kind)


@pytest.mark.parametrize("kind", ["hash160", "eth", "xpoint"])
def test_targets_from_ints_matches_jax(kind):
    vals = [1, 0xDEADBEEF, b"\x01" * (32 if kind == "xpoint" else 20)]
    got = targets.targets_from_ints(kind, vals)
    want = jtargets.targets_from_ints(kind, vals)
    assert (got.kind, got.raw, got.labels) == (want.kind, want.raw, want.labels)
