"""Port CLI (python -m keyhuntm1cpu_tpu_torch.cli) on --device cpu: flag
parsing through the BSGS, brute-force and minikeys engines to
KEYFOUNDKEYFOUND.txt, and the refusals. Found keys are compared exactly."""

import hashlib

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch import cli  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import host_table as ht  # noqa: E402

torch.set_num_threads(1)
ARGS = ["--m-babies", "512", "-u", "64", "--chunk-steps", "4", "-q"]


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ht, "DEFAULT_CACHE_DIR", str(tmp_path / "tc"))
    return tmp_path


def test_cli_cpu_finds_keys(workdir):
    keys = [0xA1B2C3, 0xAFFF77]
    pts = [ecref.scalar_mult(k) for k in keys]
    f = workdir / "in.txt"
    f.write_text(f"{2 + (pts[0][1] & 1):02x}{pts[0][0]:064x}\n"
                 f"04{pts[1][0]:064x}{pts[1][1]:064x} label\n\n")
    rc = cli.main(["-m", "bsgs", "-f", str(f), "-r", "a00000:b00000",
                   "--device", "cpu", "--all", *ARGS])
    assert rc == 0
    out = (workdir / "KEYFOUNDKEYFOUND.txt").read_text()
    assert all(f"Private key: {k:064x}" in out for k in keys)
    # no key in the range -> rc 1 and no found-key file
    (workdir / "KEYFOUNDKEYFOUND.txt").unlink()
    assert cli.main(["-m", "bsgs", "-f", str(f), "-r", "100000:180000",
                     "--device", "cpu", *ARGS]) == 1
    assert not (workdir / "KEYFOUNDKEYFOUND.txt").exists()


def test_cli_refusals(workdir, monkeypatch):
    f = workdir / "t.pub"
    pt = ecref.scalar_mult(0xA1B2C3)
    f.write_text(f"{2 + (pt[1] & 1):02x}{pt[0]:064x}\n")
    base = ["-f", str(f), "-r", "a00000:b00000", "--device", "cpu", *ARGS]
    assert cli.main(["-m", "minikeys", *base]) == 2  # minikeys takes no -r
    assert cli.main(["-m", "bsgs", "-8", "x" * 58, *base]) == 2  # -8 is for minikeys
    assert cli.main(["-m", "address", "-v", "1abc", *base]) == 2
    assert cli.main(["-m", "bsgs", "--sharded", *base]) == 2
    assert cli.main(["-m", "bsgs", "-c", "eth", *base]) == 2  # -c eth needs -m address
    assert cli.main(["-m", "address", *base]) == 2  # a pubkey is no address
    assert cli.main(["-m", "bsgs", "-B", "random", *base]) == 2
    assert cli.main(["-m", "bsgs", "-b", "24", *base]) == 2  # -r and -b
    assert cli.main(["-m", "bsgs", "-f", str(f), "-q"]) == 2  # no range
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-m", "bsgs", "-f", str(f), "-b", "24", "-q"]) == 2  # no GPU
    assert cli.main(["-m", "minikeys", "-f", str(f), "-q"]) == 2  # no GPU


BRUTE_ARGS = ["-r", "1:401", "-u", "128", "--chunk-steps", "4", "--device", "cpu",
              "--all", "-q"]


@pytest.mark.parametrize("flags,target", [
    ([], lambda pt: hashref.pubkey_to_address(pt, True)),
    (["-l", "uncompress"], lambda pt: hashref.pubkey_to_hash160(pt, False).hex()),
    (["-c", "eth"], lambda pt: "0x" + hashref.pubkey_to_eth_address(pt).hex()),
])
def test_cli_cpu_address_mode_finds_keys(workdir, flags, target):
    keys = [0x7, 0x155, 0x1FF]
    f = workdir / "addr.txt"
    f.write_text("".join(target(ecref.scalar_mult(k)) + "\n" for k in keys))
    assert cli.main(["-m", "address", "-f", str(f), *flags, *BRUTE_ARGS]) == 0
    out = (workdir / "KEYFOUNDKEYFOUND.txt").read_text()
    assert sorted(int(ln.split()[-1], 16) for ln in out.splitlines()
                  if ln.startswith("Private key:")) == keys


@pytest.mark.parametrize("flags,target", [
    # -m eth is -m address -c eth
    (["-m", "eth"], lambda pt: "0x" + hashref.pubkey_to_eth_address(pt).hex()),
    # a -u the fused path cannot tile runs the walker path
    (["-m", "rmd160", "-u", "1000", "-t", "1"],
     lambda pt: hashref.pubkey_to_hash160(pt, True).hex()),
])
def test_cli_cpu_eth_mode_and_untiled_u(workdir, flags, target):
    keys = [0x9, 0x18F]
    f = workdir / "t.txt"
    f.write_text("".join(target(ecref.scalar_mult(k)) + "\n" for k in keys))
    assert cli.main(["-f", str(f), *BRUTE_ARGS, *flags]) == 0
    out = (workdir / "KEYFOUNDKEYFOUND.txt").read_text()
    assert sorted(int(ln.split()[-1], 16) for ln in out.splitlines()
                  if ln.startswith("Private key:")) == keys


def test_cli_cpu_xpoint_endo_stride(workdir):
    k = ecref.LAMBDA * 0x101 % ecref.N  # reached as lambda * 0x101 with -e
    f = workdir / "x.txt"
    f.write_text(f"{ecref.scalar_mult(k)[0]:064x}\n")
    args = ["-m", "xpoint", "-f", str(f), "-e", "-I", "2", *BRUTE_ARGS]
    assert cli.main(args) == 0
    assert f"Private key: {k:064x}" in (workdir / "KEYFOUNDKEYFOUND.txt").read_text()


def test_cli_cpu_minikeys_finds_key(workdir):
    prefix = "SkeyhuntCLIx"
    alpha = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
    c = 0
    while True:  # the first valid minikey of the scan: counter c < 4096
        mk = prefix + "11111" + "".join(alpha[c // 58 ** i % 58] for i in range(4, -1, -1))
        if hashlib.sha256((mk + "?").encode()).digest()[0] == 0:
            break
        c += 1
    k = int.from_bytes(hashlib.sha256(mk.encode()).digest(), "big")
    f = workdir / "addr.txt"
    f.write_text(hashref.pubkey_to_address(ecref.scalar_mult(k), False) + "\n")
    args = ["-m", "minikeys", "-f", str(f), "-C", prefix, "--max-chunks", "1",
            "--device", "cpu", "-q"]
    assert cli.main(args) == 0
    assert f"Private key: {k:064x}" in (workdir / "KEYFOUNDKEYFOUND.txt").read_text()
