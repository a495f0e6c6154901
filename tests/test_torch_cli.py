"""Port CLI (python -m keyhuntm1cpu_tpu_torch.cli) on --device cpu: flag
parsing through the engine to KEYFOUNDKEYFOUND.txt, and the refusals.
Found keys are compared exactly."""

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
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
    assert cli.main(["-m", "address", *base]) == 2
    assert cli.main(["-m", "bsgs", "-B", "random", *base]) == 2
    assert cli.main(["-m", "bsgs", "-b", "24", *base]) == 2  # -r and -b
    assert cli.main(["-m", "bsgs", "-f", str(f), "-q"]) == 2  # no range
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-m", "bsgs", "-f", str(f), "-b", "24", "-q"]) == 2  # no GPU
