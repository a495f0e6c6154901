"""Port CLI (python -m keyhuntm1cpu_tpu_torch.cli) on --device cpu: flag
parsing through the BSGS, brute-force and minikeys engines to
KEYFOUNDKEYFOUND.txt, and the refusals. Found keys are compared exactly."""

import hashlib
import os

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
                   "--device", "cpu", "--resolve", "host", "--all", *ARGS])
    assert rc == 0
    out = (workdir / "KEYFOUNDKEYFOUND.txt").read_text()
    assert all(f"Private key: {k:064x}" in out for k in keys)
    # no key in the range -> rc 1 and no found-key file
    (workdir / "KEYFOUNDKEYFOUND.txt").unlink()
    assert cli.main(["-m", "bsgs", "-f", str(f), "-r", "100000:180000",
                     "--device", "cpu", "--resolve", "host", *ARGS]) == 1
    assert not (workdir / "KEYFOUNDKEYFOUND.txt").exists()


def test_cli_refusals(workdir, monkeypatch):
    f = workdir / "t.pub"
    pt = ecref.scalar_mult(0xA1B2C3)
    f.write_text(f"{2 + (pt[1] & 1):02x}{pt[0]:064x}\n")
    base = ["-f", str(f), "-r", "a00000:b00000", "--device", "cpu", *ARGS]
    assert cli.main(["-m", "minikeys", *base]) == 2  # minikeys takes no -r
    assert cli.main(["-m", "bsgs", "-8", "x" * 58, *base]) == 2  # -8 is for minikeys
    assert cli.main(["-m", "vanity", "-v", "3abc", *base]) == 2  # P2PKH prefixes start with 1
    assert cli.main(["-m", "vanity", "--device", "cpu", "-q"]) == 2  # no prefix
    assert cli.main(["-m", "bsgs", "--sharded", "--resolve", "host", *base]) == 2
    assert cli.main(["-m", "bsgs", "-c", "eth", *base]) == 2  # -c eth needs -m address
    assert cli.main(["-m", "address", *base]) == 2  # a pubkey is no address
    assert cli.main(["-m", "bsgs", "-B", "sideways", *base]) == 2  # no such range order
    assert cli.main(["-m", "bsgs", "--probe-mode", "elem", *base]) == 2  # TPU-only
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


def _found_keys(workdir):
    out = (workdir / "KEYFOUNDKEYFOUND.txt").read_text()
    return sorted(int(ln.split()[-1], 16) for ln in out.splitlines()
                  if ln.startswith("Private key:"))


def test_cli_cpu_vanity_mode(workdir):
    """-m vanity with -v and with a -f prefix file (no floors on the CPU)."""
    addr = hashref.pubkey_to_address(ecref.scalar_mult(0x155))
    assert cli.main(["-m", "vanity", "-v", addr[:6], *BRUTE_ARGS]) == 0
    assert 0x155 in _found_keys(workdir)
    (workdir / "KEYFOUNDKEYFOUND.txt").unlink()
    f = workdir / "prefixes.txt"
    f.write_text(f"\n{addr[:6]}\n")
    assert cli.main(["-m", "vanity", "-f", str(f), *BRUTE_ARGS]) == 0
    out = (workdir / "KEYFOUNDKEYFOUND.txt").read_text()
    assert f"Target: {addr}" in out


def test_cli_cpu_vanity_beside_rmd160_targets(workdir):
    """-v composed with -m rmd160: the exact target and the prefix's key."""
    f = workdir / "t.rmd"
    f.write_text(hashref.pubkey_to_hash160(ecref.scalar_mult(0x9)).hex() + "\n")
    prefix = hashref.pubkey_to_address(ecref.scalar_mult(0x18F))[:6]
    assert cli.main(["-m", "rmd160", "-f", str(f), "-v", prefix, *BRUTE_ARGS]) == 0
    assert {0x9, 0x18F} <= set(_found_keys(workdir))


def test_cli_bsgs_policy_and_checkpoint(workdir):
    """-B backward --checkpoint twice (tests/test_cli.py:71): the first run
    stops after 2 chunks short of the key, the second resumes and finds it."""
    key = 0xA1B2C3
    pt = ecref.scalar_mult(key)
    f = workdir / "t.pub"
    f.write_text(f"{2 + (pt[1] & 1):02x}{pt[0]:064x}\n")
    ck = str(workdir / "ck.json")
    args = ["-m", "bsgs", "-f", str(f), "-r", "a00000:b00000", "--device", "cpu",
            "--resolve", "host", "-B", "backward", "--checkpoint", ck, *ARGS]
    assert cli.main(args + ["--max-chunks", "2"]) == 1  # backward starts at the top
    from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointManager

    saved = CheckpointManager(ck).load()
    assert (saved.policy, saved.chunks_done) == ("backward", 2)
    assert cli.main(args) == 0
    assert _found_keys(workdir) == [key]
    assert cli.main(args + ["-B", "random"]) == 2  # another order than the saved one


@pytest.mark.parametrize("look,mode", [("compress", "rmd160"), ("uncompress", "address_u"),
                                       ("both", "rmd160_both")])
def test_cli_vanity_look_mapping(workdir, monkeypatch, look, mode):
    """-m vanity maps -l to the fused mode (tests/test_cli.py:190); on the
    card it raises U and K to the JAX CLI's floors."""
    from keyhuntm1cpu_tpu_torch.engine import brute

    captured = {}

    class Stub:
        def __init__(self, targets, a, b, mode=None, params=None, device=None, **kw):
            captured.update(mode=mode, params=params, device=device, **kw)
            self.p, self.stats = params, brute.SearchStats()

        def search(self, **kw):
            return []

    monkeypatch.setattr(brute, "BruteEngine", Stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for device, u, k in (("cpu", 128, 2), ("cuda", 4096, 32)):
        assert cli.main(["-m", "vanity", "-v", "1Love", "-r", "1:100000", "-l", look,
                         "-u", "128", "--chunk-steps", "2", "--device", device, "-q"]) == 1
        assert captured["mode"] == mode and captured["device"] == device
        assert (captured["params"].block_u, captured["params"].steps_per_chunk) == (u, k)
        assert captured["prefixes"] == ["1Love"] and len(captured["intervals"]) > 0


def _pub_file(path, key):
    pt = ecref.scalar_mult(key)
    path.write_text(f"{2 + (pt[1] & 1):02x}{pt[0]:064x}\n")
    return str(path)


def test_cli_bsgs_device_resolve_by_default(workdir):
    """-m bsgs without --resolve resolves on the device (the JAX CLI's
    default): the key is found and no host table is built."""
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    assert cli.main(["-m", "bsgs", "-f", f, "-r", "a00000:a40000", "--device", "cpu",
                     *ARGS]) == 0
    assert _found_keys(workdir) == [0xA1B2C3]
    assert not (workdir / "tc").exists()  # the host table's cache dir


def test_cli_bsgs_save_table_roundtrip(workdir, capsys, monkeypatch):
    """-S builds the table and writes keyhunt_tpu_baby_<m>.npz; a second run
    loads it (the log says so) and finds the key; a file of another m is
    rebuilt, not used."""
    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])  # an earlier -q lingers
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    args = ["-m", "bsgs", "-f", f, "-r", "a00000:a40000", "--device", "cpu", "-S",
            "--m-babies", "512", "-u", "64", "--chunk-steps", "4"]
    assert cli.main(args) == 0
    assert (workdir / "keyhunt_tpu_baby_512.npz").exists()
    assert "saved baby table to keyhunt_tpu_baby_512.npz" in capsys.readouterr().err
    assert cli.main(args + ["-6"]) == 0
    assert "loaded baby table from keyhunt_tpu_baby_512.npz" in capsys.readouterr().err
    assert set(_found_keys(workdir)) == {0xA1B2C3}
    assert cli.main(args[:-6] + ["--m-babies", "1024", "-u", "64", "--chunk-steps", "4",
                                 "--table-file", "keyhunt_tpu_baby_512.npz"]) == 0
    assert "not m=1024; building anew" in capsys.readouterr().err


def test_cli_bsgs_resolve_host_ignores_save_table(workdir, capsys, monkeypatch):
    """--resolve host -S warns and ignores -S (the JAX CLI's rule); -S
    beside -m rmd160 writes the reference data_<8hex>.dat instead."""
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    assert cli.main(["-m", "bsgs", "-f", f, "-r", "a00000:a40000", "--device", "cpu",
                     "--resolve", "host", "-S", *ARGS]) == 0
    assert "-S/--table-file ignored" in capsys.readouterr().err
    assert not list(workdir.glob("*.npz"))
    h = workdir / "h160.txt"
    h.write_text(hashref.pubkey_to_hash160(ecref.scalar_mult(0x7)).hex() + "\n")
    assert cli.main(["-m", "rmd160", "-f", str(h), *BRUTE_ARGS]) == 0
    assert not list(workdir.glob("data_*.dat"))
    assert cli.main(["-m", "rmd160", "-f", str(h), "-S", *BRUTE_ARGS]) == 0
    assert len(list(workdir.glob("data_*.dat"))) == 1


# --- the rest of the JAX CLI's flags ------------------------------------------

REFUSED = {"--probe-mode": "TPU-only"}
VALUES = {"range": "1:2", "mode": "bsgs", "policy": "random", "n_value": "0x100",
          "alphabet": "x" * 58, "vanity": "1A", "minikey_prefix": "Sabcdefghijk",
          "notify_cmd": "true", "checkpoint_every": "1.5", "max_seconds": "2.5",
          "stats_every": "0"}


def test_cli_takes_every_jax_option(workdir, capsys, monkeypatch):
    """Every option string of the JAX CLI's parser parses in the port's to
    the same destination; the one refused says why."""
    from keyhuntm1cpu_tpu import cli as jcli
    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    seen = set()
    for act in jcli.build_parser()._actions:
        if not act.option_strings or act.dest == "help":
            continue
        for opt in act.option_strings:
            seen.add(opt)
            if act.nargs == 0 or act.nargs == "?":
                val = []
            elif act.choices:
                val = [list(act.choices)[-1]]
            else:
                val = [VALUES.get(act.dest, "2")]
            base = [] if act.dest == "mode" else ["-m", "bsgs"]
            ns = cli.build_parser().parse_args([*base, opt, *val])
            assert hasattr(ns, act.dest), opt
            if opt in REFUSED:
                rc = cli.main(["-m", "bsgs", "-f", f, "-r", "a00000:a40000",
                               "--device", "cpu", opt, *val])
                assert rc == 2 and REFUSED[opt] in capsys.readouterr().err, opt
    assert set(REFUSED) <= seen and len(seen) > 60


def _stub_bsgs(monkeypatch):
    """Replace the BSGS engine with a stub that records its params."""
    from keyhuntm1cpu_tpu_torch.engine import bsgs, common

    captured = {}

    class Stub:
        def __init__(self, pubs, a, b, params, device=None, table=None):
            captured.update(params=params, device=device)
            self.stats, self.bitmap = common.SearchStats(), type("B", (), {"bits_log2": 0})
            self.table = None

        def search_scheduled(self, **kw):
            captured.update(kw)
            return []

    monkeypatch.setattr(bsgs, "BSGSEngine", Stub)
    return captured


def test_cli_config_file_defaults_and_precedence(workdir, monkeypatch, capsys):
    """--config supplies defaults; explicit flags win; KEYHUNT_* env beats
    the file; a config without m_babies keeps -n/-k sizing; TPU-only
    fields are warned about; a missing file is rc 2 (tests/test_cli.py)."""
    import json

    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    cfg = workdir / "cfg.json"
    cfg.write_text(json.dumps({"m_babies": 512, "block_u": 64, "steps_per_chunk": 4,
                               "quiet": True}))
    rng = ["-r", "a00000:a40000", "--device", "cpu"]
    assert cli.main(["--config", str(cfg), "-m", "bsgs", "-f", f, *rng]) == 0
    assert _found_keys(workdir) == [0xA1B2C3]
    cap = _stub_bsgs(monkeypatch)
    cfg.write_text(json.dumps({"m_babies": 1024, "block_u": 16, "steps_per_chunk": 4,
                               "bsgs_policy": "dance", "seed": 7, "probe_mode": "sorted",
                               "table_comm": "ring"}))
    assert cli.main(["--config", str(cfg), "-m", "bsgs", "-f", f, *rng, "-u", "32"]) == 1
    p = cap["params"]
    assert (p.m, p.block_u, p.steps_per_chunk) == (1024, 32, 4)
    assert (cap["policy"], cap["seed"]) == ("dance", 7)
    err = capsys.readouterr().err
    assert "probe_mode='sorted' is TPU-only" in err and "table_comm" not in err
    assert p.table_comm == "ring"  # the sharded table's schedule, read from the file
    monkeypatch.setenv("KEYHUNT_BLOCK_U", "48")
    assert cli.main(["--config", str(cfg), "-m", "bsgs", "-f", f, *rng]) == 1
    assert cap["params"].block_u == 48
    monkeypatch.delenv("KEYHUNT_BLOCK_U")
    cfg.write_text(json.dumps({"block_u": 16, "steps_per_chunk": 4}))
    assert cli.main(["--config", str(cfg), "-m", "bsgs", "-f", f, "-r", "1:100000",
                     "-n", "0x10000", "-k", "2", "--device", "cpu", "-q"]) == 1
    assert cap["params"].m == 256 * 2
    assert cli.main(["--config", str(workdir / "none.json"), "-m", "bsgs", "-f", f,
                     *rng]) == 2
    cfg.write_text(json.dumps({"mode": "bsgs", "stride": 3}))  # refused by validate
    assert cli.main(["--config", str(cfg), "-m", "bsgs", "-f", f, *rng]) == 2


def test_cli_filter_mult_and_host_table_cache(workdir, capsys, monkeypatch):
    """-z 4 enlarges the BSGS bitmap to scaled_bits_log2(m, 4) bits;
    --host-table-cache DIR puts the host table there and not in the
    default cache dir."""
    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger
    from keyhuntm1cpu_tpu_torch.filter.bitmap import default_bits_log2, scaled_bits_log2

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    args = ["-m", "bsgs", "-f", f, "-r", "a00000:a40000", "--device", "cpu",
            "--m-babies", "512", "-u", "64", "--chunk-steps", "4"]
    assert cli.main(args + ["-z", "4"]) == 0
    bits = scaled_bits_log2(512, 4)
    assert bits == default_bits_log2(512) + 2
    assert f"bitmap 2^{bits} bits" in capsys.readouterr().err
    assert cli.main(args + ["--resolve", "host", "--host-table-cache",
                            str(workdir / "htc")]) == 0
    assert list((workdir / "htc").iterdir()) and not (workdir / "tc").exists()
    assert f"bitmap 2^{bits - 2} bits" in capsys.readouterr().err  # host resolve, CPU
    assert cli.main(args + ["-z", "0"]) == 2


def test_cli_save_dat_in_rmd160_mode_and_read_back(workdir, capsys, monkeypatch):
    """-S in rmd160 mode writes the reference data_<8hex>.dat in the cwd; a
    second run reads its targets from it and finds the same keys."""
    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger
    from keyhuntm1cpu_tpu_torch.utils.legacy import dat_cache_path, read_dat

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])
    keys = [0x7, 0x155]
    h = workdir / "h160.txt"
    h.write_text("".join(hashref.pubkey_to_hash160(ecref.scalar_mult(k)).hex() + "\n"
                         for k in keys))
    args = ["-m", "rmd160", "-f", str(h), "-S", "-r", "1:401", "-u", "128",
            "--chunk-steps", "4", "--device", "cpu", "--all"]
    assert cli.main(args) == 0
    dat = dat_cache_path(str(h))
    assert f"wrote {dat}" in capsys.readouterr().err
    _, values = read_dat(dat)
    assert sorted(v.tobytes() for v in values) == sorted(
        hashref.pubkey_to_hash160(ecref.scalar_mult(k)) for k in keys)
    first = _found_keys(workdir)
    (workdir / "KEYFOUNDKEYFOUND.txt").unlink()
    assert cli.main(args) == 0
    err = capsys.readouterr().err
    assert f"read 2 targets from the reference cache {os.path.abspath(dat)}" in err
    assert "wrote" not in err
    assert _found_keys(workdir) == first == keys


def test_cli_notify_stats_debug_matrix_and_compat_flags(workdir, capsys, monkeypatch):
    """--notify-cmd gets each found key (a failing command loses nothing);
    -s 0 prints no progress, -s 1 does; -d prints debug lines; -M sets
    matrix mode; -E is accepted and ignored; --uncompressed is -l
    uncompress."""
    import sys

    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger

    log = get_logger()
    monkeypatch.setattr(log, "level", LEVELS["plus"])
    monkeypatch.setattr(log, "matrix", False)
    script = workdir / "notify.py"
    script.write_text("import sys\nopen(sys.argv[1], 'a').write(' '.join(sys.argv[2:]) + '\\n')\n")
    h = workdir / "h.txt"
    target = hashref.pubkey_to_hash160(ecref.scalar_mult(0x155), False).hex()
    h.write_text(target + "\n")
    base = ["-m", "rmd160", "-f", str(h), "-r", "1:401", "-u", "128", "--chunk-steps", "2",
            "--device", "cpu", "--uncompressed"]
    notify = f"{sys.executable} {script} {workdir / 'n.txt'}"
    assert cli.main(base + ["--notify-cmd", notify, "-s", "0", "-E", "x"]) == 0
    assert (workdir / "n.txt").read_text() == f"{0x155:064x} {target}\n"
    out, err = capsys.readouterr()
    assert "[brute]" not in out and "[D]" not in err
    assert cli.main(base + ["--notify-cmd", str(workdir / "missing-cmd"), "-s", "1",
                            "-d", "-M"]) == 0
    out, err = capsys.readouterr()
    assert "[brute] chunk 1/" in out and "[D] arguments:" in err
    assert "notify command failed" in err and log.matrix
    assert _found_keys(workdir) == [0x155, 0x155]


def test_cli_metrics_port_serves_and_stops(workdir, capsys, monkeypatch):
    """--metrics-port 0 serves the registry during the run (the mode info
    set, keys_covered fed by the engine) and stops with the run."""
    import socket

    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger
    from keyhuntm1cpu_tpu_torch.core.metrics import get_metrics

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])
    h = workdir / "h.txt"
    h.write_text(hashref.pubkey_to_hash160(ecref.scalar_mult(0x9)).hex() + "\n")
    before = get_metrics().snapshot()["counters"].get("keys_covered", 0.0)
    assert cli.main(["-m", "rmd160", "-f", str(h), "-r", "1:401", "-u", "128",
                     "--chunk-steps", "2", "--device", "cpu", "--all",
                     "--metrics-port", "0"]) == 0
    err = capsys.readouterr().err
    port = int(err.split("metrics on http://127.0.0.1:")[1].split("/")[0])
    snap = get_metrics().snapshot()
    keys = float(err.split("keys/s (")[1].split(" keys)")[0])  # the engine's count
    assert keys >= 400 and snap["counters"]["keys_covered"] - before == 2 * keys  # parities
    assert snap["info"]["mode"] == "rmd160"
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


# --- --sharded (parallel/): the JAX CLI's multi-device flags -------------------


@pytest.mark.parametrize("flags", [
    ["--sharded"],
    ["--sharded", "range", "--n-devices", "3"],
    ["--sharded", "table", "--n-devices", "2"],
    ["--sharded", "table", "--n-devices", "3", "--table-comm", "ring", "--cascade2", "on"],
])
def test_cli_cpu_sharded_bsgs_finds_key(workdir, flags):
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    assert cli.main(["-m", "bsgs", "-f", f, "-r", "a00000:b00000", "--device", "cpu",
                     *flags, *ARGS]) == 0
    assert _found_keys(workdir) == [0xA1B2C3]


def test_cli_cpu_sharded_table_saves_and_loads(workdir, capsys, monkeypatch):
    """-S writes the table of a table-sharded run from its shards; a second
    run loads it (the file equals the single-device engine's)."""
    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine, build_baby_table

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    args = ["-m", "bsgs", "-f", f, "-r", "a00000:b00000", "--device", "cpu", "-S",
            "--sharded", "table", "--n-devices", "2", *ARGS[:-1]]
    assert cli.main(args) == 0 and "saved baby table" in capsys.readouterr().err
    table = BSGSEngine.load_table("keyhunt_tpu_baby_512.npz", device="cpu")
    want = build_baby_table(512, 4096, "cpu")
    assert torch.equal(table.key, want.key) and torch.equal(table.idx, want.idx)
    assert cli.main(args) == 0 and "loaded baby table" in capsys.readouterr().err


def test_cli_cpu_sharded_brute_finds_keys(workdir):
    keys = [0x7, 0x155, 0x1FF]
    f = workdir / "addr.txt"
    f.write_text("".join(hashref.pubkey_to_address(ecref.scalar_mult(k)) + "\n"
                         for k in keys))
    assert cli.main(["-m", "address", "-f", str(f), "--sharded", "--n-devices", "2",
                     *BRUTE_ARGS]) == 0
    assert _found_keys(workdir) == keys


def test_cli_sharded_errors_and_warnings(workdir, capsys, monkeypatch):
    """The JAX CLI's: host resolve with --sharded and --sharded table in a
    brute mode exit 2; --table-comm without --sharded table warns."""
    from keyhuntm1cpu_tpu_torch.core.log import LEVELS, get_logger

    monkeypatch.setattr(get_logger(), "level", LEVELS["plus"])
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    base = ["-f", f, "-r", "a00000:a40000", "--device", "cpu", *ARGS[:-1]]
    assert cli.main(["-m", "bsgs", "--sharded", "--resolve", "host", *base]) == 2
    assert "--resolve host applies to the single-device engine" in capsys.readouterr().err
    assert cli.main(["-m", "rmd160", "--sharded", "table", *base]) == 2
    assert "--sharded table applies to bsgs only" in capsys.readouterr().err
    assert cli.main(["-m", "minikeys", "--sharded", "-f", f, "--device", "cpu"]) == 2
    assert cli.main(["-m", "bsgs", "--sharded", "--n-devices", "0", *base]) == 2
    addr = workdir / "addr.txt"
    addr.write_text(hashref.pubkey_to_address(ecref.scalar_mult(0x7)) + "\n")
    brute = ["-m", "address", "-f", str(addr), *BRUTE_ARGS]
    assert cli.main([*brute, "--sharded", "-R"]) == 2  # the shards scan in order
    assert "random mode (-R) is not available" in capsys.readouterr().err
    assert cli.main(["-m", "bsgs", "--table-comm", "ring", *base]) == 0
    assert "--table-comm applies only to --sharded table" in capsys.readouterr().err
    assert cli.main(["-m", "bsgs", "--sharded", "-B", "random", *base]) == 0
    assert "-B random ignored" in capsys.readouterr().err


def test_cli_config_sharded(workdir, monkeypatch):
    """A config file's sharded = true runs --sharded range, n_devices its
    shard count."""
    import json

    from keyhuntm1cpu_tpu_torch import parallel

    seen = []
    real = parallel.ShardedBSGSEngine

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.n_shards)

    monkeypatch.setattr(parallel, "ShardedBSGSEngine", Spy)
    f = _pub_file(workdir / "t.pub", 0xA1B2C3)
    cfg = workdir / "cfg.json"
    cfg.write_text(json.dumps({"sharded": True, "n_devices": 2}))
    assert cli.main(["--config", str(cfg), "-m", "bsgs", "-f", f, "-r", "a00000:a40000",
                     "--device", "cpu", *ARGS]) == 0
    assert seen == [2] and _found_keys(workdir) == [0xA1B2C3]
