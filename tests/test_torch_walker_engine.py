"""The port's BruteEngine on its walker path (keyhuntm1cpu_tpu_torch/engine/
brute.py, CPU, plain kernel versions) against the JAX package's
BruteEngine with pallas="off": the -e chunk summary word for word and the
lambda*k keys it finds (rmd160, xpoint), the found set and the keys
covered in rmd160 and eth, in order and with -R and -n, and the CLI with
-t 2 on a target file past bucket_max. The shapes are tests/test_brute.py's
(W = 2, U = 64, K = 2, chain_len = 8), so the JAX compiles are shared.
Found keys are compared exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.engine import brute as jbrute  # noqa: E402
from keyhuntm1cpu_tpu_torch import cli  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as tb  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402

from test_torch_walker import JPARAMS, assert_chunks_equal, engines  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["rmd160", "xpoint"])
def test_endomorphism_chunk_and_keys_match_jax(mode):
    k = 0x1234  # tests/test_brute.py's: reached only through the GLV lanes
    lam_k = k * ecref.LAMBDA % ecref.N
    lam2_k = lam_k * ecref.LAMBDA % ecref.N
    jp = dataclasses.replace(JPARAMS, endo=True)
    jeng, eng = engines(mode, [lam_k, lam2_k], 0x1000, 0x1400, jp)
    assert eng.n_qsets == (6 if mode == "rmd160" else 3)
    pts = [ecref.scalar_mult(0x1000 + b + 64) for b in eng._sequential_bases(0)]
    (got,) = assert_chunks_equal(jeng, eng, pts)
    assert (got[:, :256] < eng.n_qsets * 2 * eng.window).sum() >= 2  # e = 1 and e = 2
    found = sorted(f.private_key for f in eng.search())
    assert found == sorted(f.private_key for f in jeng.search()) == sorted([lam_k, lam2_k])
    assert eng.stats.multiplier == jeng.stats.multiplier


@pytest.mark.parametrize("mode,random_mode", [("rmd160", False), ("eth", False),
                                              ("rmd160", True)],
                         ids=["rmd160", "eth", "rmd160-R-n"])
def test_found_set_and_coverage_match_jax(mode, random_mode):
    keys = [1, 2, 33, 300, 511, 1024, 1500, 2047]
    keys += [10 ** 6 + i for i in range(32 - len(keys))]  # out of range
    jp = dataclasses.replace(JPARAMS, random_mode=random_mode, seed=5,
                             seq_per_base=2 * 2 * 129 if random_mode else None)
    jeng, eng = engines(mode, keys, 1, 2049, jp)
    want = jeng.search()
    got = eng.search()
    assert sorted(f.private_key for f in got) == sorted(f.private_key for f in want)
    assert {f.target for f in got} == {f.target for f in want}
    assert eng.stats.keys_covered == jeng.stats.keys_covered
    if not random_mode:
        assert sorted(f.private_key for f in got) == keys[:8]


def test_cli_walker_path_past_bucket_max(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    keys = [0x7, 0x155, 0x1FF]
    rng = np.random.default_rng(3)
    decoys = rng.integers(0, 256, (1 << 16, 20), dtype=np.uint8)
    lines = [hashref.pubkey_to_address(ecref.scalar_mult(k), True) for k in keys]
    lines += [bytes(d).hex() for d in decoys]
    f = tmp_path / "addr.txt"
    f.write_text("\n".join(lines) + "\n")
    args = ["-m", "address", "-f", str(f), "-r", "1:401", "-t", "2", "-u", "64",
            "--chunk-steps", "2", "--device", "cpu", "--all", "-q"]
    assert cli.main(args) == 0
    out = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    assert sorted(int(ln.split()[-1], 16) for ln in out.splitlines()
                  if ln.startswith("Private key:")) == keys
    assert tb.probe.launches == 0  # the CPU run took the probe's plain version
