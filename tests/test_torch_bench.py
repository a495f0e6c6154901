"""The port's bench entry (keyhuntm1cpu_tpu_torch.bench, .bench_modes) on
the CPU: main in host and device resolve at m = 1024 with every mode
section at small shapes, the gates' inputs against the JAX protocol's
(recomputed with keyhuntm1cpu_tpu.ref), the rate formulas against
bench.py's and bench_modes.py's, and the failures: a failed gate or
section exits 1 with the line printed, a TPU-only variable exits 2, and a
missing card is an error, never a CPU run. Exact checks (no tolerance)."""

import contextlib
import functools
import io
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import bench as jax_bench  # noqa: E402  (the JAX bench: no jax import at module level)
import bench_modes as jax_bench_modes  # noqa: E402
from keyhuntm1cpu_tpu.engine import minikeys as jax_minikeys  # noqa: E402
from keyhuntm1cpu_tpu.engine.vanity import vanity_intervals as jax_vanity_intervals  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref as jax_ecref  # noqa: E402
from keyhuntm1cpu_tpu.ref import hashref as jax_hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch import _build, bench  # noqa: E402
from keyhuntm1cpu_tpu_torch import bench_modes as bm  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.vanity import vanity_intervals  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import host_table as ht  # noqa: E402

# main at the CPU check's size; the sections at small shapes with their
# production gate keys (one gate chunk each, 2-step rate chunks of 128 keys)
ENV = {"BENCH_M": "1024", "BENCH_U": "16", "BENCH_K": "4", "BENCH_SECONDS": "0.3",
       "BENCH_MODE_SECONDS": "0.1", "BENCH_BITS": ""}
SMALL = dict(gate_shape=(512, 8), bucket_gate_shape=(1024, 4), rate_shape=(128, 2),
             minikey_batch=1024)
SECTIONS = ("bsgs_t16", "rmd160", "xpoint", "eth", "address_u", "minikeys", "vanity",
            "rmd160_endo", "rmd160_T4096")
FIELDS = ("metric", "value", "unit", "vs_baseline", "modes", "gate", "device", "m", "resolve",
          "device_idle_share", "chunks", "seconds", "setup_s", "launches")


@pytest.fixture(scope="module")
def table_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("table_cache"))


def run_main(monkeypatch, table_dir, env, argv=("--device", "cpu"), small=True):
    """bench.main with env, the host table cached in table_dir and (small)
    the small section shapes: (rc, stdout lines, stderr)."""
    monkeypatch.setattr(ht, "DEFAULT_CACHE_DIR", table_dir)
    if small:
        monkeypatch.setattr(bm, "iter_all", functools.partial(bm.iter_all, **SMALL))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(list(argv), env)
    return rc, out.getvalue().strip().splitlines(), err.getvalue()


@pytest.fixture(scope="module", params=["host", "device"])
def main_run(request, table_dir, tmp_path_factory):
    """One full run of main a resolve mode (~25 s on the CPU)."""
    env = dict(ENV, BENCH_RESOLVE=request.param)
    if request.param == "device":
        env["BENCH_TABLE_CACHE"] = str(tmp_path_factory.mktemp("npz") / "baby.npz")
    with pytest.MonkeyPatch.context() as mp:
        rc, lines, _ = run_main(mp, table_dir, env)
    return request.param, rc, lines, env


def test_main_line(main_run):
    resolve, rc, lines, _ = main_run
    assert rc == 0
    line = json.loads(lines[-1])
    assert all(k in line for k in FIELDS)
    assert line["metric"] == "bsgs_keys_per_sec_chip" and line["unit"] == "keys/s"
    assert line["value"] > 0 and line["vs_baseline"] == line["value"] / 1.2e9
    assert line["gate"] == "ok" and line["m"] == 1024 and line["resolve"] == resolve
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["device_idle_share"] is None  # no device metric from a CPU run
    assert list(line["modes"]) == list(SECTIONS)  # bsgs_t16 first, then iter_all's order
    setup = {"host": {"build", "host_table", "prefault", "filters"},
             "device": {"build", "table", "filters"}}
    assert set(line["setup_s"]) == setup[resolve]
    assert set(line["launches"]) == set(_build.kernel_wrappers())
    assert not any(line["launches"].values())  # CPU tensors launch no kernel
    # the line is printed once the headline exists and again after each section
    assert len(lines) == 1 + len(SECTIONS)
    assert [list(json.loads(ln)["modes"]) for ln in lines] == [
        list(SECTIONS[:i]) for i in range(len(SECTIONS) + 1)]


@pytest.mark.parametrize("section", SECTIONS)
def test_section_gate_and_rate(main_run, section):
    res = json.loads(main_run[2][-1])["modes"][section]
    assert res["gate"].startswith("ok") and res["keys_per_sec"] > 0


def test_second_run_reuses_the_table(main_run, monkeypatch, table_dir):
    """A second run takes the first one's table: the host table from the
    cache directory, or the device table from BENCH_TABLE_CACHE."""
    resolve, _, _, env = main_run
    rc, lines, err = run_main(monkeypatch, table_dir, dict(env, BENCH_MODES="0"))
    line = json.loads(lines[-1])
    assert rc == 0 and line["gate"] == "ok" and line["modes"] == {} and len(lines) == 1
    if resolve == "device":
        assert "baby table m=1024 loaded" in err


def test_config_defaults_are_bench_pys():
    cfg = bench.BenchConfig.from_env({})
    assert (cfg.m, cfg.block_u, cfg.steps, cfg.seconds, cfg.cand, cfg.bits_log2, cfg.resolve,
            cfg.cascade2, cfg.table_cache, cfg.modes, cfg.mode_seconds, cfg.profile,
            cfg.device) == (1 << 30, 16384, 256, 20.0, 128, 35, "host", "auto", "", True, 5.0,
                            "", "cuda")
    assert cfg == bench.BenchConfig()
    assert not bench.BenchConfig.from_env({"BENCH_MODES": "off"}).modes
    assert bench.BenchConfig.from_env({"BENCH_BITS": ""}).bits_log2 is None
    assert bench.BenchConfig.from_env({"BENCH_DEVICE": "cpu"}, "cuda").device == "cuda"
    p = bench.BenchConfig.from_env({"BENCH_CAND": "256", "BENCH_RESOLVE": "device"}).params()
    assert p.chunk_cand_max == 256 and p.resolve == "device" and p.build_block == 4096


def test_gate_inputs_equal_the_jax_protocol():
    assert bench.PUZZLE63_KEY == jax_bench.PUZZLE63_KEY == 0x7CCE5EFDACCF6808
    assert bench.PUZZLE64_RANGE == jax_bench.PUZZLE64_RANGE
    assert bench.PUZZLE64_KEY == 0xF7051F27B09112D4
    # the 16 planted keys: default_rng(16) in one 8-step window of the
    # headline's shape (bench_modes.py:246-252)
    for m, u in ((1 << 30, 16384), (1024, 16)):
        params = BSGSParams(m=m, block_u=u)
        window = 8 * u * 2 * m
        rng = np.random.default_rng(16)
        want = sorted((1 << 63) + int(v) for v in rng.integers(0, min(window, 1 << 63), size=16))
        assert bm.t16_planted(params) == (want, window)
    # the first valid minikey of "Sbenchmark1x" (bench_modes.py:161-168)
    for c in range(1 << 18):
        s = ("Sbenchmark1x" + jax_minikeys._b58_digits(c // jax_minikeys.LOW_SPAN, 5)
             + jax_minikeys._b58_digits(c % jax_minikeys.LOW_SPAN, 5))
        if jax_hashref.sha256((s + "?").encode())[0] == 0:
            break
    assert bm.first_minikey() == (c, s, int.from_bytes(jax_hashref.sha256(s.encode()), "big"))
    # key 777's prefix and its intervals (bench_modes.py:200-202)
    pref = jax_hashref.pubkey_to_address(jax_ecref.scalar_mult(777), compressed=True)[:5]
    assert bm.vanity_prefix() == pref
    assert vanity_intervals(pref) == jax_vanity_intervals(pref)


@pytest.mark.parametrize("mode", list(bm.MODE_KIND))
def test_gate_targets_equal_the_jax_protocol(mode):
    """Keys 1..32's artifacts (bench_modes._mk) and, in rmd160, the T = 4096
    set's decoys (bench_modes.py:122-129)."""
    mk = jax_bench_modes._mk(mode)
    want = [mk(jax_ecref.scalar_mult(k)) for k in range(1, 33)]
    ts = bm.gate_targets(mode)
    assert ts.raw == want and ts.labels == [str(k) for k in range(1, 33)]
    assert ts.kind == {"rmd160": "hash160", "xpoint": "xpoint", "eth": "eth",
                       "address_u": "hash160"}[mode]
    if mode == "rmd160":
        import hashlib

        decoys = [hashlib.sha256(f"bench-decoy{i}".encode()).digest()[:20] for i in range(4064)]
        assert bm.gate_targets(mode, 4096).raw == want + decoys


def test_rate_formulas_equal_bench_pys():
    chunks, K, U, m, elapsed = 37, 256, 16384, 1 << 30, 20.25
    stride = 2 * m
    steps = chunks * K  # bench.py:174-175
    assert bm.range_keys_per_sec(chunks, K, U, stride, elapsed) == steps * U * stride / elapsed
    keys, mult, dt = 123 * 16384 * 256, 6, 5.125  # bench_modes.py:80
    assert bm.effective_keys_per_sec(keys, mult, dt) == keys * mult / dt


def test_failed_gate_exits_1_with_the_line(monkeypatch, table_dir):
    """A puzzle-63 search that finds nothing: no rate, the error in the line."""
    monkeypatch.setattr(bench.BSGSEngine, "search", lambda self, **kw: [])
    rc, lines, _ = run_main(monkeypatch, table_dir, dict(ENV, BENCH_RESOLVE="host"))
    line = json.loads(lines[-1])
    assert rc == 1 and line["value"] is None and line["gate"] is None
    assert "puzzle-63 recovery FAILED" in line["error"]


def test_failed_section_exits_1_with_the_line(monkeypatch, table_dir):
    """A section whose gate fails is recorded in modes; the exit code says so."""
    def failing(*a, **kw):
        yield "rmd160", {"keys_per_sec": 1.0, "gate": "ok"}
        raise bm.GateError("xpoint gate FAILED: missing [7]")

    monkeypatch.setattr(bm, "bench_bsgs_multitarget", lambda *a, **kw: {"gate": "ok"})
    monkeypatch.setattr(bm, "iter_all", failing)
    rc, lines, _ = run_main(monkeypatch, table_dir, dict(ENV, BENCH_RESOLVE="host"),
                            small=False)
    line = json.loads(lines[-1])
    assert rc == 1 and line["gate"] == "ok" and line["value"] > 0
    assert list(line["modes"]) == ["bsgs_t16", "rmd160", "error"]
    assert line["modes"]["error"] == "GateError: xpoint gate FAILED: missing [7]"


@pytest.mark.parametrize("var", ["BENCH_SB", "BENCH_PROBE_MODE"])
def test_tpu_only_variables_are_refused(monkeypatch, table_dir, var):
    rc, lines, err = run_main(monkeypatch, table_dir, dict(ENV, **{var: "4"}))
    assert rc == 2 and lines == [] and f"{var} is TPU-only" in err


def test_no_card_is_an_error_not_a_cpu_run(monkeypatch, table_dir):
    """The default device is the card; without one the bench fails."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, _ = run_main(monkeypatch, table_dir, dict(ENV), argv=())
    line = json.loads(lines[-1])
    assert rc == 1 and line["value"] is None and "no CUDA device" in line["error"]
