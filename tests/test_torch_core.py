"""The port's config and metrics (keyhuntm1cpu_tpu_torch/core/{config,
metrics}.py) held to the JAX package's on the same inputs: the
tests/test_core.py config cases parametrised over both packages, config
files of either package loaded by the other, one metrics snapshot and its
Prometheus text equal after the same calls, the HTTP endpoints, and the
engines' feed of the registry (SearchStats.add). Exact checks."""

import json
import urllib.request

import pytest

pytest.importorskip("torch")

from keyhuntm1cpu_tpu.core import config as jconfig  # noqa: E402
from keyhuntm1cpu_tpu.core import metrics as jmetrics  # noqa: E402
from keyhuntm1cpu_tpu_torch.core import config as tconfig  # noqa: E402
from keyhuntm1cpu_tpu_torch.core import metrics as tmetrics  # noqa: E402
from keyhuntm1cpu_tpu_torch.core.errors import ConfigError as TConfigError  # noqa: E402
from keyhuntm1cpu_tpu.core.errors import ConfigError as JConfigError  # noqa: E402

PKGS = {"jax": (jconfig, JConfigError), "torch": (tconfig, TConfigError)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_config_defaults_validate(pkg):
    cfg, _ = pkg
    cfg.Config().validate()


def test_config_constraints_match_reference(pkg):
    cfg, err = pkg
    with pytest.raises(err):
        cfg.Config(mode="bsgs", endomorphism=True).validate()
    with pytest.raises(err):
        cfg.Config(mode="bsgs", stride=3).validate()
    cfg.Config(mode="address", endomorphism=True, stride=3).validate()


def test_config_bad_mode_and_range(pkg):
    cfg, err = pkg
    with pytest.raises(err):
        cfg.Config(mode="nope").validate()
    with pytest.raises(err):
        cfg.Config(range_start=10, range_end=5).validate()


def test_config_file_env_override_precedence(pkg, tmp_path, monkeypatch):
    cfg, _ = pkg
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps({"mode": "address", "walkers": 3}))
    monkeypatch.setenv("KEYHUNT_WALKERS", "7")
    monkeypatch.setenv("KEYHUNT_QUIET", "true")
    c = cfg.load_config(str(f), block_u=512)
    assert (c.mode, c.walkers, c.quiet, c.block_u) == ("address", 7, True, 512)


def test_config_hex_env(pkg, monkeypatch):
    cfg, _ = pkg
    monkeypatch.setenv("KEYHUNT_RANGE_END", "0x10000")
    assert cfg.load_config().range_end == 0x10000


def test_config_unknown_key_rejected(pkg):
    cfg, err = pkg
    with pytest.raises(err):
        cfg.Config.from_dict({"nonsense": 1})


def test_config_roundtrip(pkg, tmp_path):
    cfg, _ = pkg
    c = cfg.Config(mode="rmd160", m_babies=123)
    path = tmp_path / "c.json"
    c.save(str(path))
    assert cfg.load_config(str(path), env=False) == c.validate()


def test_config_same_fields_and_cross_load(tmp_path, monkeypatch):
    """Every field, default and type is the JAX Config's; a file saved by
    either package loads in the other to the same values, env overrides
    resolve the same, and both refuse the same bad file."""
    import dataclasses

    jf = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(jconfig.Config)]
    tf = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(tconfig.Config)]
    assert tf == jf
    c = dict(mode="address", range_start=5, range_end=1 << 40, m_babies=1 << 20,
             probe_mode="sorted", table_comm="ring", sharded=True, n_devices=4,
             minikey_alphabet="x" * 58, filter_mult=4, look="both", crypto="eth")
    jconfig.Config(**c).save(str(tmp_path / "j.json"))
    tconfig.Config(**c).save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    monkeypatch.setenv("KEYHUNT_BLOCK_U", "0x200")
    for name in ("j.json", "t.json"):
        a = jconfig.load_config(str(tmp_path / name)).to_dict()
        b = tconfig.load_config(str(tmp_path / name)).to_dict()
        assert a == b and a["block_u"] == 512 and a["sharded"] is True
    (tmp_path / "bad.json").write_text(json.dumps({"mode": "bsgs", "stride": 2}))
    for mod, err in PKGS.values():
        with pytest.raises(err):
            mod.load_config(str(tmp_path / "bad.json"))


def _fill(m):
    m.inc("keys_covered", 1e6)
    m.inc("keys_covered", 2.5e6)
    m.inc("found")
    m.set_gauge("keys_per_sec_engine", 1.25e9)
    m.set_gauge("2nd-stage", 3.0)
    m.set_info("mode", "bsgs")
    m.set_info("device", "cpu")


def test_metrics_snapshot_and_prometheus_text_match_jax():
    a, b = jmetrics.Metrics(), tmetrics.Metrics()
    for m in (a, b):
        _fill(m)
        m.started_at = 1000.0  # the same uptime base for both
    sa, sb = a.snapshot(), b.snapshot()
    up = sa["uptime_s"]
    sb["uptime_s"] = up  # taken a moment apart
    sb["keys_per_sec"] = sb["counters"]["keys_covered"] / up
    assert sa == sb
    assert tmetrics.prometheus_text(sb) == jmetrics.prometheus_text(sa)
    text = tmetrics.prometheus_text(sb)
    assert "# TYPE keyhunt_keys_covered counter\nkeyhunt_keys_covered 3500000.0" in text
    assert "keyhunt__2nd_stage 3.0" in text
    assert 'keyhunt_info{device="cpu",mode="bsgs"} 1' in text


def test_metrics_http_endpoints():
    m = tmetrics.Metrics()
    _fill(m)
    srv = tmetrics.MetricsServer(0, metrics=m).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read().decode()

        code, ctype, body = get("/metrics.json")
        assert code == 200 and ctype == "application/json"
        assert json.loads(body)["counters"] == {"keys_covered": 3.5e6, "found": 1.0}
        code, ctype, body = get("/metrics")
        assert ctype.startswith("text/plain") and "keyhunt_found 1.0" in body
        assert get("/healthz")[2] == "ok"
        assert "keys_covered" in get("/")[2]
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/nope")
        assert e.value.code == 404
    finally:
        srv.stop()


def test_search_stats_feed_the_registry():
    """SearchStats.add feeds keys * multiplier into keys_covered and sets
    the engine rate gauge, under the JAX package's names; the rate counts
    the keys since the search call began (begin())."""
    from keyhuntm1cpu_tpu_torch.engine.common import SearchStats

    reg = tmetrics.get_metrics()
    before = reg.snapshot()["counters"].get("keys_covered", 0.0)
    st = SearchStats(multiplier=3)
    st.add(5)  # before the call: counted, but not in the call's rate
    st.begin()
    st.add(1000)
    st.add(24)
    snap = reg.snapshot()
    assert snap["counters"]["keys_covered"] - before == 3 * 1029
    assert st.keys_covered - st.start_keys == 1024
    # the gauge is the rate at the last add; the rate read later is lower
    assert snap["gauges"]["keys_per_sec_engine"] >= st.keys_per_sec > 0


def test_search_stats_rate_leaves_out_set_up():
    """An engine made 100 s before its search: the rate counts from the
    search's start, and a checkpoint's restored keys stay out of it."""
    import time

    from keyhuntm1cpu_tpu_torch.engine.common import SearchStats

    st = SearchStats(multiplier=2, started_at=time.time() - 100.0)
    st.begin()
    st.resume(10**9)  # a saved run's keys
    st.add(10**6)
    time.sleep(0.05)
    rate = st.keys_per_sec
    elapsed = time.time() - st.started_at
    assert st.started_at > time.time() - 10.0 and st.keys_covered == 10**9 + 10**6
    # 2*10^6 keys over the call's fraction of a second, not 2*10^6 over 100 s
    assert 2 * 10**6 / elapsed <= rate < 2 * 10**7 / elapsed
    assert rate > 10 * (2 * 10**6 / 100.0)
    assert st.human().endswith("keys/s")
