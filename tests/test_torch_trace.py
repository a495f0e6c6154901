"""The port's spans and counters (keyhuntm1cpu_tpu_torch/core/metrics.py,
engine/pipeline.py run) on the CPU: the record each search loop's
call leaves (BSGS search and search_scheduled, the fused brute search,
the sharded search), its counts against the chunks decoded and its keys
against SearchStats; the counters of false candidates, cascade overflows,
host rescans and rebases on summaries made to show them, and of the
chunks whose K2 probed the level-1 bitmap; the timeline
(off: nothing kept; on: a Chrome-trace JSON whose chunk spans nest under
the call's root span and share the chunk's id), NVTX ranges around spans
and kernel launches; the registry's snapshot and Prometheus text with
spans. One test, marked cuda, holds each chunk's device interval between
its dispatch span's start and its wait span's end on the card."""

import contextlib
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu_torch import _build  # noqa: E402
from keyhuntm1cpu_tpu_torch.core import metrics  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.parallel.mesh import (ShardedBSGSEngine,  # noqa: E402
                                                  ShardedTableBSGSEngine)
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402

torch.set_num_threads(1)
A, B = 0xA00000, 0xA40000
KEY = A + 12345  # in the first chunk of K*U*2m = 2^16 keys
BSGS_P = bsgs.BSGSParams(m=512, block_u=16, steps_per_chunk=4, bits_log2=16, pipeline_depth=2)
BRUTE_P = BruteParams(block_u=128, steps_per_chunk=2, chunk_cand=64, pipeline_depth=2)
CHUNK_SPANS = {"dispatch", "copy", "wait", "decode"}
REG = metrics.get_metrics()


def _bsgs(key=KEY, params=BSGS_P, **kw):
    return bsgs.BSGSEngine([ecref.scalar_mult(key)], A, B, params, device="cpu", **kw)


def _brute(keys, params=BRUTE_P, a=2, b=1026):
    raw = [hashref.pubkey_to_hash160(ecref.scalar_mult(k), compressed=True) for k in keys]
    ts = TargetSet(kind="hash160", raw=raw, labels=[str(k) for k in keys])
    return BruteEngine(ts, a, b, mode="rmd160", params=params, device="cpu")


def _count(rec, name):
    return rec["spans"].get(name, {}).get("count", 0)


def _check_record(rec, eng, keys0):
    n = rec["chunks_decoded"]
    assert n > 0
    assert {name: _count(rec, name) for name in CHUNK_SPANS} == dict.fromkeys(CHUNK_SPANS, n)
    assert _count(rec, "search") == 1
    root = rec["spans"]["search"]["seconds"]
    assert rec["end"] - rec["start"] == pytest.approx(root)
    for name in CHUNK_SPANS:
        assert rec["spans"][name]["seconds"] <= root
    assert rec["keys"] == (eng.stats.keys_covered - keys0) * eng.stats.multiplier


@contextlib.contextmanager
def _timeline(tmp_path, monkeypatch, nvtx=None):
    tl = metrics.Timeline(str(tmp_path / "trace.json"))
    tl.nvtx = nvtx
    monkeypatch.setattr(REG, "timeline", tl)
    try:
        yield tl
    finally:
        monkeypatch.setattr(REG, "timeline", None)


class _FakeNvtx:
    def __init__(self):
        self.calls = []

    def range_push(self, name):
        self.calls.append(("push", name))

    def range_pop(self):
        self.calls.append(("pop", None))


# ---------------------------------------------------------------------------
# the record of each loop's call
# ---------------------------------------------------------------------------


def test_bsgs_search_leaves_one_record():
    eng = _bsgs()
    k0 = eng.stats.keys_covered
    found = eng.search(max_steps=12, stop_on_first=False)
    assert [f.private_key for f in found] == [KEY]
    rec = REG.last_call("search")
    assert rec is REG.last_call() and rec["loop"] == "search"
    _check_record(rec, eng, k0)
    assert rec["chunks_decoded"] == 3 and rec["keys"] == 3 * 4 * 16 * 2 * 512
    # the planted key's table match: one candidate, verified true
    assert rec["counters"]["candidates_verified"] >= 1
    assert _count(rec, "verify") == rec["counters"]["candidates_verified"]
    assert rec["counters"].get("false_candidates", 0) == rec["counters"][
        "candidates_verified"] - 1
    assert "rebases" not in rec["counters"] and "cascade_overflows" not in rec["counters"]


def test_probe_fused_chunks_counts_the_chunks_k2_probed():
    """probe_fused_chunks: one a chunk of BSGSEngine.search (K2 probed the
    level-1 bitmap, the chunk compacted its mask); none in the baby-table
    build (a device-resolve engine's set-up walks without a bitmap) nor in
    ShardedTableBSGSEngine's search, whose cards probe their own shards of
    the exchanged queries."""
    fused = lambda: REG.snapshot()["counters"].get("probe_fused_chunks", 0)
    before = fused()
    eng = _bsgs()  # device resolve: builds its baby table
    assert fused() == before
    found = eng.search(max_steps=12, stop_on_first=False)
    assert [f.private_key for f in found] == [KEY]
    rec = REG.last_call("search")
    assert rec["counters"]["probe_fused_chunks"] == rec["chunks_decoded"] == 3
    assert fused() == before + 3
    sharded = ShardedTableBSGSEngine([ecref.scalar_mult(KEY)], A, B, BSGS_P,
                                     devices=["cpu"] * 2)
    found = sharded.search_sharded(max_steps=8, stop_on_first=False)
    assert [f.private_key for f in found] == [KEY]
    rec = REG.last_call("search_sharded")
    assert rec["chunks_decoded"] == 2 and "probe_fused_chunks" not in rec["counters"]
    assert fused() == before + 3


def test_paired_walk_chunks_reads_nought_off_the_card():
    """paired_walk_chunks counts the chunks whose K2 walked pairs, which only
    the card does: a search on the CPU walks every point by the plain
    versions and leaves it out of its record, at a U that pairs (64) as at
    one that does not (16)."""
    paired = lambda: REG.snapshot()["counters"].get("paired_walk_chunks", 0)
    before = paired()
    for u in (16, 64):
        eng = bsgs.BSGSEngine([ecref.scalar_mult(KEY)], A, B,
                              dataclasses.replace(BSGS_P, block_u=u), device="cpu")
        assert eng.pair_tab is None
        eng.search(max_steps=4 * 16 // u, stop_on_first=False)
        rec = REG.last_call("search")
        assert rec["chunks_decoded"] >= 1 and "paired_walk_chunks" not in rec["counters"]
    assert paired() == before


def test_bsgs_search_scheduled_leaves_one_record():
    eng = _bsgs()
    found = eng.search_scheduled(policy="random", seed=5, max_chunks=2, stop_on_first=False)
    rec = REG.last_call("search_scheduled")
    _check_record(rec, eng, 0)
    assert rec["chunks_decoded"] == 2 and len(found) <= 1


def test_fused_brute_search_leaves_one_record():
    eng = _brute([5, 600])
    k0 = eng.stats.keys_covered
    assert sorted(f.private_key for f in eng.search()) == [5, 600]
    rec = REG.last_call("_search_fused")
    _check_record(rec, eng, k0)
    assert rec["chunks_decoded"] == 4 and rec["keys"] == 1024 * 2  # both parities
    c = rec["counters"]
    assert c["candidates_verified"] - c.get("false_candidates", 0) == 2


def test_sharded_search_spans_and_counters():
    """Two CPU shards: one engine_init for the engine, a dispatch span a
    card a chunk, one copy and one wait a chunk; the interest-free chunks
    are not decoded."""
    inits = REG.snapshot().get("spans", {}).get("engine_init", {}).get("count", 0)
    eng = ShardedBSGSEngine([ecref.scalar_mult(KEY)], A, B, BSGS_P, devices=["cpu"] * 2)
    assert REG.snapshot()["spans"]["engine_init"]["count"] == inits + 1
    k0 = eng.stats.keys_covered
    found = eng.search_sharded(max_steps=8, stop_on_first=False)
    assert [f.private_key for f in found] == [KEY]
    rec = REG.last_call("search_sharded")
    n = rec["chunks_decoded"]
    assert n == 2 and _count(rec, "dispatch") == 2 * n
    assert _count(rec, "copy") == _count(rec, "wait") == n
    assert 1 <= _count(rec, "decode") <= n
    assert rec["keys"] == eng.stats.keys_covered - k0 == 2 * 8 * 16 * 2 * 512
    for name, s in rec["spans"].items():
        assert s["seconds"] <= rec["spans"]["search"]["seconds"], name


def test_sharded_timeline_names_each_card(tmp_path, monkeypatch):
    eng = ShardedBSGSEngine([ecref.scalar_mult(KEY)], A, B, BSGS_P, devices=["cpu"] * 2)
    with _timeline(tmp_path, monkeypatch) as tl:
        eng.search_sharded(max_steps=4, stop_on_first=False)
    spans = [e for e in tl.entries() if e[0] == "span" and e[1] == "dispatch"]
    assert sorted((e[6], e[7]) for e in spans) == [(0, 0), (0, 1)]  # (chunk, card)


def test_registry_totals_snapshot_and_prometheus():
    before = REG.snapshot()
    eng = _brute([5])
    eng.search(max_steps=2)
    snap = REG.snapshot()
    rec = snap["calls"]["_search_fused"]
    for name, s in rec["spans"].items():
        assert snap["spans"][name]["count"] - before.get("spans", {}).get(name, {}).get(
            "count", 0) == s["count"]
    assert snap["counters"]["chunks_decoded"] - before["counters"].get(
        "chunks_decoded", 0) == rec["chunks_decoded"] == 1
    text = metrics.prometheus_text(snap)
    assert "# TYPE keyhunt_spans_total counter" in text
    assert f'keyhunt_spans_total{{span="dispatch"}} {snap["spans"]["dispatch"]["count"]}' in text
    assert 'keyhunt_span_seconds_total{span="search"} ' in text
    json.dumps(snap)  # /metrics.json


def test_registry_without_spans_prints_no_span_lines():
    m = metrics.Metrics()
    m.inc("keys_covered", 5)
    snap = m.snapshot()
    assert set(snap) == {"uptime_s", "keys_per_sec", "counters", "gauges", "info"}
    assert "span" not in metrics.prometheus_text(snap)


def test_live_call_shows_in_the_snapshot():
    """A search call's totals reach the snapshot before it returns."""
    eng = _brute([5])
    seen = []
    fn = eng._decode_fast

    def decode(step0, arr):
        snap = REG.snapshot()
        seen.append((snap["spans"]["dispatch"]["count"], snap["counters"].get(
            "chunks_decoded", 0)))
        return fn(step0, arr)

    eng._decode_fast = decode
    before = REG.snapshot()
    eng.search(max_steps=2)
    d0 = before.get("spans", {}).get("dispatch", {}).get("count", 0)
    assert seen == [(d0 + 1, before["counters"].get("chunks_decoded", 0))]


def test_span_opened_inside_itself_raises():
    """A call keeps one span a name: opening it again inside itself is a
    fault of the loop, not a second span."""
    eng = _brute([5])
    with metrics.SearchCall(REG, "nested", eng.stats, [eng.device]) as tr:
        with tr.span("decode"):
            with pytest.raises(RuntimeError, match="inside itself"):
                with tr.span("decode"):
                    pass


def test_search_stats_rate_starts_with_the_call():
    """Set-up (here a second's sleep after the engine's creation) is left
    out of SearchStats' rate and of the engine gauge."""
    eng = _brute([5])
    time.sleep(1.0)
    t0 = time.time()
    eng.search(max_steps=2)
    assert eng.stats.started_at >= t0
    assert eng.stats.keys_per_sec * (time.time() - t0) >= eng.stats.keys_covered * 2 * 0.99


# ---------------------------------------------------------------------------
# the counters, on summaries made to show them
# ---------------------------------------------------------------------------


def test_false_candidate_from_a_hand_made_brute_summary():
    """One hit bit at a key that is no target: one candidate verified,
    one false."""
    eng = _brute([600])
    C, K, U = BRUTE_P.chunk_cand, BRUTE_P.steps_per_chunk, BRUTE_P.block_u
    arr = np.zeros(2 * C + 3 * K + 1, np.int32)
    arr[:C] = K * U
    arr[0], arr[C] = 7, 1  # position 7, parity bit 0: key 9
    arr[-1] = 1
    with metrics.SearchCall(REG, "hand_made", eng.stats, [eng.device]):
        k_eff, found = eng._decode_fast(0, arr)
    assert (k_eff, found) == (K, [])
    rec = REG.last_call("hand_made")
    assert rec["counters"] == {"candidates_verified": 1, "false_candidates": 1}
    assert _count(rec, "verify") == 1


def test_tiny_brute_budget_counts_an_overflow_and_its_rescan():
    """chunk_cand = 1 and two hits in the first chunk: one overflow, the
    chunk's K steps rescanned on the host, both keys found."""
    p = BruteParams(block_u=128, steps_per_chunk=2, chunk_cand=1, pipeline_depth=2)
    eng = _brute([5, 100], params=p, a=2, b=258)
    assert sorted(f.private_key for f in eng.search()) == [5, 100]
    c = REG.last_call("_search_fused")["counters"]
    assert c["cascade_overflows"] == 1 and c["host_rescans"] == 2
    assert _count(REG.last_call(), "rescan") == 1


def test_tiny_bsgs_budget_counts_an_overflow_and_its_rescans():
    """chunk_cand_max = 1 (C2 = 1 at this size) and an all-ones bitmap:
    every query survives, the chunk overflows and its K steps are
    rescanned on the host, which finds the key."""
    eng = _bsgs(params=bsgs.BSGSParams(m=512, block_u=16, steps_per_chunk=4, bits_log2=16,
                                       chunk_cand_max=1, pipeline_depth=2))
    assert eng.C2 == 1
    eng.bitmap.words.fill_(-1)
    found = eng.search(max_steps=4, stop_on_first=False)
    assert [f.private_key for f in found] == [KEY]
    rec = REG.last_call("search")
    assert rec["counters"]["cascade_overflows"] == 1 and rec["counters"]["host_rescans"] == 4
    assert _count(rec, "rescan") == 4


@pytest.mark.parametrize("loop", ["search", "search_scheduled"])
def test_forced_bsgs_rebase_counts_one(loop):
    eng = _bsgs()
    fn = eng._consume_summary

    def consume(step0, k, arr):
        found, _, interesting = fn(step0, k, arr)
        return found, step0 == 0, interesting  # an advance degeneracy in chunk 0

    eng._consume_summary = consume
    if loop == "search":
        found = eng.search(max_steps=8, stop_on_first=False)
    else:
        found = eng.search_scheduled(max_chunks=2, stop_on_first=False)
    assert [f.private_key for f in found] == [KEY]
    rec = REG.last_call(loop)
    assert rec["counters"]["rebases"] == 1 and rec["chunks_decoded"] == 2
    assert _count(rec, "rebase") == 1  # both orders restart through one path


def test_forced_brute_rebase_counts_one():
    eng = _brute([600])
    fn = eng._decode_fast

    def decode(step0, arr):
        k_eff, found = fn(step0, arr)
        return (1 if step0 == 0 else k_eff), found  # chunk 0's advance chain broke at 1

    eng._decode_fast = decode
    assert [f.private_key for f in eng.search()] == [600]
    rec = REG.last_call("_search_fused")
    assert rec["counters"]["rebases"] == 1 and _count(rec, "rebase") == 1


# ---------------------------------------------------------------------------
# the timeline and NVTX
# ---------------------------------------------------------------------------


def test_timeline_off_keeps_nothing(tmp_path, monkeypatch):
    with _timeline(tmp_path, monkeypatch) as tl:
        pass
    assert REG.timeline is None
    _brute([5]).search(max_steps=2)
    assert len(tl.ring) == 0 and REG.write_trace() is None


def test_timeline_nests_chunk_spans_under_the_call(tmp_path, monkeypatch):
    eng = _brute([5, 600])
    with _timeline(tmp_path, monkeypatch) as tl:
        eng.search()
        path = REG.write_trace()
    assert path == tl.path
    with open(path) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X" and e["cat"] == "span"]
    (root,) = [e for e in spans if e["name"] == "search"]
    assert root["args"]["parent"] is None and root["args"]["chunk"] is None
    by_id = {e["args"]["id"]: e for e in spans}
    chunks = {}
    for e in spans:
        if e is root:
            continue
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e-3
        parent = by_id[e["args"]["parent"]]
        assert parent["ts"] <= e["ts"]
        chain = e
        while chain["args"]["parent"] is not None:
            chain = by_id[chain["args"]["parent"]]
        assert chain is root
        if e["name"] in CHUNK_SPANS:
            assert parent is root
            chunks.setdefault(e["args"]["chunk"], []).append(e["name"])
        if e["name"] == "verify":
            assert parent["name"] == "decode" and parent["args"]["chunk"] == e["args"]["chunk"]
    assert sorted(chunks) == [0, 2, 4, 6]  # each chunk's first step
    assert all(sorted(v) == sorted(CHUNK_SPANS) for v in chunks.values())
    names = {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    assert any(n.startswith("host thread") for n in names)


def test_nvtx_ranges_around_spans_and_launches(tmp_path, monkeypatch):
    """With the timeline on, a span and a kernel launch are NVTX ranges
    (named by span and kernel); off, neither calls NVTX. The launch counts
    are the wrappers' and do not move."""
    nvtx = _FakeNvtx()

    class Lib:
        @staticmethod
        def kh_probe(*args):
            return 0

    monkeypatch.setattr(_build, "kernels", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    s = _build.Stream(0)
    s.device = 0
    counts = _build.launch_counts()
    with _timeline(tmp_path, monkeypatch, nvtx):
        with metrics.span("table_build"):
            _build.launch("kh_probe", s)
    assert nvtx.calls == [("push", "table_build"), ("push", "kh_probe"), ("pop", None),
                          ("pop", None)]
    _build.launch("kh_probe", s)
    with metrics.span("table_build"):
        pass
    assert len(nvtx.calls) == 4
    assert _build.launch_counts() == counts


def test_trace_to_is_the_one_switch(tmp_path, monkeypatch):
    """The CLI's --trace-out and KEYHUNT_TRACE_OUT both call trace_to;
    None or "" leaves the timeline off."""
    monkeypatch.setattr(REG, "timeline", None)
    metrics.trace_to(None)
    metrics.trace_to("")
    assert REG.timeline is None
    from keyhuntm1cpu_tpu_torch import cli

    args = cli.build_parser().parse_args(["-m", "bsgs", "-f", "x", "--trace-out", "t.json"])
    assert args.trace_out == "t.json"
    monkeypatch.setattr(metrics.atexit, "register", lambda fn: None)
    try:
        metrics.trace_to(str(tmp_path / "t.json"))
        assert REG.timeline is not None and REG.timeline.path == str(tmp_path / "t.json")
    finally:
        REG.timeline = None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_device_intervals_lie_inside_their_host_spans(tmp_path, monkeypatch):
    """Each chunk's device interval, mapped to the host clock by the
    reference event, starts no earlier than its dispatch span and ends no
    later than its wait span, within the mapping's error; the launch
    counts of a search are the same with the timeline on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    p = bsgs.BSGSParams(m=1 << 16, block_u=1024, steps_per_chunk=16, pipeline_depth=4)
    eng = bsgs.BSGSEngine([ecref.scalar_mult(KEY)], A, A + (1 << 40), p, device=dev)
    eng.search(max_steps=2 * 16, stop_on_first=False)  # warm
    torch.cuda.synchronize()
    c0 = _build.launch_counts()
    eng.search(max_steps=8 * 16, stop_on_first=False)
    torch.cuda.synchronize()
    c1 = _build.launch_counts()
    with _timeline(tmp_path, monkeypatch) as tl:
        tl.nvtx = torch.cuda.nvtx
        eng.search(max_steps=8 * 16, stop_on_first=False)
        torch.cuda.synchronize()
    c2 = _build.launch_counts()
    assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k] for k in c0}
    err = tl.refs[dev][2] + 20e-6
    ring = tl.entries()
    spans = {(e[1], e[6]): e for e in ring if e[0] == "span"}
    ivs = [e for e in ring if e[0] == "device"]
    assert len(ivs) == 8
    for _, _, t0, t1, _, _, chunk, card, where in ivs:
        assert card == 0 and where == str(dev) and t0 < t1
        assert t0 >= spans[("dispatch", chunk)][2] - err
        assert t1 <= spans[("wait", chunk)][3] + err


def test_trace_gaps_script_splits_idle_by_span():
    """scripts/torch_trace_gaps.py on a made-up timeline: two chunks on a
    card, the gap between them half in a copy span, half in the loop."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_trace_gaps.py")
    spec = importlib.util.spec_from_file_location("torch_trace_gaps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def x(name, cat, ts, dur, **args):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "args": args}

    ev = [x("search", "span", 0, 100, id=1, parent=None, chunk=None),
          x("dispatch", "span", 1, 9, id=2, parent=1, chunk=0),
          x("copy", "span", 50, 5, id=3, parent=1, chunk=0),
          x("verify", "span", 51, 2, id=4, parent=3, chunk=0),
          x("chunk", "device", 10, 40, chunk=0, card=0),
          x("chunk", "device", 60, 30, chunk=4, card=0)]
    res = mod.analyse({"traceEvents": ev})
    assert res["window_s"] == pytest.approx(100e-6)
    card = res["cards"][0]
    assert card["chunks"] == 2 and card["busy_s"] == pytest.approx(70e-6)
    assert card["idle_share"] == pytest.approx(10 / 80)
    gaps = res["idle_gaps_s"]
    assert gaps["copy"] == pytest.approx(5e-6) and gaps["loop"] == pytest.approx(5e-6)
    assert gaps["before the first chunk"] == pytest.approx(10e-6)
    assert gaps["after the last chunk"] == pytest.approx(10e-6)
    assert "verify" not in gaps  # a child: its time is its parent's
