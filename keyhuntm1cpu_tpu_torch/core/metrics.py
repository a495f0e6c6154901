"""Metrics registry + embedded HTTP dashboard: a copy of
keyhuntm1cpu_tpu/core/metrics.py (the same counter names, snapshot and
Prometheus text, so one scrape config serves either package).

The reference ships a `DashboardServer` HTTP dashboard on :8080 whose
methods are all bodiless except the HTML template
(include/keyhunt/core/dashboard.h:102-387) and a 1 Hz printf stats loop
(keyhunt.cpp:2154-2252). This module is the working equivalent:

- `Metrics`: a process-global, thread-safe registry of counters and
  gauges the engines update (keys covered, device steps, chunk latency,
  found keys), and the port's own additions: spans and a record of each
  search loop's last call (`SearchCall`).
- `MetricsServer`: stdlib http.server exposing
    GET /metrics.json  — full snapshot
    GET /metrics       — Prometheus text exposition (scrape target)
    GET /healthz       — liveness
    GET /              — minimal auto-refreshing HTML view
  Runs on a daemon thread; zero third-party deps.

Spans and counters (the port's; a registry with no span recorded prints
exactly the JAX package's snapshot and Prometheus text). Always on: a
span adds its count and seconds, on ``time.perf_counter``, to its name's
totals; a search loop's counters (chunks_decoded, candidates_verified,
false_candidates, cascade_overflows, host_rescans, rebases,
probe_fused_chunks: the BSGS chunks whose K2 probed the level-1 bitmap,
and paired_walk_chunks: the BSGS chunks whose K2 walked pairs) add to the
registry's counters. A search loop's call (engine/pipeline.py
``run``) keeps its own totals, without a lock, and hands them to
the registry when it returns, with a record: start, end, chunks decoded,
keys covered (times the multiplier), span totals and counter deltas
(``last_call``). The snapshot adds ``spans`` and ``calls``, the
Prometheus text ``keyhunt_spans_total`` and ``keyhunt_span_seconds_total``
by span.

The timeline, on only when asked for (``trace_to(path)``: the CLI's
``--trace-out FILE`` or the ``KEYHUNT_TRACE_OUT`` variable), keeps every
span in a ring of SPAN_RING entries (name, start, end, its id and its
parent's, the chunk's first step, the card), a device interval a chunk
and card (a timing event recorded before the dispatch, and the summary's
own event), tied to ``perf_counter`` by a reference event recorded on
the idle device at each call's start, and NVTX ranges around each span
and kernel launch. It writes a Chrome-trace JSON at exit (or on
``write_trace()``): the host's spans on one track a thread, each card's
intervals on one track a card.
"""

from __future__ import annotations

import atexit
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import perf_counter
from typing import Dict, List, Optional

SPAN_RING = 1 << 17  # timeline entries kept: ~18 s of one-card BSGS (5 a 0.72 ms chunk)
TRACE_ENV = "KEYHUNT_TRACE_OUT"


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._info: Dict[str, str] = {}
        self.started_at = time.time()
        self._spans: Dict[str, list] = {}  # name -> [count, seconds], calls ended and set-up
        self._live: set = set()  # SearchCalls in progress
        self._last: Dict[str, dict] = {}  # loop -> the record of its last call
        self._last_any: Optional[dict] = None
        self.timeline: Optional[Timeline] = None  # on only when asked for (trace_to)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def set_info(self, name: str, value: str) -> None:
        with self._lock:
            self._info[name] = value

    def inc_and_set_gauge(self, name: str, value: float, gauge: str, gvalue: float) -> None:
        """inc(name, value) and set_gauge(gauge, gvalue) under one lock
        take (SearchStats.add, once a chunk)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
            self._gauges[gauge] = gvalue

    def snapshot(self) -> dict:
        with self._lock:
            up = time.time() - self.started_at
            counters = dict(self._counters)
            spans = {k: list(v) for k, v in self._spans.items()}
            for call in self._live:  # a running call's totals so far
                for k, v in dict(call.counters).items():
                    counters[k] = counters.get(k, 0.0) + v
                for k, (n, sec) in call.totals().items():
                    e = spans.setdefault(k, [0, 0.0])
                    e[0] += n
                    e[1] += sec
            keys = counters.get("keys_covered", 0.0)
            snap = {
                "uptime_s": up,
                "keys_per_sec": keys / up if up > 0 else 0.0,
                "counters": counters,
                "gauges": dict(self._gauges),
                "info": dict(self._info),
            }
            if spans:
                snap["spans"] = {k: {"count": n, "seconds": sec} for k, (n, sec) in spans.items()}
            if self._last:
                snap["calls"] = dict(self._last)
            return snap

    # -- search calls and the timeline ------------------------------------

    def last_call(self, loop: Optional[str] = None) -> Optional[dict]:
        """The record of the last search call that ended (of `loop`, or of
        any loop)."""
        with self._lock:
            return self._last_any if loop is None else self._last.get(loop)

    def _end_call(self, call: "SearchCall", record: dict) -> None:
        with self._lock:
            self._live.discard(call)
            for k, v in call.counters.items():
                self._counters[k] = self._counters.get(k, 0.0) + v
            for k, (n, sec) in call.totals().items():
                e = self._spans.setdefault(k, [0, 0.0])
                e[0] += n
                e[1] += sec
            self._last[call.loop] = self._last_any = record

    def trace_to(self, path: Optional[str]) -> None:
        """Turn the timeline on, written to `path` at exit and by
        write_trace() (None or "": left as it is)."""
        if not path:
            return
        if self.timeline is None:
            self.timeline = Timeline(path)
            atexit.register(self.write_trace)
        self.timeline.path = path

    def write_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the timeline's Chrome-trace JSON (to `path`, or the path it
        was turned on with); returns the path, None when it is off."""
        if self.timeline is None:
            return None
        return self.timeline.write(path or self.timeline.path)


class _Span:
    """One timed region, a context manager: it counts its uses and their
    seconds; with the timeline on, each use also goes into the ring,
    inside an NVTX range. A SearchCall keeps one a name (and card) and
    reuses it, so that a span costs no allocation in the loop."""

    __slots__ = ("rec", "tl", "name", "card", "n", "sec", "t0", "sid", "parent", "chunk")

    def __init__(self, rec, name: str, card: Optional[int]):
        self.rec, self.tl, self.name, self.card = rec, rec.timeline, name, card
        self.n, self.sec, self.t0 = 0, 0.0, None

    def __enter__(self) -> "_Span":
        if self.t0 is not None:
            raise RuntimeError(f"span {self.name!r} opened inside itself")
        if self.tl is not None:
            self.tl.enter(self, self.rec.chunk)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = perf_counter()
        self.n += 1
        self.sec += t1 - self.t0
        if self.tl is not None:
            self.tl.leave(self, t1)
        self.t0 = None
        return False


class _SetupSpan(_Span):
    """A span outside any search call (set-up: kernel_build, table_build,
    engine_init): its one use goes to the registry's totals under the
    lock."""

    __slots__ = ()

    def __exit__(self, *exc) -> bool:
        super().__exit__()
        reg = _global
        with reg._lock:
            e = reg._spans.setdefault(self.name, [0, 0.0])
            e[0] += 1
            e[1] += self.sec
        return False


class SearchCall:
    """One call of a search loop (engine/pipeline.py run), a context
    manager: `stats` is the engine's SearchStats, `devices` its devices
    (the timeline's reference events). Its span totals and counters are
    kept without a lock by the loop's thread (the snapshot copies them)
    and handed to the registry `reg` when the call returns, with its
    record.

    The loop sets ``chunk`` (the chunk's first step) before the spans of a
    chunk; spans and device intervals take it as their chunk id. Device
    intervals (timeline on, CUDA): device_start() inside the dispatch span
    records a timing event on the device's current stream; device_end()
    one after a card's work (the sharded loop), or the summary's own event
    at device_done(), after the wait on it, ends the interval."""

    def __init__(self, reg: Metrics, loop: str, stats, devices):
        self.reg, self.loop, self.stats = reg, loop, stats
        self.devices = list(dict.fromkeys(devices))
        self._spans: Dict[object, _Span] = {}  # name, or (name, card) -> its span
        self.counters: Dict[str, int] = {}
        self.chunk: Optional[int] = None
        self.timeline = reg.timeline
        self._dev: Dict[tuple, list] = {}  # (chunk, card) -> [device, start event, end event]

    def span(self, name: str, card: Optional[int] = None) -> _Span:
        key = name if card is None else (name, card)
        sp = self._spans.get(key)
        if sp is None:
            sp = self._spans[key] = _Span(self, name, card)
        return sp

    def totals(self) -> Dict[str, list]:
        """name -> [count, seconds], over cards."""
        out: Dict[str, list] = {}
        for sp in list(self._spans.values()):
            if sp.n:
                e = out.setdefault(sp.name, [0, 0.0])
                e[0] += sp.n
                e[1] += sp.sec
        return out

    def count(self, name: str, value: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def device_start(self, device, card: int = 0) -> None:
        if self.timeline is not None and device.type == "cuda":
            self._dev[(self.chunk, card)] = [device, self.timeline.event(device), None]

    def device_end(self, device, card: int = 0) -> None:
        ent = self._dev.get((self.chunk, card))
        if ent is not None:
            ent[2] = self.timeline.event(device)

    def device_done(self, end=None) -> None:
        """The device intervals of chunk `chunk` into the ring (`end`: the
        summary's event, for the intervals without an end of their own)."""
        if not self._dev:
            return
        for key in [k for k in self._dev if k[0] == self.chunk]:
            device, e0, e1 = self._dev.pop(key)
            if e1 is None:
                e1 = end
            if e1 is not None:
                self.timeline.device_interval(device, e0, e1, *key)

    def __enter__(self) -> "SearchCall":
        self.stats.begin()
        if self.timeline is not None:
            self.timeline.reference(self.devices)
        with self.reg._lock:
            self.reg._live.add(self)
        self._prev = getattr(_tls, "call", None)
        _tls.call = self
        self._root = self.span("search").__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        root = self._root
        t0 = root.t0
        root.__exit__()
        _tls.call = self._prev
        self._dev.clear()
        st = self.stats
        record = {
            "loop": self.loop,
            "start": t0,
            "end": t0 + root.sec,
            "chunks_decoded": self.counters.get("chunks_decoded", 0),
            # a resumed run's saved keys move start_keys with them
            "keys": (st.keys_covered - st.start_keys) * st.multiplier,
            "spans": {k: {"count": n, "seconds": sec} for k, (n, sec) in self.totals().items()},
            "counters": dict(self.counters),
        }
        self.reg._end_call(self, record)
        return False


class _NoCall:
    """What current_call() gives outside a search loop: spans go to the
    registry (set-up), counters to its counters; no chunk, no interval."""

    chunk = None

    @property
    def timeline(self) -> "Optional[Timeline]":
        return _global.timeline

    def span(self, name: str, card: Optional[int] = None) -> _Span:
        return _SetupSpan(self, name, card)

    def count(self, name: str, value: int = 1) -> None:
        _global.inc(name, value)

    def device_start(self, device, card: int = 0) -> None:
        pass

    device_end = device_start

    def device_done(self, end=None) -> None:
        pass


class Timeline:
    """The timeline of spans and device intervals (Metrics.trace_to).
    Ring entries: ("span", name, start, end, id, parent id, chunk, card,
    thread), host seconds on perf_counter, and ("device", reference, start
    event, end event, None, None, chunk, card, device), read by entries()."""

    def __init__(self, path: str):
        self.path = path
        self.ring: deque = deque(maxlen=SPAN_RING)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.refs: Dict[object, tuple] = {}  # device -> (event, host seconds, error, stream)
        self.nvtx = None
        try:
            import torch

            if torch.cuda.is_available():
                self.nvtx = torch.cuda.nvtx
        except ImportError:
            pass

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def enter(self, span: _Span, chunk) -> None:
        st = self._stack()
        span.parent = st[-1] if st else None
        span.sid = next(self._ids)
        span.chunk = chunk
        st.append(span.sid)
        if self.nvtx is not None:
            self.nvtx.range_push(span.name)

    def leave(self, span: _Span, t1: float) -> None:
        if self.nvtx is not None:
            self.nvtx.range_pop()
        self._stack().pop()
        self.ring.append(("span", span.name, span.t0, t1, span.sid, span.parent, span.chunk,
                          span.card, threading.get_ident()))

    # -- the card ----------------------------------------------------------

    def event(self, device):
        """A timing event recorded on the device's stream (the current one
        when the call began: looking it up costs the host µs a chunk)."""
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record(self.refs[device][3])
        return e

    def reference(self, devices) -> None:
        """A reference event on each idle CUDA device and the host's clock
        when it completed: device times -> perf_counter."""
        import torch

        for d in devices:
            if d.type != "cuda":
                continue
            stream = torch.cuda.current_stream(d)
            torch.cuda.synchronize(d)
            t0 = perf_counter()
            e = torch.cuda.Event(enable_timing=True)
            e.record(stream)
            e.synchronize()
            t1 = perf_counter()
            self.refs[d] = (e, t1, t1 - t0, stream)

    def device_interval(self, device, e0, e1, chunk, card) -> None:
        """Keep the interval's events with their call's reference: entries()
        reads their times, off the loop."""
        self.ring.append(("device", self.refs[device], e0, e1, None, None, chunk, card,
                          str(device)))

    def entries(self) -> List[tuple]:
        """The ring as (kind, name, start, end, id, parent id, chunk, card,
        thread or device), host seconds on perf_counter (device intervals
        through their call's reference event)."""
        out = []
        for ent in list(self.ring):
            if ent[0] == "device":
                (ref, host, _, _), e0, e1 = ent[1:4]
                e1.synchronize()
                ent = ("device", "chunk", host + ref.elapsed_time(e0) / 1e3,
                       host + ref.elapsed_time(e1) / 1e3) + ent[4:]
            out.append(ent)
        return out

    # -- the file ----------------------------------------------------------

    def write(self, path: str) -> str:
        """The ring as Chrome-trace JSON (microseconds of perf_counter):
        host spans on a track a thread (args: id, parent, chunk, card), each
        card's chunk intervals on a track a card."""
        events, tids = [], {}
        for kind, name, t0, t1, sid, parent, chunk, card, where in self.entries():
            if kind == "span":
                tid = tids.setdefault(("host", where), len(tids))
                args = {"id": sid, "parent": parent, "chunk": chunk}
            else:
                tid = tids.setdefault(("card", card or 0, where), len(tids))
                args = {"chunk": chunk}
            if card is not None:
                args["card"] = card
            events.append({"name": name, "cat": kind, "ph": "X", "pid": 1, "tid": tid,
                           "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6, "args": args})
        for key, tid in tids.items():
            label = (f"host thread {key[1]}" if key[0] == "host"
                     else f"card {key[1]} ({key[2]})")
            events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                           "args": {"name": label}})
        meta = {"clock": "time.perf_counter", "ring": SPAN_RING,
                "reference_error_s": {str(d): r[2] for d, r in self.refs.items()}}
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms", "otherData": meta}, f)
        os.replace(tmp, path)
        return path


_global = Metrics()
_tls = threading.local()
_NO_CALL = _NoCall()


def get_metrics() -> Metrics:
    return _global


def current_call():
    """The search call running on this thread (a SearchCall), or one that
    sends spans and counters to the registry outside any call."""
    return getattr(_tls, "call", None) or _NO_CALL


def span(name: str, card: Optional[int] = None) -> _Span:
    """A span of the search call on this thread, or of set-up outside one."""
    return current_call().span(name, card)


def count(name: str, value: int = 1) -> None:
    """Add to a counter, through the search call on this thread if any."""
    current_call().count(name, value)


def spanned(name: str):
    """Decorate a function: each call is a span `name` (set-up: table_build,
    engine_init)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with current_call().span(name):
                return fn(*args, **kw)

        return inner

    return wrap


def trace_to(path: Optional[str]) -> None:
    """Turn the timeline on for the process, written to `path` at exit: the
    one switch behind the CLI's --trace-out and KEYHUNT_TRACE_OUT (None
    or "": off)."""
    _global.trace_to(path)


trace_to(os.environ.get(TRACE_ENV))


_HTML = """<!doctype html><meta charset=utf-8>
<title>keyhunt-tpu</title>
<meta http-equiv=refresh content=2>
<style>body{font:14px monospace;margin:2em}td{padding:.2em 1em}</style>
<h2>keyhunt-tpu</h2><table id=t>%ROWS%</table>
"""


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return "keyhunt_" + (out if not out[:1].isdigit() else "_" + out)


def prometheus_text(snap: dict) -> str:
    """Prometheus text exposition format of a Metrics snapshot: counters
    as counters, gauges + derived rates as gauges, info as a labeled
    keyhunt_info 1-gauge (the standard *_info convention)."""
    lines = []
    for k, v in sorted(snap["counters"].items()):
        n = _prom_name(k)
        lines += [f"# TYPE {n} counter", f"{n} {v!r}"]
    derived = {"uptime_seconds": snap["uptime_s"],
               "keys_per_sec": snap["keys_per_sec"]}
    for k, v in sorted({**snap["gauges"], **derived}.items()):
        n = _prom_name(k)
        lines += [f"# TYPE {n} gauge", f"{n} {v!r}"]
    if snap["info"]:
        labels = ",".join(
            f'{_prom_name(k)[8:]}="{str(v)[:120]}"'
            for k, v in sorted(snap["info"].items())
        )
        lines += ["# TYPE keyhunt_info gauge", "keyhunt_info{%s} 1" % labels]
    spans = sorted(snap.get("spans", {}).items())  # the port's: none, none printed
    for metric, field in (("keyhunt_spans_total", "count"),
                          ("keyhunt_span_seconds_total", "seconds")):
        if spans:
            lines.append(f"# TYPE {metric} counter")
        lines += [f'{metric}{{span="{k}"}} {v[field]!r}' for k, v in spans]
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        snap = self.server.metrics.snapshot()  # type: ignore[attr-defined]
        if self.path == "/metrics.json":
            self._send(200, json.dumps(snap, indent=1).encode(), "application/json")
        elif self.path == "/metrics":
            self._send(200, prometheus_text(snap).encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/healthz":
            self._send(200, b"ok", "text/plain")
        elif self.path == "/":
            rows = [f"<tr><td>uptime_s</td><td>{snap['uptime_s']:.1f}</td></tr>",
                    f"<tr><td>keys/s</td><td>{snap['keys_per_sec']:.3e}</td></tr>"]
            for src in ("counters", "gauges", "info"):
                for k, v in sorted(snap[src].items()):
                    rows.append(f"<tr><td>{k}</td><td>{v}</td></tr>")
            body = _HTML.replace("%ROWS%", "".join(rows)).encode()
            self._send(200, body, "text/html")
        else:
            self._send(404, b"not found", "text/plain")

    def log_message(self, *a):  # silence default request logging
        pass


class MetricsServer:
    def __init__(self, port: int, metrics: Optional[Metrics] = None,
                 host: str = "127.0.0.1"):
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.metrics = metrics or get_metrics()  # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
