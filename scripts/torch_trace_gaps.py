"""Read a timeline the port wrote (``--trace-out FILE`` or
``KEYHUNT_TRACE_OUT=FILE``): for the last search call in it (the window
of a benchmark run), each card's busy and idle share between its first
chunk's start and its last chunk's end, and the first card's idle time
by the span the host was in (a span directly under the call's root:
dispatch, copy, wait, decode, rebase, rescan; "loop" inside the call but
in none of them; the time before the first chunk and after the last).

    python3 scripts/torch_trace_gaps.py TRACE.json [--json]

Host spans and card intervals are on one clock (time.perf_counter), so a
gap is put down to what the host was doing while the card sat idle.
"""

from __future__ import annotations

import argparse
import bisect
import json
from collections import defaultdict


def analyse(trace: dict) -> dict:
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    roots = [e for e in ev if e["cat"] == "span" and e["name"] == "search"]
    if not roots:
        raise ValueError("no search call in the trace")
    root = max(roots, key=lambda e: e["ts"])
    t0, t1 = root["ts"], root["ts"] + root["dur"]
    top = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e["cat"] == "span" and e["args"].get("parent") == root["args"]["id"])
    cards = defaultdict(list)
    for e in ev:
        if e["cat"] == "device" and t0 <= e["ts"] <= t1:
            cards[e["args"].get("card", 0)].append((e["ts"], e["ts"] + e["dur"]))
    out = {"window_s": (t1 - t0) / 1e6, "spans_s": defaultdict(float), "cards": {}}
    for a, b, name in top:
        out["spans_s"][name] += (b - a) / 1e6
    for card, iv in sorted(cards.items()):
        iv.sort()
        busy = sum(b - a for a, b in iv)
        span = iv[-1][1] - iv[0][0]
        out["cards"][card] = {"chunks": len(iv), "busy_s": busy / 1e6, "span_s": span / 1e6,
                              "idle_share": 1 - busy / span if span > 0 else 0.0}
    if cards:
        out["idle_gaps_s"] = _gaps(sorted(cards[min(cards)]), top, t0, t1)
    out["spans_s"] = dict(out["spans_s"])
    return out


def _gaps(iv, top, t0, t1) -> dict:
    """Seconds the card sat idle between its intervals, by the top-level
    span the host was in."""
    out = defaultdict(float)
    out["before the first chunk"] = max(0.0, iv[0][0] - t0) / 1e6
    out["after the last chunk"] = max(0.0, t1 - iv[-1][1]) / 1e6
    starts = [s[0] for s in top]
    for (_, g0), (g1, _) in zip(iv, iv[1:]):
        if g1 <= g0:
            continue
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(top) and top[i][0] < g1:
            a, b, name = top[i]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                out[name] += ov / 1e6
                covered += ov
            i += 1
        out["loop"] += ((g1 - g0) - covered) / 1e6
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--json", action="store_true", help="one JSON object, nothing else")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        res = analyse(json.load(f))
    if args.json:
        print(json.dumps(res))
        return 0
    print(f"window {res['window_s']:.6f} s")
    for name, s in sorted(res["spans_s"].items(), key=lambda kv: -kv[1]):
        print(f"  host in {name}: {s:.6f} s")
    for card, c in res["cards"].items():
        print(f"card {card}: {c['chunks']} chunks, busy {c['busy_s']:.6f} of {c['span_s']:.6f} s,"
              f" idle {100 * c['idle_share']:.3f} %")
    for name, s in sorted(res.get("idle_gaps_s", {}).items(), key=lambda kv: -kv[1]):
        print(f"  idle while {name}: {s:.6f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
