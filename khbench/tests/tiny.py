"""A tiny copy of the benchmark for the CPU tests: a BENCHMARK.json, its
mixes and limits, with configurations cut to a few CPU chunks (the port
runs its kernels' plain versions on the CPU).

The cut goes by a configuration's engine and a mix by the engines of the
cells that use it, never by name, so a configuration, a mix or a cell
added as data alone comes with its tiny copy."""

from __future__ import annotations

import json
import os
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "khbench")

# the scale keys of a configuration on the CPU, by its engine; every other
# key of its file passes through
_BSGS = dict(m_babies=512, block_u=16, steps_per_chunk=4, bits_log2=16, range_log2=[40, 41],
             pipeline_depth=2)
CUT = {
    "bsgs": _BSGS,
    "bsgs_sharded": _BSGS,
    "brute": dict(block_u=128, steps_per_chunk=2, range_log2=[40, 41], pipeline_depth=2,
                  compare_max=4),
}
# a mix's planted keys lie in the first chunk of a tiny cell, by engine:
# 2^16 keys is a BSGS chunk under the cut above (K*U*2m), 2^8 a brute one
# (K*U); a mix shared by engines takes the smallest
SPAN = {"bsgs": 16, "bsgs_sharded": 16, "brute": 8}
MAX_TARGETS = 64
# The four-card cell's files wait in khbench/ until its runs on four cards
# spread narrowly enough for a bound (PERF.md, Open questions); the tiny copy
# lists it, so that its runner and readers stay tested. Its bound here only
# keeps to the rules.
WAITING = {
    "configs": [{"name": "bsgs_puzzle135_x4", "source": "https://github.com/albertobsd/keyhunt",
                 "file": "khbench/configs/bsgs_puzzle135_x4.json", "reduced": [],
                 "why": "range-sharded BSGS on four cards"}],
    "workloads": [{"name": "bsgs135_range_x4", "config": "bsgs_puzzle135_x4",
                   "traffic": "bsgs_seq_t1", "chips": 4, "why": "the range in four slices"}],
    "end_to_end": [{"name": "mesh_keys_per_s", "unit": "keys/s", "better": "higher",
                    "bound": 0.2, "source": "host_clock", "workloads": ["bsgs135_range_x4"]}],
    "per_layer": [
        {"name": "mesh_dispatch_ms_per_chunk", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "mesh", "moves": "mesh_keys_per_s",
         "workloads": ["bsgs135_range_x4"]},
        {"name": "mesh_copy_ms_per_chunk", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "mesh", "moves": "mesh_keys_per_s",
         "workloads": ["bsgs135_range_x4"]},
        {"name": "mesh_idle_share", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "mesh_keys_per_s", "workloads": ["bsgs135_range_x4"]}],
}
# a handful of chunks cannot resolve a rate: the tiny cells do not hold it
RATE_LIMIT = 1e300


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def with_waiting(bench: dict) -> dict:
    """A BENCHMARK.json's entries with WAITING's that it does not hold."""
    bench = dict(bench)
    for key, entries in WAITING.items():
        have = {e["name"] for e in bench[key]}
        bench[key] = bench[key] + [e for e in entries if e["name"] not in have]
    return bench


def cells(src: str = REPO) -> List[dict]:
    """Every cell the CPU tests run: src's BENCHMARK.json's, then WAITING's."""
    return with_waiting(_read(os.path.join(src, "BENCHMARK.json")))["workloads"]


def cell_engines(src: str = REPO) -> Dict[str, str]:
    """cell -> the engine of its configuration, for every cell of cells()."""
    bench = with_waiting(_read(os.path.join(src, "BENCHMARK.json")))
    engine = {c["name"]: _read(os.path.join(src, c["file"]))["engine"] for c in bench["configs"]}
    return {w["name"]: engine[w["config"]] for w in bench["workloads"]}


def make_bench(root: str, src: str = REPO) -> str:
    """Write the tiny copy of src's benchmark (its BENCHMARK.json and the
    data under its khbench/) under `root`; returns its BENCHMARK.json."""
    bench = with_waiting(_read(os.path.join(src, "BENCHMARK.json")))
    data = os.path.join(src, "khbench")
    for sub in ("configs", "traffic", "workloads"):
        os.makedirs(os.path.join(root, "khbench", sub), exist_ok=True)
    engine = {}
    for c in bench["configs"]:
        cfg = _read(os.path.join(src, c["file"]))
        engine[c["name"]] = cfg["engine"]
        cfg.update(CUT[cfg["engine"]])
        _write(os.path.join(root, c["file"]), cfg)
    spans = {}
    for w in bench["workloads"]:
        span = SPAN[engine[w["config"]]]
        spans[w["traffic"]] = min(span, spans.get(w["traffic"], span))
    for name, span in spans.items():
        mix = _read(os.path.join(data, "traffic", name + ".json"))
        mix["plant_span_log2"] = span
        mix["targets"] = min(mix["targets"], MAX_TARGETS)
        _write(os.path.join(root, "khbench", "traffic", name + ".json"), mix)
    for w in bench["workloads"]:
        lim = _read(os.path.join(data, "workloads", w["name"] + ".json"))
        if "survivor_rate_gap" in lim["limits"]:
            lim["limits"]["survivor_rate_gap"] = RATE_LIMIT
        _write(os.path.join(root, "khbench", "workloads", w["name"] + ".json"), lim)
    path = os.path.join(root, "BENCHMARK.json")
    _write(path, bench)
    return path
