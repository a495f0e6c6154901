"""A tiny copy of the benchmark for the CPU tests: the repository's
BENCHMARK.json, mixes and limits, with configurations cut to a few CPU
chunks (the port runs its kernels' plain versions on the CPU)."""

from __future__ import annotations

import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "khbench")

TINY = {
    "bsgs_puzzle135": dict(m_babies=512, block_u=16, steps_per_chunk=4, bits_log2=16,
                           range_log2=[40, 41], pipeline_depth=2),
    "bsgs_puzzle135_x4": dict(m_babies=512, block_u=16, steps_per_chunk=4, bits_log2=16,
                              range_log2=[40, 41], pipeline_depth=2),
    "rmd160_puzzle71": dict(block_u=128, steps_per_chunk=2, range_log2=[40, 41],
                            pipeline_depth=2, compare_max=4),
}
SPANS = {"bsgs_seq_t1": 16, "rmd160_seq_t4": 8, "rmd160_seq_t65536": 8}
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
TARGETS = {"rmd160_seq_t65536": 64}
# a handful of chunks cannot resolve a rate: the tiny cells do not hold it
RATE_LIMIT = 1e300


def make_bench(root: str) -> str:
    """Write the tiny benchmark under `root`; returns its BENCHMARK.json."""
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for key, entries in WAITING.items():
        have = {e["name"] for e in bench[key]}
        bench[key] += [e for e in entries if e["name"] not in have]
    for sub in ("configs", "traffic", "workloads"):
        os.makedirs(os.path.join(root, "khbench", sub), exist_ok=True)
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        cfg.update(TINY[c["name"]])
        json.dump(cfg, open(os.path.join(root, c["file"]), "w"))
    for name, span in SPANS.items():
        mix = json.load(open(os.path.join(DATA, "traffic", name + ".json")))
        mix["plant_span_log2"] = span
        mix["targets"] = TARGETS.get(name, mix["targets"])
        json.dump(mix, open(os.path.join(root, "khbench", "traffic", name + ".json"), "w"))
    for w in bench["workloads"]:
        lim = json.load(open(os.path.join(DATA, "workloads", w["name"] + ".json")))
        if "survivor_rate_gap" in lim["limits"]:
            lim["limits"]["survivor_rate_gap"] = RATE_LIMIT
        json.dump(lim, open(os.path.join(root, "khbench", "workloads", w["name"] + ".json"), "w"))
    path = os.path.join(root, "BENCHMARK.json")
    json.dump(bench, open(path, "w"))
    return path
