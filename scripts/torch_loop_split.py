"""The search loop's host time a chunk, split by the always-on spans
(core/metrics.py), for BSGS's two entries on the card.

    python3 scripts/torch_loop_split.py --seed N [--seconds 10] [--trace 0|1]
    python3 scripts/torch_loop_split.py --seed N --scheduled [--seconds 10]

Run from the root of the checkout to measure (an A/B runs this file from
each tree's root, in turns). The first form is one run of the benchmark's cell bsgs135_seq_t1
(khbench.run.run_cell: ``BSGSEngine.search``) and reads the registry's
record of its window; the second builds the same configuration (table,
filters, engine; the seed's planted key and start, the range cut to 2^16
chunks so that chunk_order stays small) and times a window of
``search_scheduled("sequential")`` and then one of ``search`` on that
engine. Each prints one JSON line a window: ms a chunk in dispatch, copy,
decode, wait and the rest of the loop (the root span less those four),
the host's busy time (the root less wait), chunks, keys/s by the host's
clock, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.getcwd()  # the checkout measured: its package, benchmark and khbench
sys.path.insert(0, ROOT)
CELL = "bsgs135_seq_t1"
SPANS = ("dispatch", "copy", "decode", "wait")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def split(rec: dict) -> dict:
    """ms a chunk by span from a search call's record."""
    n = rec["chunks_decoded"]
    sec = {k: rec["spans"].get(k, {}).get("seconds", 0.0) for k in SPANS + ("search",)}
    out = {k: 1e3 * sec[k] / n for k in SPANS}
    out["rest"] = 1e3 * (sec["search"] - sum(sec[k] for k in SPANS)) / n
    out["host"] = 1e3 * (sec["search"] - sec["wait"]) / n
    out["chunks"] = n
    out["keys_per_s"] = rec["keys"] / (rec["end"] - rec["start"])
    return out


def benchmark_run(bench: str, seed: int, seconds: float, trace: bool, device="cuda") -> None:
    from khbench.run import run_cell
    from keyhuntm1cpu_tpu_torch.core.metrics import get_metrics

    res = run_cell(bench, CELL, seed, seconds, trace, device=device)
    line = {"entry": "search", "seed": seed, "trace": trace, "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            **split(get_metrics().last_call("search")), "card": card()}
    print(json.dumps(line), flush=True)


def scheduled_runs(bench: str, seed: int, seconds: float, device="cuda") -> None:
    import torch

    from khbench import generator, spec
    from khbench.runners import bsgs as runner
    from khbench.runners.common import sync
    from keyhuntm1cpu_tpu_torch.core.metrics import get_metrics
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine

    cell = spec.load(bench, CELL)
    cfg = cell.config
    inp = generator.generate(cell.mix, cfg, seed)
    dev = torch.device(device)
    table, bitmap, _ = runner.build_table(cfg, dev)
    p = runner.params(cfg)
    chunk_keys = p.steps_per_chunk * p.block_u * 2 * p.m
    eng = BSGSEngine(inp.pubkeys, inp.a, min(inp.b, inp.a + (1 << 16) * chunk_keys), p,
                     device=dev, table=table, bitmap=bitmap)
    eng.search_scheduled("sequential", max_chunks=2 * p.pipeline_depth, stop_on_first=False)
    sync([dev])
    for entry in ("search_scheduled", "search"):
        if entry == "search":
            found = eng.search(stop_on_first=False, max_seconds=seconds)
        else:
            found = eng.search_scheduled("sequential", stop_on_first=False,
                                         max_seconds=seconds)
        sync([dev])
        line = {"entry": entry, "seed": seed, "found": len(found),
                **split(get_metrics().last_call(entry)), "card": card()}
        print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--scheduled", action="store_true")
    args = ap.parse_args()
    bench = os.path.join(ROOT, "BENCHMARK.json")
    if args.scheduled:
        scheduled_runs(bench, args.seed, args.seconds)
    else:
        benchmark_run(bench, args.seed, args.seconds, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
