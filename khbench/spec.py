"""The benchmark's data, found by name.

``BENCHMARK.json`` lists the cells (``workloads``) with their configuration,
traffic mix and chips, and the metrics with their units and the cells they
are read in. Beside it, under ``khbench/``: ``configs/<name>.json`` (the file
a configuration entry names), ``traffic/<mix>.json``,
``workloads/<cell>.json`` (the limits of the cell's checks) and
``metrics/<name>.py`` (a reader a metric). Adding a cell, a mix or a
metric adds files and entries; nothing here needs an edit.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load(bench_path: str, workload: str) -> Cell:
    root = os.path.dirname(os.path.abspath(bench_path))
    bench = _read(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path} "
                       f"(have {', '.join(cells)})")
    w = cells[workload]
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    data = os.path.join(root, "khbench")
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_read(os.path.join(root, cfg_entry["file"])),
        mix=_read(os.path.join(data, "traffic", w["traffic"] + ".json")),
        limits=_read(os.path.join(data, "workloads", workload + ".json"))["limits"],
        end_to_end=_reported(bench["end_to_end"], workload),
        per_layer=_reported(bench["per_layer"], workload))
