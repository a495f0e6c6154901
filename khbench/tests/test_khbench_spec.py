"""BENCHMARK.json against the benchmark's rules, and every piece of it
found by name: configurations, mixes, cells' limits and metric readers."""

import importlib
import json
import math
import os
import re

import pytest

from khbench import run, spec
from khbench.tests.tiny import REPO, WAITING, make_bench

BENCH = os.path.join(REPO, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(BENCH) as f:
        return json.load(f)


def test_waiting_entries_keep_to_the_rules(bench):
    """What a later change adds back for the four-card cell: the same rules."""
    full = dict(bench, **{k: bench[k] + v for k, v in WAITING.items()})
    test_names_units_and_lines(full)
    test_configs(full)
    test_metrics(full)
    assert sum(w["chips"] == 4 for w in full["workloads"]) == 1


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["khbench"]
    assert bench["command"] == ["python3", "khbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(BENCH) <= 64 * 1024


def test_check_fits_the_day(bench):
    """A full check of 24 cells at run_seconds fits 43,200 s."""
    cells = 24
    need = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_names_units_and_lines(bench):
    items = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[kind]]
        assert len(names) == len(set(names)), kind
    for x in items:
        assert NAME.match(x["name"]), x["name"]
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] and "\t" not in x[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("khbench/configs/") and c["source"].startswith("https://")
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["name"] == c["name"] and len(cfg["source"]) <= 200
        assert "assumed" in cfg and "guarantees" in cfg
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    assert [w["name"] for w in bench["workloads"]] == [
        "bsgs135_seq_t1", "rmd160_71_seq_t4", "rmd160_71_seq_t65536"]


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", ["bsgs135_seq_t1", "rmd160_71_seq_t4",
                                  "rmd160_71_seq_t65536", "bsgs135_range_x4"])
def test_every_cell_loads_by_name(cell, tmp_path):
    """The cells, and the four-card cell whose files wait for its chip runs."""
    c = spec.load(make_bench(str(tmp_path)), cell)
    assert c.config["devices"] == c.chips
    assert "setup_s" in [m["name"] for m in c.end_to_end] and len(c.end_to_end) >= 2
    assert c.per_layer
    importlib.import_module(f"khbench.runners.{c.config['engine']}")
    for m in c.end_to_end + c.per_layer:
        assert callable(importlib.import_module(f"khbench.metrics.{run.reader(m['name'])}").read)
    assert all(v >= 0 and math.isfinite(v) for v in c.limits.values())

