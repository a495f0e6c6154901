"""BENCHMARK.json against the benchmark's rules, and every piece of it
found by name: configurations, mixes, cells' limits and metric readers."""

import importlib
import json
import math
import os
import re
import shutil

import pytest

from khbench import run, spec
from khbench.tests.tiny import REPO, cells, make_bench, with_waiting

BENCH = os.path.join(REPO, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the accepted cells, in their order at the head of the workloads
ACCEPTED = ["bsgs135_seq_t1", "rmd160_71_seq_t4", "rmd160_71_seq_t65536"]


@pytest.fixture(scope="module")
def bench():
    with open(BENCH) as f:
        return json.load(f)


def test_waiting_entries_keep_to_the_rules(bench):
    """What a later change adds back for the four-card cell: the same rules."""
    full = with_waiting(bench)
    check_names_units_and_lines(full)
    check_configs(full)
    check_metrics(full)
    assert sum(w["chips"] == 4 for w in full["workloads"]) == 1


def check_top_level_keys(bench, root=REPO):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["khbench"]
    assert bench["command"] == ["python3", "khbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) <= 64 * 1024


def test_top_level_keys(bench):
    check_top_level_keys(bench)


def test_check_fits_the_day(bench):
    """A full check of 24 cells at run_seconds fits 43,200 s."""
    cells = 24
    need = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def check_names_units_and_lines(bench):
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


def test_names_units_and_lines(bench):
    check_names_units_and_lines(bench)


def check_configs(bench, root=REPO):
    assert 1 <= len(bench["configs"]) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("khbench/configs/") and c["source"].startswith("https://")
        cfg = json.load(open(os.path.join(root, c["file"])))
        assert cfg["name"] == c["name"] and len(cfg["source"]) <= 200
        assert "assumed" in cfg and "guarantees" in cfg
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_configs(bench):
    check_configs(bench)


def check_cells(bench, root=REPO):
    """The accepted cells stay at the head, in their order; a cell added
    after them brings its mix and its limits."""
    names = [w["name"] for w in bench["workloads"]]
    assert names[:len(ACCEPTED)] == ACCEPTED
    assert len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    data = os.path.join(root, "khbench")
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(data, "traffic", w["traffic"] + ".json")), w
        assert os.path.isfile(os.path.join(data, "workloads", w["name"] + ".json")), w


def test_cells(bench):
    check_cells(bench)


def check_metrics(bench):
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


def test_metrics(bench):
    check_metrics(bench)


def check_rules(bench, root=REPO):
    """Every rule above, on a BENCHMARK.json and the data beside it."""
    check_top_level_keys(bench, root)
    test_check_fits_the_day(bench)
    check_names_units_and_lines(bench)
    check_configs(bench, root)
    check_cells(bench, root)
    check_metrics(bench)


@pytest.mark.parametrize("cell", [w["name"] for w in cells()])
def test_every_cell_loads_by_name(cell, tmp_path):
    """The cells of BENCHMARK.json, and the four-card cell whose files wait
    for its chip runs."""
    c = spec.load(make_bench(str(tmp_path)), cell)
    assert c.config["devices"] == c.chips
    assert "setup_s" in [m["name"] for m in c.end_to_end] and len(c.end_to_end) >= 2
    assert c.per_layer
    importlib.import_module(f"khbench.runners.{c.config['engine']}")
    for m in c.end_to_end + c.per_layer:
        assert callable(importlib.import_module(f"khbench.metrics.{run.reader(m['name'])}").read)
    assert all(v >= 0 and math.isfinite(v) for v in c.limits.values())


NEW_CONFIG, NEW_MIX, NEW_CELL = "bsgs_puzzle135_copy", "bsgs_seq_t1_copy", "bsgs135_copy_seq_t1"


def test_a_configuration_and_cell_added_as_data_alone(tmp_path):
    """A copy of the benchmark's data with a fourth configuration, a mix and
    a one-card cell added as files and entries alone, no code: it keeps to
    the rules, loads by name, and a tiny CPU run of the new cell is correct."""
    src = tmp_path / "src"
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(os.path.join(REPO, "khbench", sub), src / "khbench" / sub)
    data = src / "khbench"
    with open(BENCH) as f:
        bench = json.load(f)
    cfg = json.loads((data / "configs" / "bsgs_puzzle135.json").read_text())
    cfg["name"] = NEW_CONFIG
    (data / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(cfg))
    shutil.copy(data / "traffic" / "bsgs_seq_t1.json", data / "traffic" / f"{NEW_MIX}.json")
    shutil.copy(data / "workloads" / "bsgs135_seq_t1.json",
                data / "workloads" / f"{NEW_CELL}.json")
    bench["configs"].append({"name": NEW_CONFIG, "source": "https://github.com/albertobsd/keyhunt",
                             "file": f"khbench/configs/{NEW_CONFIG}.json", "reduced": [],
                             "why": "bsgs_puzzle135 under another name"})
    bench["workloads"].append({"name": NEW_CELL, "config": NEW_CONFIG, "traffic": NEW_MIX,
                               "chips": 1, "why": "bsgs135_seq_t1 under other names"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "bsgs135_seq_t1" in m.get("workloads", []):
            m["workloads"].append(NEW_CELL)
    (src / "BENCHMARK.json").write_text(json.dumps(bench))

    check_rules(bench, str(src))
    tiny = make_bench(str(tmp_path / "tiny"), src=str(src))
    c = spec.load(tiny, NEW_CELL)
    assert c.config["name"] == NEW_CONFIG and c.config["m_babies"] == 512
    assert c.mix["plant_span_log2"] == 16
    assert [m["name"] for m in c.end_to_end] == ["card_keys_per_s", "setup_s"]
    r = run.run_cell(tiny, NEW_CELL, 3141592654, 1.0, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
