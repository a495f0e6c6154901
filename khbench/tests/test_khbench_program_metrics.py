"""The readers of the program's own spans and counters
(khbench/metrics/host_busy_ms_per_chunk.py, wait_ms_per_chunk.py,
verify_ms_per_chunk.py, false_candidates_per_chunk.py): their arithmetic
on a record, their guard (None without a record, for a record of another
call, for a call that decoded no chunk, for a program that keeps no
records), and traced tiny runs of the cells on the CPU, whose lines carry
all four with host busy plus wait making up the window."""

import importlib

import pytest

from khbench import run
from khbench.tests.tiny import make_bench

READERS = ("host_busy_ms_per_chunk", "wait_ms_per_chunk", "verify_ms_per_chunk",
           "false_candidates_per_chunk")
RECORD = {"loop": "search", "start": 10.0, "end": 12.0, "chunks_decoded": 4, "keys": 4096,
          "spans": {"search": {"count": 1, "seconds": 2.0},
                    "wait": {"count": 4, "seconds": 0.4},
                    "verify": {"count": 2, "seconds": 0.02}},
          "counters": {"chunks_decoded": 4, "candidates_verified": 6, "false_candidates": 5}}


def _reader(name):
    return importlib.import_module(f"khbench.metrics.{name}").read


class _Registry:
    def __init__(self, rec):
        self.rec = rec

    def last_call(self):
        return self.rec


@pytest.fixture
def registry(monkeypatch):
    from keyhuntm1cpu_tpu_torch.core import metrics

    def set_record(rec, reg_cls=_Registry):
        monkeypatch.setattr(metrics, "get_metrics", lambda: reg_cls(rec))

    return set_record


def test_readers_arithmetic(registry):
    registry(RECORD)
    r = {"keys": 4096}
    assert _reader("host_busy_ms_per_chunk")(r) == pytest.approx(1e3 * 1.6 / 4)
    assert _reader("wait_ms_per_chunk")(r) == pytest.approx(1e3 * 0.4 / 4)
    assert _reader("verify_ms_per_chunk")(r) == pytest.approx(1e3 * 0.02 / 4)
    assert _reader("false_candidates_per_chunk")(r) == pytest.approx(5 / 4)
    # no verify span and no false candidate: a reading of 0, not None
    registry(dict(RECORD, spans={"search": {"count": 1, "seconds": 2.0}}, counters={}))
    assert _reader("verify_ms_per_chunk")(r) == 0.0
    assert _reader("wait_ms_per_chunk")(r) == 0.0
    assert _reader("false_candidates_per_chunk")(r) == 0.0


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no_record", "other_call", "no_chunk", "old_program"])
def test_readers_guard(registry, name, case):
    r = {"keys": 4096}
    if case == "no_record":
        registry(None)
    elif case == "other_call":  # the warm-up's call, not the window's
        registry(dict(RECORD, keys=512))
    elif case == "no_chunk":
        registry(dict(RECORD, chunks_decoded=0))
    else:  # a program whose registry keeps no call records
        registry(None, reg_cls=lambda rec: object())
    assert _reader(name)(r) is None


@pytest.mark.parametrize("cell", ["bsgs135_seq_t1", "rmd160_71_seq_t4"])
def test_traced_tiny_run_reads_all_four(tmp_path, cell):
    tiny = make_bench(str(tmp_path))
    res = run.run_cell(tiny, cell, 2222222229, 1.0, True, device="cpu")
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    from keyhuntm1cpu_tpu_torch.core import metrics

    rec = metrics.get_metrics().last_call()
    n = rec["chunks_decoded"]
    assert n == res["attempted"]
    wall = rec["end"] - rec["start"]
    assert (m["host_busy_ms_per_chunk"] + m["wait_ms_per_chunk"]) * n / 1e3 == pytest.approx(
        wall, rel=1e-9)
    assert m["verify_ms_per_chunk"] * n / 1e3 <= wall
