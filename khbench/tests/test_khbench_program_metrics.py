"""The readers of the program's own spans and counters
(khbench/metrics/host_busy_ms_per_chunk.py, wait_ms_per_chunk.py,
verify_ms_per_chunk.py, false_candidates_per_chunk.py, and the sharded
loop's mesh_dispatch_ms_per_chunk.py, mesh_copy_ms_per_chunk.py): their
arithmetic on a record, their guard (None without a record, for a record
of another call, for a call that decoded no chunk, for a program that
keeps no records; the mesh readers also on one card), and traced tiny
runs of the cells on the CPU, whose lines carry them: host busy plus wait
making up the window, and four dispatch spans a sharded chunk."""

import importlib

import pytest

from khbench import run
from khbench.tests.tiny import make_bench

READERS = ("host_busy_ms_per_chunk", "wait_ms_per_chunk", "verify_ms_per_chunk",
           "false_candidates_per_chunk")
MESH_READERS = ("mesh_dispatch_ms_per_chunk", "mesh_copy_ms_per_chunk")
RECORD = {"loop": "search", "start": 10.0, "end": 12.0, "chunks_decoded": 4, "keys": 4096,
          "spans": {"search": {"count": 1, "seconds": 2.0},
                    "wait": {"count": 4, "seconds": 0.4},
                    "verify": {"count": 2, "seconds": 0.02},
                    "dispatch": {"count": 16, "seconds": 0.8},
                    "copy": {"count": 4, "seconds": 0.2}},
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


def test_mesh_readers_arithmetic(registry):
    registry(RECORD)
    r = {"keys": 4096, "n_devices": 4}
    assert _reader("mesh_dispatch_ms_per_chunk")(r) == pytest.approx(1e3 * 0.8 / 4)
    assert _reader("mesh_copy_ms_per_chunk")(r) == pytest.approx(1e3 * 0.2 / 4)


@pytest.mark.parametrize("name", READERS + MESH_READERS)
@pytest.mark.parametrize("case", ["no_record", "other_call", "no_chunk", "old_program"])
def test_readers_guard(registry, name, case):
    r = {"keys": 4096, "n_devices": 4}
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
    # by reader: the BSGS cell reports them split by cells ("name.bsgs")
    m = {run.reader(k): v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    from keyhuntm1cpu_tpu_torch.core import metrics

    rec = metrics.get_metrics().last_call()
    n = rec["chunks_decoded"]
    assert n == res["attempted"]
    wall = rec["end"] - rec["start"]
    assert (m["host_busy_ms_per_chunk"] + m["wait_ms_per_chunk"]) * n / 1e3 == pytest.approx(
        wall, rel=1e-9)
    assert m["verify_ms_per_chunk"] * n / 1e3 <= wall


def test_traced_tiny_sharded_run_reads_the_mesh(tmp_path):
    """A tiny four-device CPU run of search_sharded: the mesh readers are
    the window's dispatch and copy seconds over its sharded chunks, with a
    dispatch span a card a chunk; the same record reads None as one card's."""
    tiny = make_bench(str(tmp_path))
    res = run.run_cell(tiny, "bsgs135_range_x4", 2222222231, 1.0, True, device="cpu")
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    from keyhuntm1cpu_tpu_torch.core import metrics

    rec = metrics.get_metrics().last_call()
    assert rec["loop"] == "search_sharded"
    n = rec["chunks_decoded"]
    assert n == res["attempted"] >= 1
    assert rec["spans"]["dispatch"]["count"] == 4 * n
    assert rec["spans"]["copy"]["count"] == n
    assert m["mesh_dispatch_ms_per_chunk"] == pytest.approx(
        1e3 * rec["spans"]["dispatch"]["seconds"] / n, rel=1e-12)
    assert m["mesh_copy_ms_per_chunk"] == pytest.approx(
        1e3 * rec["spans"]["copy"]["seconds"] / n, rel=1e-12)
    for name in MESH_READERS:
        assert _reader(name)({"keys": rec["keys"], "n_devices": 1}) is None
        assert _reader(name)({"keys": rec["keys"] + 1, "n_devices": 4}) is None
