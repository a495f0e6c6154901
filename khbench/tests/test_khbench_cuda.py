"""A full run of a cell on the card (skipped without one)."""

import json
import os
import subprocess
import sys

import pytest

from khbench.tests.tiny import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bsgs135_seq_t1", "rmd160_71_seq_t4"])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, os.path.join(REPO, "khbench", "run.py"),
                          "--workload", cell, "--seed", "2222222222", "--seconds", "3",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.cuda
def test_card_clock_reads_the_window_on_the_card():
    """bsgs135_seq_t1 reports card_keys_per_s from the profiler's trace: the
    card's busy seconds lie inside the window and above nought."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, os.path.join(REPO, "khbench", "run.py"),
                          "--workload", "bsgs135_seq_t1", "--seed", "2222222223", "--seconds",
                          "3", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["metrics"]["card_keys_per_s"]["value"] > 0
    line = [ln for ln in out.stderr.splitlines() if ln.startswith("khbench: readings ")][-1]
    diag = json.loads(line[len("khbench: readings "):])
    assert 0 < diag["card_busy_s"] <= diag["wall_s"] and diag["card_ops"] >= res["attempted"]
