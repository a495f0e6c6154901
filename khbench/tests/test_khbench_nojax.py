"""What the benchmark loads: no jax, jaxlib, flax or JAX package (by whole
top-level module name: the port's name begins with the JAX package's),
and a reference that loads nothing of the program."""

import json
import os
import subprocess
import sys

from khbench.tests.tiny import REPO, make_bench

LIST = "import sys; print(sorted({m.split('.')[0] for m in sys.modules}))"


def loaded(code: str, cwd: str = REPO) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\n" + LIST], cwd=cwd, check=True,
                         capture_output=True, text=True, env={**os.environ, "PYTHONPATH": REPO})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import khbench.reference.bsgs, khbench.reference.brute, "
                  "khbench.reference.filters, khbench.roofline, khbench.generator")
    assert not mods & {"jax", "jaxlib", "flax", "keyhuntm1cpu_tpu", "keyhuntm1cpu_tpu_torch"}


def test_a_run_loads_the_port_alone(tmp_path):
    bench = make_bench(str(tmp_path))
    mods = loaded(f"from khbench import run\nrun.run_cell({bench!r}, 'rmd160_71_seq_t4', 7, "
                  "0.5, True, device='cpu')")
    assert "keyhuntm1cpu_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "keyhuntm1cpu_tpu"}


def test_no_card_no_result(tmp_path):
    """Without the cards a cell asks for: a non-zero exit and no result."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "khbench", "run.py"),
                          "--workload", "bsgs135_seq_t1", "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_data_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and khbench/ but not the program."""
    import shutil

    shutil.copytree(os.path.join(REPO, "khbench"), tmp_path / "khbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "khbench/run.py", "--workload", "bsgs135_seq_t1",
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    json.load(open(tmp_path / "BENCHMARK.json"))
