"""The benchmark of keyhuntm1cpu_tpu_torch, the PyTorch and CUDA port.

``python3 khbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once (khbench/run.py). Configurations,
traffic mixes, cells and metric readers are files of their own, found by
name (khbench/spec.py). The reference (khbench/reference/) and the
least-work model (khbench/roofline.py) are the yardstick; they import
nothing of the program.
"""
