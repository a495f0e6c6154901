#!/usr/bin/env python3
"""The sharded engines on distinct cards: what one card cannot show.

    python3 scripts/torch_mesh_cards.py [--m 268435456] [--seconds 5]

Needs two or more NVIDIA GPUs (on one card it runs the same phases with
the card repeated, as chip_smoke.py does). Builds the kernels, then on
every visible card:

- the card-to-card copy rate (a 1 GiB tensor from cuda:0 to cuda:1 and
  back, by CUDA events), and the shard build's copies of the table;
- single-device references in this run: device-resolve BSGS at m = 2^28,
  U = 16384, K = 256 (chip_smoke.phase3d_device, its window `--seconds`)
  and fused rmd160 at T = 32 (`--seconds`);
- chip_smoke.py's phases 6a (range-sharded BSGS), 6b (table-sharded,
  all_gather and ring) and 6c (range-sharded rmd160) over the visible
  cards, each gate and exact launch count as in the smoke: keys/s beside
  the single-device rates, the host's enqueue a sharded chunk against the
  card's time (device_ms, on cuda:0's stream), the idle share.

Every line names the cards (nvidia-smi name and power limit). Exits
non-zero on any failed gate.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def copy_rate(src, dst, nbytes=1 << 30):
    """GB/s of one nbytes copy src -> dst, by CUDA events on both ends."""
    import torch

    x = torch.empty(nbytes, dtype=torch.uint8, device=src)
    x.to(dst)  # warm-up: peer access, allocator
    torch.cuda.synchronize(src)
    torch.cuda.synchronize(dst)
    t0 = time.perf_counter()
    for _ in range(5):
        y = x.to(dst)
    torch.cuda.synchronize(src)
    torch.cuda.synchronize(dst)
    del y
    return 5 * nbytes / (time.perf_counter() - t0) / 1e9


def rmd160_rate(dev, seconds):
    """Single-device fused rmd160 at phase 4's shape (T = 32): effective keys/s."""
    import torch

    from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    keys = list(range(1, 33))
    ts = TargetSet(kind="hash160", raw=[cs.brute_artifact("rmd160", ecref.scalar_mult(k))
                                        for k in keys], labels=[str(k) for k in keys])
    eng = BruteEngine(ts, *cs.BRUTE_RANGE, mode="rmd160",
                      params=BruteParams(block_u=cs.U, steps_per_chunk=cs.K), device=dev)
    eng.search(max_steps=cs.K)  # warm-up chunk
    k0 = eng.stats.keys_covered
    torch.cuda.synchronize()
    t0 = time.time()
    eng.search(max_seconds=seconds)
    torch.cuda.synchronize()
    return (eng.stats.keys_covered - k0) * eng.stats.multiplier / (time.time() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=1 << 28)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs NVIDIA GPUs")
    from keyhuntm1cpu_tpu_torch import _build

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    n = torch.cuda.device_count()
    cs.log(f"mesh: {n} cards: {cards}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.kernels()
    _build.host_lib()
    cs.log(f"mesh: built the kernels and the host library in {time.time() - t0:.1f} s")
    if n > 1:
        d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
        cs.log(f"mesh: 1 GiB copies cuda:0 -> cuda:1 {copy_rate(d0, d1):.1f} GB/s, "
               f"cuda:1 -> cuda:0 {copy_rate(d1, d0):.1f} GB/s")
    dev = torch.device("cuda", 0)
    clock = cs.sm_clock_mhz()
    _, table, bm, rate3d = cs.phase3d_device(dev, args.m, args.seconds, clock)
    devs = cs.shard_devices()
    cs.phase6a_range(args.m, table, bm, rate3d, args.seconds, devs)
    cs.phase6b_table(args.m, table, bm, args.seconds, devs)
    del table, bm
    torch.cuda.empty_cache()
    cs.phase6c_brute(args.seconds, devs, rmd160_rate(dev, args.seconds))
    cs.log(f"mesh: done; cards {cards}")


if __name__ == "__main__":
    main()
