"""Dry runs of the port, the counterparts of __graft_entry__.py's:

- ``entry()``: (fn, example_args), where fn(*example_args) is one BSGS
  chunk of a tiny engine (K1 advance chain, K2 walk, cascade, exact search,
  summary) on the card, or on the CPU with device="cpu";
- ``dryrun_multichip(n)``: one search of each multi-device engine over n
  devices (range-sharded and table-sharded BSGS, the table under both
  schedules, and range-sharded brute force in rmd160), each recovering a
  key planted in the last shard's slice. The devices are the visible cards,
  repeated round robin up to n, or n CPU shards with device="cpu".

    python -m keyhuntm1cpu_tpu_torch.dryrun [N] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses

from .engine.bsgs import BSGSEngine, BSGSParams
from .ref import ecref

TINY = BSGSParams(m=256, block_u=16, steps_per_chunk=2, build_block=64)


def entry(device="cuda"):
    """(fn, (px, py)): fn(px, py) is one full chunk -> (next_x, next_y,
    summary)."""
    eng = BSGSEngine([ecref.scalar_mult(0xABCDEF)], 0xA00000, 0xA00000 + 2**18, TINY,
                     device=device)
    return eng._chunk_fn, eng._initial_base(0)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run each sharded engine once over n devices; AssertionError if a
    planted key is not recovered."""
    from .engine.brute import BruteParams
    from .engine.bsgs import build_baby_table
    from .parallel import (ShardedBSGSEngine, ShardedBruteEngine, ShardedTableBSGSEngine,
                           default_devices)
    from .ref import hashref
    from .utils.targets import TargetSet

    devs = default_devices(device, n_devices)
    table = build_baby_table(TINY.m, TINY.build_block, devs[0])
    a = 0xB00000
    window = TINY.block_u * 2 * TINY.m
    b = a + window * n_devices * 2  # 2 local steps a shard
    key = a + window * (2 * n_devices - 2) + 12345  # in the last shard's slice
    pub = [ecref.scalar_mult(key)]
    runs = [("range-sharded", ShardedBSGSEngine(pub, a, b, TINY, table=table, devices=devs))]
    for comm in ("all_gather", "ring"):
        runs.append((f"table-sharded ({comm})", ShardedTableBSGSEngine(
            pub, a, b, dataclasses.replace(TINY, table_comm=comm), table=table,
            devices=devs)))
    for name, eng in runs:
        keys = [f.private_key for f in eng.search_sharded(stop_on_first=False)]
        assert key in keys, f"{name} dry run missed the planted key: {keys}"
        print(f"dryrun_multichip({n_devices}): {name} BSGS recovered the planted key")

    bp = BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64, pipeline_depth=2)
    a4 = 0x90000
    span = bp.block_u * n_devices * 8  # 8 steps, 2 chunks, a shard
    bkey = a4 + span - 7 * bp.block_u // 2  # in the last shard's slice
    ts = TargetSet(kind="hash160", raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(bkey))],
                   labels=[hex(bkey)])
    eng = ShardedBruteEngine(ts, a4, a4 + span, mode="rmd160", params=bp, devices=devs)
    keys = [f.private_key for f in eng.search_sharded(stop_on_first=False)]
    assert bkey in keys, f"brute dry run missed the planted key: {keys}"
    print(f"dryrun_multichip({n_devices}): range-sharded brute (rmd160) recovered the "
          "planted key")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="devices (default: every visible card, one on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    fn, base = entry(args.device)
    fn(*base)
    print("entry(): one chunk ran")
    import torch

    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 1)
    dryrun_multichip(n, args.device)
