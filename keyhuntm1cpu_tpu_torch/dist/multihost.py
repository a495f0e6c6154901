"""Multi-host runtime: one process a host, each on its own slice of the range.

Port of keyhuntm1cpu_tpu/dist/multihost.py. ``torch.distributed`` (gloo)
stands where ``jax.distributed`` stood and is used for the rendezvous
only: it gives each process its rank and the world size. Processes share
no device collectives and take no locks:

- ``initialize()`` joins the process group (a no-op without a coordinator);
- ``process_slice()`` is this process's window-aligned slice of the range
  (parallel/partition.RangePartitioner);
- ``search_bsgs_multihost()`` searches it with the local engine,
  ``BSGSEngine.search_scheduled``, or with ``sharded="table"`` the
  ShardedTableBSGSEngine over this process's devices (every visible card),
  and reports found keys to a dist/coordinator.py server under unit id
  -1 - rank, whose stop flag the other processes see on their next RPC.

Launch (one line a host):
  python -m keyhuntm1cpu_tpu_torch.dist.multihost \\
      --coordinator HOST0:9911 --num-processes 8 --process-id $I \\
      -f targets.pub -r 400000000000000:800000000000000 --m-babies 4194304 \\
      [--report HOST:PORT] [--sharded] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

from ..engine.bsgs import BSGSEngine, BSGSParams
from ..engine.common import FoundKey
from ..parallel.partition import RangePartitioner, RangeSlice
from .coordinator import rpc


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group at tcp://coordinator_address (the rank 0
    process serves its store there). No-op when already joined, or when
    neither a coordinator nor a process count is given (one process)."""
    import torch.distributed as dist

    if num_processes is None and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the number "
                         "of processes and this process's id")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_slice(range_start: int, range_end: int, window: int,
                  n: Optional[int] = None, i: Optional[int] = None) -> RangeSlice:
    """This process's window-aligned slice of [range_start, range_end)."""
    n = process_count() if n is None else n
    i = process_index() if i is None else i
    return RangePartitioner.split_equal(range_start, range_end, n, window)[i]


def search_bsgs_multihost(
        pubkeys: Sequence[Tuple[int, int]], range_start: int, range_end: int,
        params: BSGSParams = BSGSParams(), report_addr: Optional[Tuple[str, int]] = None,
        stop_on_first: bool = True, policy: str = "sequential", seed: int = 0,
        progress_every: int = 0, max_chunks: Optional[int] = None, table=None,
        sharded: Optional[str] = None, device="cuda", devices=None) -> List[FoundKey]:
    """Search this process's slice and report found keys to the coordinator
    (op=report, unit id -1 - rank), so that any process's find sets the
    fleet's stop flag. device: the single-device engine's; sharded="table"
    shards the baby table over `devices` (default: every visible card)."""
    window = params.block_u * 2 * params.m
    sl = process_slice(range_start, range_end, window)
    if sl.start >= sl.end:
        return []
    if sharded == "table":
        from ..parallel.mesh import ShardedTableBSGSEngine

        eng = ShardedTableBSGSEngine(list(pubkeys), sl.start, sl.end, params, table=table,
                                     devices=devices)
        found = eng.search_sharded(
            stop_on_first=stop_on_first, progress_every=progress_every,
            max_steps=max_chunks * params.steps_per_chunk if max_chunks is not None else None)
    elif sharded is not None:
        raise ValueError(f"sharded={sharded!r}: the multi-host runtime shards the table only")
    else:
        eng = BSGSEngine(list(pubkeys), sl.start, sl.end, params, device=device, table=table)
        found = eng.search_scheduled(policy=policy, seed=seed, stop_on_first=stop_on_first,
                                     progress_every=progress_every, max_chunks=max_chunks)
    if report_addr is not None:
        host, port = report_addr
        rank = process_index()
        try:
            rpc(host, port, {"op": "report", "worker_id": f"mh-{rank}", "unit_id": -1 - rank,
                             "status": "found" if found else "done",
                             "found": [f"{f.private_key:x}" for f in found]})
        except OSError:
            pass  # the keys are still returned (and written by main)
    return found


def main(argv=None) -> int:
    from ..engine.bsgs import resolve_m
    from ..engine.common import install_stop_handlers, write_found_key
    from ..utils.targets import parse_target_file

    p = argparse.ArgumentParser(prog="keyhunt-torch-multihost")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous host:port (the rank 0 process listens there)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--report", default=None,
                   help="WorkCoordinator host:port for found-key reports")
    p.add_argument("-f", "--file", required=True)
    p.add_argument("-r", "--range", required=True, help="start:end hex")
    p.add_argument("--m-babies", type=int, default=None)
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="m = sqrt(N) * k (reference -k)")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None)
    p.add_argument("-u", "--block-u", type=int, default=4096)
    p.add_argument("--chunk-steps", type=int, default=16)
    p.add_argument("-B", "--policy", default="sequential")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-chunks", type=int, default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--sharded", nargs="?", const="table", default=None, choices=["table"],
                   help="shard the baby table over this host's cards (m scales with "
                        "their count)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default cuda; no GPU is an error); --sharded "
                        "with cpu runs one CPU shard")
    args = p.parse_args(argv)
    try:
        args.m_babies = resolve_m(args.m_babies, args.n_value, args.k_factor)
    except ValueError as e:
        p.error(str(e))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available")
        return 2
    install_stop_handlers()  # SIGTERM: finish the chunk, report, exit
    initialize(args.coordinator, args.num_processes, args.process_id)
    try:
        a, b = (int(x, 16) for x in args.range.split(":", 1))
        targets = parse_target_file(args.file, "pubkey")
        report = None
        if args.report:
            host, port = args.report.rsplit(":", 1)
            report = (host, int(port))
        t0 = time.time()
        found = search_bsgs_multihost(
            targets.pubkeys, a, b,
            BSGSParams(m=args.m_babies, block_u=args.block_u, steps_per_chunk=args.chunk_steps),
            report_addr=report, stop_on_first=not args.all, policy=args.policy,
            seed=args.seed, max_chunks=args.max_chunks, sharded=args.sharded,
            device=args.device, devices=None if args.device == "cuda" else ["cpu"])
        rank, n = process_index(), process_count()
        for f in found:
            write_found_key(f)
            print(f"FOUND {f.private_key:064x} (process {rank})")
        print(f"process {rank}/{n} done in {time.time() - t0:.1f}s, {len(found)} keys")
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    return 0 if found else 1


if __name__ == "__main__":
    raise SystemExit(main())
