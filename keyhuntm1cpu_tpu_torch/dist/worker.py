"""Distributed worker: lease work units, search, report, heartbeat.

Port of keyhuntm1cpu_tpu/dist/worker.py. `DistributedWorker` is a copy
(the same wire protocol: it works against either package's coordinator);
the search is a callable `(start, end) -> list[hex keys]`, and the search
functions here run the port's engines on `device`:

- `bsgs_search_fn`: one resident set of BSGS structures, built with the
  first unit's engine and shared by every later one (the device table and
  its bitmap in device resolve, the bloom2 from the table's cache; the
  host table and both filters in host resolve), as server.py keeps them;
  a fresh engine a unit, `search(stop_on_first=True)`;
- `brute_search_fn`: a fresh `BruteEngine` a unit (the step tables and
  the target set's structures are cached), with vanity intervals;
- `minikeys_search_fn`: units are suffix-counter ranges, not key ranges.

Each function records a unit's engine construction, its `_initial_base`
(BSGS) and its search in `fn.timings`, and the worker its RPCs in
`units`, so the per-unit overhead can be read beside the chunks' time.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, List, Optional

from ..core.log import get_logger
from ..engine.common import stop_requested
from .coordinator import WorkUnit, rpc

SearchFn = Callable[[int, int], List[str]]


class DistributedWorker:
    def __init__(
        self,
        host: str,
        port: int,
        search_fn: SearchFn,
        worker_id: Optional[str] = None,
        heartbeat_s: float = 15.0,
        poll_s: float = 2.0,
    ):
        self.host = host
        self.port = port
        self.search_fn = search_fn
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self.heartbeat_s = heartbeat_s
        self.poll_s = poll_s
        self.units_done = 0
        self.found: List[str] = []
        # per leased unit: unit_id, start, end, status, rpc_s (its lease and
        # report round trips), search_s (the search function's wall time)
        self.units: List[dict] = []

    def _rpc(self, req: dict) -> dict:
        req["worker_id"] = self.worker_id
        return rpc(self.host, self.port, req)

    def _heartbeat_loop(self, unit_id: int, stop: threading.Event) -> None:
        while not stop.wait(self.heartbeat_s):
            try:
                r = self._rpc({"op": "heartbeat", "unit_id": unit_id})
                if r.get("stop"):
                    return
            except OSError:
                pass  # transient; the lease covers us for lease_s

    def run(self, max_units: Optional[int] = None) -> List[str]:
        """Process units until the coordinator reports done. Returns found
        keys (hex) from THIS worker."""
        self._rpc({"op": "register"})
        while max_units is None or self.units_done < max_units:
            t0 = time.perf_counter()
            r = self._rpc({"op": "request_work"})
            t_lease = time.perf_counter() - t0
            if r.get("unit") is None:
                if r.get("done"):
                    break
                time.sleep(self.poll_s)
                continue
            unit = WorkUnit.from_dict(r["unit"])
            rec = dict(unit_id=unit.unit_id, start=unit.start, end=unit.end)
            self.units.append(rec)
            stop = threading.Event()
            hb = threading.Thread(
                target=self._heartbeat_loop, args=(unit.unit_id, stop), daemon=True
            )
            hb.start()
            t0 = time.perf_counter()
            try:
                keys = self.search_fn(unit.start, unit.end)
                status = "found" if keys else "done"
            except Exception:
                stop.set()
                rec["status"] = "failed"
                self._rpc({"op": "report", "unit_id": unit.unit_id,
                           "status": "failed"})
                raise
            finally:
                stop.set()
            rec["search_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if stop_requested() and status != "found":
                # graceful preemption mid-unit: the engine stopped at a
                # chunk boundary, so this unit is only PARTIALLY covered
                # — report failed so the coordinator requeues it for
                # another worker (any keys found so far still propagate)
                self._rpc({"op": "report", "unit_id": unit.unit_id,
                           "status": "failed", "found": keys})
                rec.update(status="failed", rpc_s=t_lease + time.perf_counter() - t0)
                self.found.extend(keys)
                break
            self.found.extend(keys)
            self.units_done += 1
            resp = self._rpc({"op": "report", "unit_id": unit.unit_id,
                              "status": status, "found": keys})
            rec.update(status=status, rpc_s=t_lease + time.perf_counter() - t0)
            if resp.get("stop"):
                break
        return self.found


def _timed(fn, acc: list):
    """fn, with the seconds of each call appended to acc."""
    def wrapped(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc.append(time.perf_counter() - t)
    return wrapped


def bsgs_search_fn(pubkeys, params=None, table=None, device="cuda") -> SearchFn:
    """BSGS search function over resident structures: the first unit's
    engine builds them (or takes `table`), every later one shares them.
    Construction is serialised, so threads of one process build them once."""
    from ..engine.bsgs import BSGSEngine, BSGSParams

    params = params or BSGSParams()
    resident = dict(table=table, host_table=None, bitmap=None, bloom2=None)
    lock = threading.Lock()
    timings: List[dict] = []

    def search(a: int, b: int) -> List[str]:
        t0 = time.perf_counter()
        with lock:
            first = resident["bitmap"] is None
            eng = BSGSEngine(pubkeys, a, b, params, device=device, **resident)
            resident.update(table=eng.table, host_table=eng.host_table, bitmap=eng.bitmap,
                            bloom2=eng.bloom2 if eng.table is None else None)
        t1 = time.perf_counter()
        if first:
            get_logger().plus(f"worker: resident {params.resolve}-resolve structures "
                              f"(m={params.m}) built in {t1 - t0:.2f} s")
        base: list = []
        eng._initial_base = _timed(eng._initial_base, base)
        found = [f"{f.private_key:x}" for f in eng.search(stop_on_first=True)]
        timings.append(dict(engine_s=t1 - t0, base_s=sum(base),
                            search_s=time.perf_counter() - t1, first=first,
                            keys=eng.stats.keys_covered))
        return found

    search.timings = timings
    return search


def brute_search_fn(targets, mode: str = "rmd160", params=None,
                    stop_on_first: bool = False, intervals=None,
                    prefixes=None, device="cuda") -> SearchFn:
    """Brute-mode search function (rmd160/address/xpoint/eth/address_u):
    exhaustive units by default (a hunt over many targets wants every hit;
    the coordinator's stop_on_first still ends the run on a find). A fresh
    engine a unit: the step tables are lru-cached and the target set
    memoizes its table and bitmap, so only the range's state is rebuilt."""
    from ..engine.brute import BruteEngine, BruteParams

    params = params or BruteParams()
    timings: List[dict] = []

    def search(a: int, b: int) -> List[str]:
        t0 = time.perf_counter()
        eng = BruteEngine(targets, a, b, mode=mode, params=params, device=device,
                          intervals=intervals, prefixes=prefixes)
        t1 = time.perf_counter()
        found = eng.search(stop_on_first=stop_on_first)
        timings.append(dict(engine_s=t1 - t0, search_s=time.perf_counter() - t1,
                            keys=eng.stats.keys_covered))
        return [f"{f.private_key:x}" for f in found]

    search.timings = timings
    return search


def minikeys_search_fn(targets, prefix: str, params=None,
                       alphabet=None, device="cuda") -> SearchFn:
    """Minikeys over the fleet: coordinator units are COUNTER ranges
    (the suffix counter space [0, 58^10)), not key ranges — every worker
    must be launched with the same --minikey-prefix so the units mean
    the same scan space."""
    from ..engine.minikeys import MinikeyEngine, tuned_params

    params = params or tuned_params(device=device)
    timings: List[dict] = []

    def search(a: int, b: int) -> List[str]:
        t0 = time.perf_counter()
        eng = MinikeyEngine(targets, prefix=prefix, params=params,
                            alphabet=alphabet, device=device)
        eng.counter = a
        t1 = time.perf_counter()
        found = eng.search(counter_end=b, stop_on_first=False)
        timings.append(dict(engine_s=t1 - t0, search_s=time.perf_counter() - t1,
                            keys=eng.stats.keys_covered))
        return [f"{f.private_key:x}" for f in found]

    search.timings = timings
    return search


def main(argv=None):
    import argparse
    import json

    from ..utils.targets import parse_target_file
    from ..engine.bsgs import BSGSParams

    p = argparse.ArgumentParser(prog="keyhunt-torch-worker")
    p.add_argument("-c", "--coordinator", required=True, help="host:port")
    p.add_argument("-f", "--file", default=None,
                   help="target file (pubkeys for bsgs; addresses/"
                        "hash160s/xpoints/eth for brute modes; addresses "
                        "for minikeys; optional when -v prefixes are "
                        "given with a brute mode)")
    p.add_argument("-m", "--mode", default="bsgs",
                   choices=["bsgs", "address", "rmd160", "xpoint", "eth",
                            "minikeys"],
                   help="search mode this worker runs (default bsgs)")
    p.add_argument("-C", "--minikey-prefix", default=None,
                   help="minikeys: REQUIRED fixed 'S'+11-char prefix so "
                        "all workers share one counter space")
    p.add_argument("-8", "--alphabet", default=None,
                   help="minikeys: custom 58-char base58 alphabet")
    p.add_argument("-v", "--vanity", action="append", default=[],
                   help="vanity address prefix (repeatable) — composes "
                        "with rmd160/address targets in the same scan; "
                        "with no -f targets, scans prefixes alone")
    p.add_argument("--m-babies", type=int, default=None)
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="m = sqrt(N) * k (reference -k)")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None)
    p.add_argument("-u", "--block-u", type=int, default=4096)
    p.add_argument("--chunk-steps", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default cuda; no GPU is an error)")
    args = p.parse_args(argv)
    import torch

    from ..engine.common import install_stop_handlers

    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is available")
    install_stop_handlers()  # SIGTERM: finish chunk, requeue unit, exit
    host, port = args.coordinator.rsplit(":", 1)
    if args.mode in ("bsgs", "minikeys") and not args.file:
        p.error(f"-m {args.mode} needs -f")
    if args.mode == "bsgs":
        targets = parse_target_file(args.file, "pubkey")
        from ..engine.bsgs import resolve_m

        try:
            m = resolve_m(args.m_babies, args.n_value, args.k_factor)
        except ValueError as e:
            p.error(str(e))
        params = BSGSParams(m=m, block_u=args.block_u,
                            steps_per_chunk=args.chunk_steps)
        fn = bsgs_search_fn(targets.pubkeys, params, device=args.device)
    elif args.mode == "minikeys":
        if not args.minikey_prefix:
            p.error("-m minikeys needs --minikey-prefix (all workers "
                    "must share one counter space)")
        targets = parse_target_file(args.file, "address")
        fn = minikeys_search_fn(targets, args.minikey_prefix,
                                alphabet=args.alphabet, device=args.device)
    else:
        from ..engine.brute import BruteParams
        from ..utils.targets import TargetSet

        if not args.file and not args.vanity:
            p.error(f"-m {args.mode} needs -f targets and/or -v prefixes")
        targets = (
            parse_target_file(args.file, args.mode)
            if args.file
            else TargetSet(kind="hash160", raw=[], labels=[])
        )
        intervals, prefixes = [], []
        if args.vanity:
            if args.mode not in ("address", "rmd160"):
                p.error("-v composes with -m address/rmd160 only")
            from ..engine.vanity import vanity_intervals

            for pref in args.vanity:
                intervals += vanity_intervals(pref)
            prefixes = list(args.vanity)
        params = BruteParams(block_u=args.block_u,
                             steps_per_chunk=args.chunk_steps)
        fn = brute_search_fn(targets, mode=args.mode, params=params,
                             intervals=intervals, prefixes=prefixes,
                             device=args.device)
    w = DistributedWorker(host, int(port), fn)
    found = w.run()
    # one line a unit (its RPCs beside the search function's split), then the
    # kernels' launches in this process
    for rec, tm in zip(w.units, getattr(fn, "timings", [])):
        print("[unit] " + json.dumps({**rec, **tm, "start": f"{rec['start']:x}",
                                      "end": f"{rec['end']:x}"}), flush=True)
    from .. import _build

    print("[launches] " + json.dumps(_build.launch_counts()), flush=True)
    print(f"[+] worker {w.worker_id}: {w.units_done} units, found {found}", flush=True)


if __name__ == "__main__":
    main()
