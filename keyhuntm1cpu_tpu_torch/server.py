"""BSGS network service (bsgsd) on the port: port of keyhuntm1cpu_tpu/server.py.

Text line protocol over TCP, wire-compatible with the reference bsgsd:

    request:  "<pubkey_hex> <from_hex>:<to_hex>\\n"
    reply:    "<privkey_hex>" | "404 Not Found" | "400 Bad Request"
              | "408 Request Timeout" (the per-request --max-seconds cap cut
                the search before full coverage: not a clean miss, so a
                client that keeps books of cleared ranges must not mark it)
              | "429 Too Many Requests" (the per-client rate limit)

The baby table (device resolve), or the two filters and the host table
(--resolve host), are built once at start-up and stay resident; every
request's engine shares them read-only and chains its own walk state.
Concurrent requests interleave: each request's search runs as turns of
--slice-chunks chunks under a FIFO ticket lock, so a small request
finishes in a few turns instead of waiting out a large one. A request's
deadline is its own: it ends that request's turns and no other's, and
the server installs no signal handler (its handlers run off the main
thread).

Run: python -m keyhuntm1cpu_tpu_torch.server -p 8080 --m-babies 4194304
"""

from __future__ import annotations

import argparse
import socketserver
import threading
import time
from typing import Optional

from .core.security import RateLimiter
from .engine.bsgs import BSGSEngine, BSGSParams, resolve_m
from .ref import ecref


class _TicketLock:
    """FIFO mutex: turns are granted in request order, so interleaving is
    fair by construction (threading.Lock leaves the wake-up order to the
    OS, which can starve a waiter behind a tight re-acquire loop)."""

    def __init__(self):
        self._next = 0
        self._serving = 0
        self._cv = threading.Condition()

    def __enter__(self):
        with self._cv:
            me = self._next
            self._next += 1
            while self._serving != me:
                self._cv.wait()
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._serving += 1
            self._cv.notify_all()


class BSGSService:
    """Resident table and filters; sliced, interleaved request execution."""

    def __init__(self, params: BSGSParams, table=None, warm: bool = True,
                 max_seconds: Optional[float] = None, slice_chunks: int = 8,
                 device="cuda"):
        """table: a device table (device resolve; built when None); host
        resolve builds its filters and takes the host table from its cache.
        max_seconds caps each request's wall clock; slice_chunks is the
        chunks of one turn (the fairness grain)."""
        self.params = params
        self.device = device
        self.max_seconds = max_seconds
        self.slice_chunks = max(1, slice_chunks)
        self._lock = _TicketLock()
        boot = BSGSEngine([ecref.G], 1, 2, params, device=device, table=table)
        self.table, self.host_table = boot.table, boot.host_table
        self.bitmap, self.bloom2 = boot.bitmap, boot.bloom2
        if warm:
            # one chunk at start-up: builds the kernels and the device
            # constants' caches before the first request
            a = 1 << 40
            self._engine([ecref.scalar_mult(3)], a,
                         a + 2 * params.block_u * 2 * params.m).search(max_steps=1)

    def _engine(self, pubkeys, a: int, b: int) -> BSGSEngine:
        return BSGSEngine(pubkeys, a, b, self.params, device=self.device, table=self.table,
                          host_table=self.host_table, bitmap=self.bitmap, bloom2=self.bloom2)

    def solve(self, pubkey_hex: str, a: int, b: int):
        """(key or None, complete). complete is False when this request's
        deadline cut the search before the range was covered: the caller
        must not take it for an exhaustive miss. The search runs in turns
        of slice_chunks chunks under the FIFO lock."""
        eng = self._engine([ecref.parse_pubkey(pubkey_hex)], a, b)
        deadline = None if self.max_seconds is None else time.monotonic() + self.max_seconds
        slice_steps = self.slice_chunks * self.params.steps_per_chunk
        found = []
        cur = 0
        while cur < eng.n_steps:
            if deadline is not None and time.monotonic() >= deadline:
                break  # 408: the range is not covered
            budget = min(slice_steps, eng.n_steps - cur)
            with self._lock:  # one turn; the next waiter goes next
                found = eng.search(max_steps=budget, start_step=cur, stop_on_first=True)
            cur += budget
            if found:
                break
        # coverage is counted exactly (per decoded chunk), so "searched the
        # whole range" is a data check, not a timing guess
        complete = bool(found) or eng.stats.keys_covered >= (b - a)
        for f in found:
            if a <= f.private_key < b:
                return f.private_key, complete
        return (found[0].private_key if found else None), complete


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            # per-IP token bucket: a scanner cannot queue unbounded device
            # work behind the turn lock
            if not self.server.limiter.allow(self.client_address[0]):
                self.wfile.write(b"429 Too Many Requests")
                return
            parts = self.rfile.readline(4096).decode().strip().split()
            if len(parts) != 2 or ":" not in parts[1]:
                self.wfile.write(b"400 Bad Request")
                return
            lo, hi = parts[1].split(":", 1)
            a, b = int(lo, 16), int(hi, 16)
            if not (1 <= a < b <= ecref.N):
                self.wfile.write(b"400 Bad Request")
                return
            key, complete = self.server.service.solve(parts[0], a, b)
            if key is not None:
                self.wfile.write(f"{key:064x}".encode())
            elif not complete:
                self.wfile.write(b"408 Request Timeout")
            else:
                self.wfile.write(b"404 Not Found")
        except (ValueError, IndexError):
            self.wfile.write(b"400 Bad Request")
        except BrokenPipeError:
            pass


class BSGSDServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service: BSGSService, rate: float = 5.0, burst: int = 10):
        super().__init__(addr, _Handler)
        self.service = service
        self.limiter = RateLimiter(rate=rate, burst=burst)


def main(argv=None):
    p = argparse.ArgumentParser(prog="keyhunt-torch-bsgsd")
    p.add_argument("-i", "--ip", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=8080)
    p.add_argument("--m-babies", type=int, default=None,
                   help="baby-table size m directly (overrides -n/-k)")
    p.add_argument("-k", "--k-factor", type=int, default=1, help="m = sqrt(N) * k")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None,
                   help="BSGS N, a perfect square (default 0x100000000000)")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for reference-client compatibility; ignored")
    p.add_argument("-6", "--skip-checksum", action="store_true", dest="skip_checksum",
                   help="skip the table file's checksum")
    p.add_argument("-u", "--block-u", type=int, default=4096)
    p.add_argument("--chunk-steps", type=int, default=8)
    p.add_argument("--table-file", default=None,
                   help="device resolve: load the baby table from this file "
                        "(either package's -S file)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="per-request wall-clock cap: a range too large replies 408 "
                        "at the deadline")
    p.add_argument("--slice-chunks", type=int, default=8,
                   help="chunks per turn: concurrent requests interleave at this grain")
    p.add_argument("--resolve", default="device", choices=["device", "host"],
                   help="'host' keeps only the two filters on the card and the exact "
                        "table on the host")
    p.add_argument("--host-table-cache", default=None,
                   help="host-table cache dir (--resolve host)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default cuda; no GPU is an error)")
    args = p.parse_args(argv)
    try:
        m = resolve_m(args.m_babies, args.n_value, args.k_factor)
    except ValueError as e:
        p.error(str(e))
    params = BSGSParams(m=m, block_u=args.block_u, steps_per_chunk=args.chunk_steps,
                        resolve=args.resolve, table_cache=args.host_table_cache)
    table = (BSGSEngine.load_table(args.table_file, verify_checksum=not args.skip_checksum,
                                   device=args.device)
             if args.table_file and args.resolve == "device" else None)
    print(f"[+] building/loading baby table m={m} ({args.resolve} resolve) ...", flush=True)
    service = BSGSService(params, table, max_seconds=args.max_seconds,
                          slice_chunks=args.slice_chunks, device=args.device)
    print(f"[+] serving on {args.ip}:{args.port}", flush=True)
    with BSGSDServer((args.ip, args.port), service) as srv:
        srv.serve_forever()


if __name__ == "__main__":
    main()
