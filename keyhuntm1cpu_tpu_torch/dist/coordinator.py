"""Work coordinator: range units, leases, heartbeats, reassignment.

A copy of keyhuntm1cpu_tpu/dist/coordinator.py: the same units, leases,
state file and wire protocol, so a worker of either package talks to a
coordinator of either package.

Working equivalent of the reference's interface-only WorkCoordinator
(include/keyhunt/core/distributed.h:34-188: register_worker / heartbeat /
report_result / timeout-based reassignment) — the reference has no bodies
and no sockets; its only shipped distribution is the bsgsd daemon serving
one client at a time (bsgsd.cpp:1354-1378).

Semantics:
- The global scalar range is cut into `WorkUnit`s up front (deterministic,
  aligned to `align` keys, e.g. one engine chunk, so units never straddle
  a chunk).
- Workers lease units (`request_work`), renew via `heartbeat`, and
  `report` completion or found keys. A unit whose lease expires returns
  to the queue (at-least-once scheduling; search is idempotent).
- `stop_on_first` ends the run as soon as any worker reports a key:
  subsequent requests drain with unit=None, done=True.

Wire protocol: one JSON object per line over TCP, one request per
connection. No third-party deps.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple


@dataclass
class WorkUnit:
    unit_id: int
    start: int
    end: int

    def to_dict(self) -> dict:
        return {"unit_id": self.unit_id, "start": f"{self.start:x}", "end": f"{self.end:x}"}

    @classmethod
    def from_dict(cls, d: dict) -> "WorkUnit":
        return cls(int(d["unit_id"]), int(d["start"], 16), int(d["end"], 16))


@dataclass
class _Lease:
    worker_id: str
    deadline: float
    progress: float = 0.0


class WorkCoordinator:
    def __init__(
        self,
        range_start: int,
        range_end: int,
        n_units: int,
        align: int = 1,
        lease_s: float = 120.0,
        stop_on_first: bool = True,
        state_file: Optional[str] = None,
    ):
        if range_start >= range_end:
            raise ValueError("bad range")
        self.lease_s = lease_s
        self.stop_on_first = stop_on_first
        self.state_file = state_file
        self._lock = threading.Lock()
        self._pending: Deque[WorkUnit] = deque()
        self._assigned: Dict[int, Tuple[WorkUnit, _Lease]] = {}
        self._completed: Dict[int, str] = {}
        self._workers: Dict[str, float] = {}  # worker_id -> last_seen
        self._found: List[dict] = []
        self._stopped = False

        total = range_end - range_start
        step = max(align, -(-total // n_units))
        step = -(-step // align) * align  # round UP to alignment
        uid = 0
        a = range_start
        while a < range_end:
            b = min(a + step, range_end)
            self._pending.append(WorkUnit(uid, a, b))
            uid += 1
            a = b
        self.n_units = uid
        # elastic recovery (the reference's WorkCoordinator declares
        # timeout reassignment but persists nothing, distributed.h:167-169;
        # its ops script greps logs instead, vastai_deploy.sh:88-106):
        # completed units + found keys survive a coordinator restart.
        if state_file:
            self._restore_state()

    def _restore_state(self) -> None:
        import json as _json
        import os as _os

        if not self.state_file or not _os.path.exists(self.state_file):
            return
        try:
            with open(self.state_file) as f:
                st = _json.load(f)
        except (OSError, ValueError):
            return
        completed = {int(k): v for k, v in st.get("completed", {}).items()}
        with self._lock:
            self._completed = completed
            self._found = list(st.get("found", []))
            self._stopped = bool(st.get("stopped", False))
            self._pending = deque(
                u for u in self._pending if u.unit_id not in completed
            )

    def _persist_state_locked(self) -> None:
        if not self.state_file:
            return
        import json as _json
        import os as _os

        tmp = f"{self.state_file}.tmp.{_os.getpid()}"
        with open(tmp, "w") as f:
            _json.dump(
                {
                    "completed": {str(k): v for k, v in self._completed.items()},
                    "found": self._found,
                    "stopped": self._stopped,
                },
                f,
            )
        _os.replace(tmp, self.state_file)

    # -- worker API -------------------------------------------------------

    def register(self, worker_id: str, caps: Optional[dict] = None) -> dict:
        with self._lock:
            self._workers[worker_id] = time.time()
        return {"ok": True, "n_units": self.n_units, "lease_s": self.lease_s}

    def request_work(self, worker_id: str) -> dict:
        with self._lock:
            self._workers[worker_id] = time.time()
            self._reclaim_expired_locked()
            if self._stopped or not self._pending:
                done = self._stopped or (
                    not self._pending and not self._assigned
                )
                return {"ok": True, "unit": None, "done": done}
            unit = self._pending.popleft()
            self._assigned[unit.unit_id] = (
                unit,
                _Lease(worker_id, time.time() + self.lease_s),
            )
            return {"ok": True, "unit": unit.to_dict(), "done": False}

    def heartbeat(self, worker_id: str, unit_id: Optional[int] = None,
                  progress: float = 0.0) -> dict:
        with self._lock:
            self._workers[worker_id] = time.time()
            if unit_id is not None and unit_id in self._assigned:
                unit, lease = self._assigned[unit_id]
                if lease.worker_id == worker_id:
                    lease.deadline = time.time() + self.lease_s
                    lease.progress = progress
            return {"ok": True, "stop": self._stopped}

    def report(self, worker_id: str, unit_id: int, status: str,
               found: Optional[List[str]] = None) -> dict:
        with self._lock:
            self._workers[worker_id] = time.time()
            entry = self._assigned.get(unit_id)
            owns = entry is not None and entry[1].worker_id == worker_id
            if status == "done" or status == "found":
                # accept completion from any worker (idempotent search):
                # drop both the lease and any reclaimed duplicate so the
                # unit is not re-searched after a late report. A duplicate
                # can only sit in pending when the reporter's lease was
                # reclaimed, so skip the O(pending) filter otherwise.
                self._completed[unit_id] = status
                self._assigned.pop(unit_id, None)
                if not owns:
                    self._pending = deque(
                        u for u in self._pending if u.unit_id != unit_id
                    )
            elif owns:  # failed: requeue only if the reporter still owns it
                self._assigned.pop(unit_id, None)
                self._pending.appendleft(entry[0])
            for k in found or []:
                self._found.append({"private_key": k, "worker": worker_id,
                                    "unit_id": unit_id})
            if found and self.stop_on_first:
                self._stopped = True
            self._persist_state_locked()
            return {"ok": True, "stop": self._stopped}

    # -- introspection ------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            self._reclaim_expired_locked()
            return {
                "ok": True,
                "pending": len(self._pending),
                "assigned": len(self._assigned),
                "completed": len(self._completed),
                "n_units": self.n_units,
                "workers": len(self._workers),
                "found": list(self._found),
                "stopped": self._stopped,
                "done": self._stopped
                or (not self._pending and not self._assigned),
            }

    def found_keys(self) -> List[dict]:
        with self._lock:
            return list(self._found)

    def is_done(self) -> bool:
        return self.status()["done"]

    def _reclaim_expired_locked(self) -> None:
        now = time.time()
        expired = [uid for uid, (_, lease) in self._assigned.items()
                   if lease.deadline < now]
        for uid in expired:
            unit, _ = self._assigned.pop(uid)
            self._pending.appendleft(unit)

    # -- request dispatch ---------------------------------------------------

    def handle(self, req: dict) -> dict:
        op = req.get("op")
        wid = req.get("worker_id", "")
        if op == "register":
            return self.register(wid, req.get("caps"))
        if op == "request_work":
            return self.request_work(wid)
        if op == "heartbeat":
            return self.heartbeat(wid, req.get("unit_id"), req.get("progress", 0.0))
        if op == "report":
            return self.report(wid, int(req["unit_id"]), req.get("status", "done"),
                               req.get("found"))
        if op == "status":
            return self.status()
        return {"ok": False, "error": f"unknown op {op!r}"}


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            line = self.rfile.readline(1 << 16)
            if not line:
                return
            req = json.loads(line)
            resp = self.server.coordinator.handle(req)  # type: ignore[attr-defined]
        except (json.JSONDecodeError, KeyError, ValueError) as e:
            resp = {"ok": False, "error": str(e)}
        try:
            self.wfile.write((json.dumps(resp) + "\n").encode())
        except BrokenPipeError:
            pass


class CoordinatorServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, coordinator: WorkCoordinator):
        super().__init__(addr, _Handler)
        self.coordinator = coordinator

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def rpc(host: str, port: int, req: dict, timeout: float = 10.0) -> dict:
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="keyhunt-torch-coordinator")
    p.add_argument("-i", "--ip", default="0.0.0.0")
    p.add_argument("-p", "--port", type=int, default=17890)
    p.add_argument("-r", "--range", required=True, help="start:end hex")
    p.add_argument("-n", "--units", type=int, default=256)
    p.add_argument("--align", type=int, default=1)
    p.add_argument("--lease-s", type=float, default=120.0)
    p.add_argument("--keep-going", action="store_true",
                   help="do not stop on first found key")
    p.add_argument("--state-file", default=None,
                   help="persist completed units + found keys; restores "
                        "on restart (elastic recovery)")
    args = p.parse_args(argv)
    a, b = (int(x, 16) for x in args.range.split(":", 1))
    coord = WorkCoordinator(a, b, args.units, align=args.align,
                            lease_s=args.lease_s,
                            stop_on_first=not args.keep_going,
                            state_file=args.state_file)
    print(f"[+] coordinating {coord.n_units} units over "
          f"{args.range} on {args.ip}:{args.port}")
    with CoordinatorServer((args.ip, args.port), coord) as srv:
        srv.serve_forever()


if __name__ == "__main__":
    main()
