"""Shared engine machinery: found keys, exact verification, deadline and
stop flag, stats, summary copies.

Copy of the pure-Python parts of keyhuntm1cpu_tpu/engine/common.py.
SearchStats.add feeds the process-wide metrics registry (core/metrics.py,
served by --metrics-port) under the JAX package's names; the search loop
(engine/pipeline.py) starts SearchStats' rate at each call. Found keys are
appended to KEYFOUNDKEYFOUND.txt, and every device candidate is re-verified
with the exact python-int reference before it is reported.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from ..core.metrics import get_metrics
from ..core.security import SecureBuffer
from ..ref import ecref, hashref


@dataclass(frozen=True)
class FoundKey:
    private_key: int
    pubkey: Tuple[int, int]
    compressed: bool = True
    target: str = ""

    def to_lines(self) -> str:
        pk = self.private_key
        pub = ecref.serialize_pubkey(self.pubkey, self.compressed).hex()
        addr = hashref.pubkey_to_address(self.pubkey, self.compressed)
        return (
            f"Private key: {pk:064x}\n"
            f"Pubkey: {pub}\n"
            f"Address: {addr}\n"
            f"Target: {self.target}\n"
        )


def write_found_key(found: FoundKey, path: str = "KEYFOUNDKEYFOUND.txt") -> None:
    """Append a found key, staging the secret through a page-locked buffer."""
    data = found.to_lines().encode()
    with SecureBuffer(len(data)) as sb:
        sb.write(data)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
        try:
            os.write(fd, sb.view())
        finally:
            os.close(fd)


class Deadline:
    """Wall-clock bound for a search loop (None = unbounded; 0 expires
    at once, so nothing dispatches). Also honours the process-wide stop
    flag of request_stop(): a stopped search ends at its next chunk
    boundary and force-saves its checkpoint."""

    __slots__ = ("_t",)
    _stop = False  # process-wide, set by request_stop()

    def __init__(self, max_seconds: Optional[float]):
        self._t = None if max_seconds is None else time.time() + max_seconds

    def expired(self) -> bool:
        if Deadline._stop:
            return True
        return self._t is not None and time.time() >= self._t


def request_stop() -> None:
    """Ask every running search loop to stop at its next chunk boundary."""
    Deadline._stop = True


def clear_stop() -> None:
    Deadline._stop = False


def stop_requested() -> bool:
    """True once request_stop() fired (a search that returned early did so
    with partial coverage)."""
    return Deadline._stop


def install_stop_handlers(log=None) -> None:
    """The first SIGTERM or SIGINT asks every search loop to stop at its
    next chunk boundary (checkpoints force-save, coverage stays exact); a
    second signal of either kind reaches the previous handlers (an
    immediate exit). Main thread only (the signal module's rule)."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        return
    if log is None:
        from ..core.log import get_logger

        log = get_logger()
    clear_stop()  # a stopped run earlier in this process must not leak

    def handler(signum, frame):
        request_stop()
        log.warn(f"stop requested (signal {signum}): finishing current chunk, "
                 "saving checkpoint; signal again to force quit")
        for s, h in prev.items():
            signal.signal(s, h)

    prev = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        prev[s] = signal.signal(s, handler)


def verify_candidate_scalar(k: int, target_pubkey: Tuple[int, int]) -> Optional[int]:
    """Exact check: k*G == target (or -k, X-only symmetry)? Returns the
    canonical private key in [1, n) or None."""
    k_mod = k % ecref.N
    if k_mod == 0:
        return None
    pt = ecref.scalar_mult(k_mod)
    if pt == target_pubkey:
        return k_mod
    if pt is not None and (pt[0], (-pt[1]) % ecref.P) == target_pubkey:
        return ecref.N - k_mod
    return None


def summary_to_host(outs: torch.Tensor):
    """Start a chunk summary's copy to the host. CUDA: a non-blocking copy
    into PINNED memory plus an event (a pageable copy would block and
    serialise every chunk). Returns (host tensor, event or None); wait on
    the event before reading the tensor."""
    if outs.device.type != "cuda":
        return outs, None
    host = torch.empty(outs.shape, dtype=outs.dtype, pin_memory=True)
    host.copy_(outs, non_blocking=True)
    # with the timeline on, the event also ends the chunk's device interval
    ev = torch.cuda.Event(enable_timing=get_metrics().timeline is not None)
    ev.record(torch.cuda.current_stream(outs.device))  # the copy's stream
    return host, ev


@dataclass
class SearchStats:
    """Throughput accounting: each giant step covers its full stride of
    candidate keys (the reference's keys = steps * N convention);
    multiplier counts the x2 both-parity / x3 endomorphism keys each
    brute-force point covers (keyhunt.cpp:2175-2187). The rate counts from
    the start of the search call (begin()), not the engine's creation:
    set-up is left out."""

    keys_covered: int = 0
    multiplier: int = 1
    started_at: float = field(default_factory=time.time)
    start_keys: int = 0  # keys_covered when the rate's window began

    def begin(self) -> None:
        """A search call starts: the rate counts from here."""
        self.started_at = time.time()
        self.start_keys = self.keys_covered

    def add(self, keys: int) -> None:
        """Count keys covered (a chunk's) and feed the metrics registry:
        one counter and one gauge under its lock."""
        self.keys_covered += keys
        get_metrics().inc_and_set_gauge("keys_covered", keys * self.multiplier,
                                        "keys_per_sec_engine", self.keys_per_sec)

    def resume(self, keys: int) -> None:
        """Count the keys a checkpoint's run covered, outside the rate."""
        self.start_keys += keys
        self.add(keys)

    @property
    def elapsed(self) -> float:
        return max(time.time() - self.started_at, 1e-9)

    @property
    def keys_per_sec(self) -> float:
        return (self.keys_covered - self.start_keys) * self.multiplier / self.elapsed

    def human(self) -> str:
        rate = self.keys_per_sec
        for unit in ("", "K", "M", "G", "T", "P", "E", "Z"):
            if rate < 1000:
                return f"{rate:.2f} {unit}keys/s"
            rate /= 1000
        return f"{rate:.2f} Ykeys/s"
