"""A per-client token bucket and a page-locked, wiped-on-close staging
buffer for private-key material (copies of RateLimiter and SecureBuffer
from keyhuntm1cpu_tpu/core/security.py).

The pages are anonymous mmap, locked out of swap with mlock(2) where
RLIMIT_MEMLOCK allows (``locked`` records the outcome), kept out of core
dumps with MADV_DONTDUMP where available, and zeroed with a ctypes memset
before release. Python-level copies of the data are not covered.
"""

from __future__ import annotations

import ctypes
import mmap
import threading
import time
from typing import Dict, Tuple


class RateLimiter:
    """Token-bucket limiter keyed by client id (e.g. source IP).

    allow(key) consumes one token; buckets refill at `rate` tokens/s up
    to `burst`. Thread-safe; stale buckets are pruned so a scanner cannot
    grow memory unboundedly.
    """

    def __init__(self, rate: float = 5.0, burst: int = 10, max_clients: int = 4096):
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_clients = max_clients
        self._lock = threading.Lock()
        self._buckets: Dict[str, Tuple[float, float]] = {}  # key -> (tokens, t)

    def allow(self, key: str) -> bool:
        now = time.monotonic()
        with self._lock:
            tokens, t = self._buckets.get(key, (self.burst, now))
            tokens = min(self.burst, tokens + (now - t) * self.rate)
            ok = tokens >= 1.0
            if ok:
                tokens -= 1.0
            self._buckets[key] = (tokens, now)
            if len(self._buckets) > self.max_clients:
                # drop the stalest half
                items = sorted(self._buckets.items(), key=lambda kv: kv[1][1])
                for k, _ in items[: len(items) // 2]:
                    del self._buckets[k]
            return ok


class SecureBuffer:
    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("size must be positive")
        self._size = size
        self._mm = mmap.mmap(-1, size)
        self._addr = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
        self.locked = False
        try:
            self._libc = ctypes.CDLL(None, use_errno=True)
            self.locked = self._libc.mlock(ctypes.c_void_p(self._addr),
                                           ctypes.c_size_t(size)) == 0
        except OSError:
            self._libc = None
        try:
            self._mm.madvise(mmap.MADV_DONTDUMP)
        except (AttributeError, OSError):
            pass

    def view(self) -> memoryview:
        return memoryview(self._mm)

    def write(self, data: bytes, offset: int = 0) -> None:
        if offset + len(data) > self._size:
            raise ValueError("write past end of SecureBuffer")
        self._mm[offset : offset + len(data)] = data

    def close(self) -> None:
        if self._mm.closed:
            return
        ctypes.memset(self._addr, 0, self._size)
        if self.locked and self._libc is not None:
            self._libc.munlock(ctypes.c_void_p(self._addr), ctypes.c_size_t(self._size))
        del self._addr  # release the exported buffer before closing the mmap
        self._mm.close()

    def __enter__(self) -> "SecureBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
