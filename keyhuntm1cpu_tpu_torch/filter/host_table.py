"""Host-resident exact baby table for BSGS host-resolve mode.

numpy copy of keyhuntm1cpu_tpu/filter/host_table.py, with the same cache
format and default directory, so both packages share one cache:

    baby_{m}.keys  (m,) uint64 LE  sorted trunc64(x(j*G))
    baby_{m}.idx   (m,) uint32 LE  payload j-1
    baby_{m}.json  meta (written LAST -> marks a complete build)

The table is built by the native C++ builder (native/keyhunt_host.cpp,
compiled on first use by ``_build.host_lib``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .. import _build

DEFAULT_CACHE_DIR = os.environ.get(
    "KEYHUNT_TABLE_CACHE", os.path.join(_build.REPO_DIR, ".table_cache")
)


def native_keys_range(from_j: int, count: int) -> np.ndarray:
    """trunc64(x(j*G)) for j in [from_j, from_j+count), exact native walk."""
    out = np.empty(count, dtype=np.uint64)
    rc = _build.host_lib().kh_baby_keys_range(
        from_j, count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    )
    if rc != 0:
        raise RuntimeError(f"kh_baby_keys_range failed rc={rc}")
    return out


@dataclass(frozen=True)
class HostTable:
    """Sorted key plane + payload plane (j-1), host-resident."""

    keys: np.ndarray  # (m,) uint64, sorted
    idx: np.ndarray  # (m,) uint32, payload j-1

    @property
    def m(self) -> int:
        return int(self.keys.shape[0])

    def resolve(self, qhi: np.ndarray, qlo: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """All (query_row, j) matches for (B,) uint32 query planes; js are
        1-based baby indices, one per duplicate-key match."""
        q = (qhi.astype(np.uint64) << np.uint64(32)) | qlo.astype(np.uint64)
        left = np.searchsorted(self.keys, q, side="left")
        right = np.searchsorted(self.keys, q, side="right")
        counts = right - left
        hit = counts > 0
        if not hit.any():
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))
        rows = np.repeat(np.nonzero(hit)[0], counts[hit])
        offs = np.concatenate(
            [np.arange(c) + lo for lo, c in zip(left[hit], counts[hit])]
        )
        js = self.idx[offs].astype(np.uint64) + np.uint64(1)
        return rows, js

    def prefault(self) -> None:
        """Pull every page of mmapped planes into the OS cache in one
        sequential pass, so page-ins stay out of the first chunks' decode."""
        for arr in (self.keys, self.idx):
            if isinstance(arr, np.memmap):
                step = (1 << 24) // arr.itemsize
                s = np.uint64(0)
                with np.errstate(over="ignore"):
                    for off in range(0, arr.shape[0], step):
                        s += arr[off : off + step : 4096 // arr.itemsize
                                 ].sum(dtype=np.uint64)


def _paths(m: int, cache_dir: str) -> Tuple[str, str, str]:
    base = os.path.join(cache_dir, f"baby_{m}")
    return base + ".keys", base + ".idx", base + ".json"


def _sample_digest(path: str, size: int) -> str:
    """sha256 over the first/middle/last MB (catches truncation cheaply)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
        if size > (2 << 20):
            f.seek(size // 2)
            h.update(f.read(1 << 20))
        if size > (1 << 20):
            f.seek(max(0, size - (1 << 20)))
            h.update(f.read(1 << 20))
    return h.hexdigest()


def build_host_table(m: int, cache_dir: str = DEFAULT_CACHE_DIR,
                     progress: bool = False) -> None:
    """Native build -> tmp files -> validate a sample -> meta -> rename.
    The .json meta is written last, so its presence marks completeness."""
    os.makedirs(cache_dir, exist_ok=True)
    kp, ip, mp = _paths(m, cache_dir)
    tkp, tip = kp + ".tmp", ip + ".tmp"
    rc = _build.host_lib().kh_baby_build(m, tkp.encode(), tip.encode(),
                                         1 if progress else 0)
    if rc != 0:
        raise RuntimeError(f"kh_baby_build failed rc={rc}")
    keys = np.memmap(tkp, dtype="<u8", mode="r")
    idx = np.memmap(tip, dtype="<u4", mode="r")
    if keys.shape[0] != m or idx.shape[0] != m:
        raise RuntimeError("built table has wrong size")
    rng = np.random.default_rng(1234)
    for s in rng.integers(0, m, size=min(256, m)).tolist():
        j = int(idx[s]) + 1
        if np.uint64(keys[s]) != native_keys_range(j, 1)[0]:
            raise RuntimeError(f"table validation failed at row {s} (j={j})")
    step = max(1, m // 4096)
    if not bool(np.all(keys[::step][:-1] <= keys[::step][1:])):
        raise RuntimeError("table keys not sorted")
    meta = {
        "version": 1,
        "m": m,
        "keys_bytes": m * 8,
        "idx_bytes": m * 4,
        "keys_sample_sha256": _sample_digest(tkp, m * 8),
        "idx_sample_sha256": _sample_digest(tip, m * 4),
    }
    del keys, idx
    os.replace(tkp, kp)
    os.replace(tip, ip)
    with open(mp + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(mp + ".tmp", mp)


def load_host_table(m: int, cache_dir: str = DEFAULT_CACHE_DIR) -> Optional[HostTable]:
    """Map a cached table (read-only memmaps), or None when absent,
    incomplete or mismatched."""
    kp, ip, mp = _paths(m, cache_dir)
    if not (os.path.exists(kp) and os.path.exists(ip) and os.path.exists(mp)):
        return None
    with open(mp) as f:
        meta = json.load(f)
    if meta.get("version") != 1 or meta.get("m") != m:
        return None
    if os.path.getsize(kp) != m * 8 or os.path.getsize(ip) != m * 4:
        return None
    if (_sample_digest(kp, m * 8) != meta["keys_sample_sha256"]
            or _sample_digest(ip, m * 4) != meta["idx_sample_sha256"]):
        return None
    return HostTable(np.memmap(kp, dtype="<u8", mode="r"),
                     np.memmap(ip, dtype="<u4", mode="r"))


def ensure_host_table(m: int, cache_dir: str = DEFAULT_CACHE_DIR,
                      progress: bool = False) -> HostTable:
    """Cached load, else native build then load."""
    t = load_host_table(m, cache_dir)
    if t is not None:
        return t
    build_host_table(m, cache_dir, progress=progress)
    t = load_host_table(m, cache_dir)
    if t is None:
        raise RuntimeError("host table build did not produce a loadable table")
    return t
