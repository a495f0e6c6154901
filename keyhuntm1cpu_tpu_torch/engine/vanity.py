"""Vanity prefixes as hash160 intervals.

Port of the host half of keyhuntm1cpu_tpu/engine/vanity.py: a base58
P2PKH prefix maps to one or more [lo, hi] intervals of 20-byte hash160
values (the reference's addvanity padding strategy). The search itself is
the fused brute chunk (engine/brute.py, ``BruteEngine(intervals=,
prefixes=)``): K4 compares every hash against the intervals' 64-bit
bounds, and the host checks each hit's base58 prefix exactly. The JAX
package's ``VanityEngine`` (an XLA chain walk its CLI takes on a CPU
backend) has no counterpart: the port picks its path by the target set,
not by the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ref import hashref


def vanity_intervals(prefix: str) -> List[Tuple[bytes, bytes]]:
    """[(lo20, hi20)] hash160 intervals whose P2PKH addresses can start
    with `prefix`: extend it with the smallest / largest base58 digit at
    every plausible address length, then merge overlaps."""
    if not prefix.startswith("1"):
        raise ValueError("P2PKH vanity prefixes start with '1' (version 0x00)")
    out = []
    for total_len in range(max(len(prefix), 26), 36):
        lo_raw = hashref.b58decode(prefix + "1" * (total_len - len(prefix)))
        hi_raw = hashref.b58decode(prefix + "z" * (total_len - len(prefix)))

        # a valid address payload is exactly 25 bytes with version 0x00
        def pad25(b: bytes) -> Optional[bytes]:
            if len(b) > 25:
                return None
            return b"\x00" * (25 - len(b)) + b

        lo_p, hi_p = pad25(lo_raw), pad25(hi_raw)
        if lo_p is None and hi_p is None:
            continue
        if lo_p is None:
            lo_p = b"\x00" * 25
        if hi_p is None:
            hi_p = b"\xff" * 25
        if lo_p[0] != 0 and hi_p[0] != 0:
            continue
        lo20 = lo_p[1:21] if lo_p[0] == 0 else b"\x00" * 20
        hi20 = hi_p[1:21] if hi_p[0] == 0 else b"\xff" * 20
        if lo20 <= hi20:
            out.append((lo20, hi20))
    if not out:
        raise ValueError(f"prefix {prefix!r} matches no address interval")
    out.sort()
    merged = [out[0]]
    for lo, hi in out[1:]:
        if lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _h160_to_words_be(h: bytes) -> np.ndarray:
    """20 bytes -> 5 big-endian uint32 words (lexicographic order)."""
    return np.frombuffer(h, dtype=">u4").astype(np.uint32)
