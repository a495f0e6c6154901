"""The filters' stated layouts and the survivor rates they imply.

A BSGS baby key is trunc64(x(j*G)). The level-1 bitmap is direct-address:
a key sets bit (key mod 2^bits). The bloom2 (k = 2) sets two bits chosen
by two fmix32 mixes of the key's 32-bit halves, with two more mixes
extending the index past 2^32 bits. The fused brute path's large target
sets sit in 128 lanes by the low 7 bits of a target's 64-bit compare value,
each lane holding the high 32 bits. These are the structures' definitions,
restated here so that the reference can check what the program built and
work out how many survivors a random query passes.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

_M32 = 0xFFFFFFFF


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = h * 0x85EBCA6B & _M32
    h ^= h >> 13
    h = h * 0xC2B2AE35 & _M32
    return h ^ (h >> 16)


def bitmap_bit(key: int, bits_log2: int) -> int:
    return key & ((1 << bits_log2) - 1)


def bloom2_bits(key: int, bits_log2: int) -> Tuple[int, int]:
    """The two bit indices of a 64-bit key in a 2^bits_log2-bit bloom2."""
    hi, lo = key >> 32, key & _M32
    h1 = _fmix32(lo ^ (hi * 0x9E3779B1 & _M32) ^ 0x2545F491)
    h2 = _fmix32(hi ^ (lo * 0x85EBCA77 & _M32) ^ 0x633D9ABD)
    if bits_log2 <= 32:
        mask = (1 << bits_log2) - 1
        return h1 & mask, h2 & mask
    e1 = _fmix32(hi ^ (lo * 0xC2B2AE3D & _M32) ^ 0x27D4EB2F)
    e2 = _fmix32(lo ^ (hi * 0x165667B1 & _M32) ^ 0x9E3779B9)
    emask = (1 << (bits_log2 - 32)) - 1
    return h1 | (e1 & emask) << 32, h2 | (e2 & emask) << 32


def set_share(inserts: float, bits_log2: int) -> float:
    """Expected share of set bits after `inserts` uniform insertions."""
    return -math.expm1(inserts * math.log1p(-2.0 ** -bits_log2))


def bsgs_survivors_per_chunk(queries: int, m: int, bits_log2: int,
                             bloom2_bits_log2: int = 0) -> float:
    """Expected cascade survivors of one chunk's random queries against m
    baby keys: the bitmap's set share, times the bloom2's set share squared
    (two independent probes) when the cascade has its second stage."""
    p = set_share(m, bits_log2)
    if bloom2_bits_log2:
        p *= set_share(2 * m, bloom2_bits_log2) ** 2
    return queries * p


def bucket_lanes(values64: Iterable[int]) -> Dict[int, set]:
    """lane -> the set of high words the lane holds."""
    lanes: Dict[int, set] = {}
    for v in values64:
        lanes.setdefault(v & 127, set()).add(v >> 32)
    return lanes


def bucket_rows(values64) -> int:
    """Rows of the lane table: the fullest lane's entries, duplicates
    included, rounded up to a multiple of 8 (at least 8)."""
    counts: Dict[int, int] = {}
    for v in values64:
        counts[v & 127] = counts.get(v & 127, 0) + 1
    return max(8, -(-max(counts.values()) // 8) * 8)


def brute_hit_words_per_chunk(keys: int, queries_per_key: int, lanes: Dict[int, set]) -> float:
    """Expected non-zero hit words of a chunk of random keys under the
    bucketed compare: a query hits when its high word is among its lane's
    (a lane with no target holds zeros, so one value), and a key's word is
    non-zero when any of its queries hits."""
    held = sum(len(lanes.get(lane, ())) or 1 for lane in range(128))
    p = held / 128.0 / 2.0**32
    return keys * -math.expm1(queries_per_key * math.log1p(-p))
