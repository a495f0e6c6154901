"""General-length XXH64 (pure python, from the public spec): a copy of
keyhuntm1cpu_tpu/utils/xxhash.py.

The reference vendors the canonical C xxhash (5.5 kLoC) solely to feed
its bloom filters; here the general scalar form completes the capability
(the hot vectorized specializations live where they are used:
filter/bloom.py for 8-byte keys, utils/legacy.py for 32-byte X values).
Validated against canonical XXH64 outputs for lengths 0..100 in
tests/test_legacy.py.
"""

from __future__ import annotations

import struct

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    return (_rotl(acc, 31) * _P1) & _M


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        while pos + 32 <= n:
            lanes = struct.unpack_from("<4Q", data, pos)
            v1 = _round(v1, lanes[0])
            v2 = _round(v2, lanes[1])
            v3 = _round(v3, lanes[2])
            v4 = _round(v4, lanes[3])
            pos += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while pos + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, pos)
        h = ((_rotl(h ^ _round(0, lane), 27) * _P1) + _P4) & _M
        pos += 8
    if pos + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, pos)
        h = ((_rotl(h ^ (lane * _P1) & _M, 23) * _P2) + _P3) & _M
        pos += 4
    while pos < n:
        h = ((_rotl(h ^ (data[pos] * _P5) & _M, 11)) * _P1) & _M
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h
