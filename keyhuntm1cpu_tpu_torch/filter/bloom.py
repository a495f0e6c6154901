"""Bloom filter with reference-compatible semantics, vectorized on host:
a numpy copy of keyhuntm1cpu_tpu/filter/bloom.py (files load in either
package).

Same construction as the reference's libbloom2 (bloom/bloom.cpp):
- sizing: bits_per_entry = -ln(fp) / ln(2)^2, hashes = round(bpe * ln 2)
  (bloom.cpp:92-118)
- double hashing: a = XXH64(key, seed), b = XXH64(key, a),
  bit_i = (a + i*b) mod bits (bloom.cpp:60-85)

Keys here are fixed 8-byte (uint64) truncated X values / hash prefixes, so
XXH64 specializes to its <32-byte small path — implemented vectorized over
numpy uint64 lanes. Build/check run on host (numpy); the engines' device
path uses filter/sorted_table.py. Role: the memory-frugal host
membership for huge target sets that must not live in device memory
(about 29 bits a key at fp 1e-6). The 32-byte-message
variant backing reference file interop lives in utils/legacy.py;
utils/xxhash.py has the general-length scalar form. Save/load uses a
versioned npz with a sha256 checksum (replacing the reference's
raw-struct dumps, keyhunt.cpp:1896-1915, per SURVEY.md §7.4).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)


def _rotl64(x: np.ndarray, n: int) -> np.ndarray:
    n = np.uint64(n)
    return (x << n) | (x >> (np.uint64(64) - n))


def xxh64_u64(value: np.ndarray, seed: np.ndarray | int) -> np.ndarray:
    """XXH64 of an 8-byte little-endian message held as uint64 lanes."""
    old = np.seterr(over="ignore")
    try:
        value = value.astype(np.uint64)
        seed = np.asarray(seed, dtype=np.uint64)
        h = seed + _P5 + np.uint64(8)
        k1 = value * _P2
        k1 = _rotl64(k1, 31)
        k1 = k1 * _P1
        h ^= k1
        h = _rotl64(h, 27) * _P1 + _P4
        h ^= h >> np.uint64(33)
        h *= _P2
        h ^= h >> np.uint64(29)
        h *= _P3
        h ^= h >> np.uint64(32)
        return h
    finally:
        np.seterr(**old)


@dataclass
class BloomFilter:
    """Double-hashing bloom over uint64 keys."""

    bits: int
    hashes: int
    entries: int
    fp_rate: float
    array: np.ndarray  # (ceil(bits/8),) uint8

    SEED = 0x59F2815B16F81798  # reference bloom/bloom.cpp:69 seed constant

    @classmethod
    def create(cls, entries: int, fp_rate: float = 1e-6) -> "BloomFilter":
        entries = max(entries, 2)
        bpe = -math.log(fp_rate) / (math.log(2) ** 2)
        bits = int(entries * bpe)
        bits += 8 - bits % 8
        hashes = max(1, int(math.ceil(math.log(2) * bpe)))
        return cls(bits, hashes, entries, fp_rate, np.zeros(bits // 8, dtype=np.uint8))

    def _positions(self, keys: np.ndarray) -> np.ndarray:
        """(B, hashes) bit positions."""
        old = np.seterr(over="ignore")
        try:
            a = xxh64_u64(keys, self.SEED)
            b = xxh64_u64(keys, a)
            i = np.arange(self.hashes, dtype=np.uint64)[None, :]
            return ((a[:, None] + b[:, None] * i) % np.uint64(self.bits)).astype(
                np.uint64
            )
        finally:
            np.seterr(**old)

    def add(self, keys: np.ndarray) -> None:
        pos = self._positions(np.atleast_1d(keys)).reshape(-1)
        np.bitwise_or.at(self.array, (pos >> 3).astype(np.int64),
                         np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8))

    def check(self, keys: np.ndarray) -> np.ndarray:
        """(B,) bool — possibly-present."""
        pos = self._positions(np.atleast_1d(keys))
        byte = self.array[(pos >> 3).astype(np.int64)]
        bit = (byte >> (pos & np.uint64(7)).astype(np.uint8)) & 1
        return bit.all(axis=1)

    # -- persistence (versioned + checksummed, cf. keyhunt.cpp:1881-2025) --

    def save(self, path: str) -> None:
        digest = hashlib.sha256(self.array.tobytes()).hexdigest()
        np.savez_compressed(
            path,
            version=np.int64(1),
            bits=np.int64(self.bits),
            hashes=np.int64(self.hashes),
            entries=np.int64(self.entries),
            fp_rate=np.float64(self.fp_rate),
            checksum=np.frombuffer(bytes.fromhex(digest), dtype=np.uint8),
            array=self.array,
        )

    @classmethod
    def load(cls, path: str, verify_checksum: bool = True) -> "BloomFilter":
        with np.load(path) as z:
            if int(z["version"]) != 1:
                raise ValueError("unsupported bloom file version")
            arr = z["array"]
            if verify_checksum:
                digest = hashlib.sha256(arr.tobytes()).digest()
                if digest != z["checksum"].tobytes():
                    raise ValueError("bloom checksum mismatch")
            return cls(
                int(z["bits"]),
                int(z["hashes"]),
                int(z["entries"]),
                float(z["fp_rate"]),
                arr,
            )
