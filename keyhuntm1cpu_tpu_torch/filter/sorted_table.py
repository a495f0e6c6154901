"""Sorted 64-bit-truncated key table with a batched lower-bound search.

Port of the part of keyhuntm1cpu_tpu/filter/sorted_table.py the minikeys
and brute paths need (``SortedXTable``, ``build_sorted_table``, ``lookup``,
``trunc64_from_limbs``). Keys are
64-bit truncations (hi, lo) of a hash160 or an x coordinate with a payload
index. The JAX package keeps two u32 planes and runs a lock-step binary
search; here the packed key (hi << 32 | lo) is stored with bit 63 flipped,
so its order as a signed int64 is the unsigned order, and one
``torch.searchsorted`` finds every query's lower bound.

Truncation collisions: two entries may share a key; the lower-bound
position and its successor are both checked (``found``, ``found2``), so a
duplicated key still surfaces both payloads. The engines verify every
candidate exactly on the host anyway.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_FLIP = -(1 << 63)  # bit 63, as an int64


class SortedXTable(NamedTuple):
    key: torch.Tensor  # (m,) int64 (hi << 32 | lo) ^ bit 63, ascending
    idx: torch.Tensor  # (m,) int32 payload (u32 bits)


class LookupResult(NamedTuple):
    found: torch.Tensor  # (B,) bool: the entry at the lower bound matches
    idx: torch.Tensor  # (B,) int32 payload there (valid iff found)
    found2: torch.Tensor  # (B,) bool: its successor matches too (a duplicate)
    idx2: torch.Tensor  # (B,) int32 payload at the successor


def build_sorted_table(hi: np.ndarray, lo: np.ndarray, idx: np.ndarray,
                       device="cpu") -> SortedXTable:
    """Host: sort (hi, lo, idx) by the packed 64-bit key (stable) and
    upload to `device`."""
    key = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    if not len(key):
        raise ValueError("empty key table")
    order = np.argsort(key, kind="stable")
    flipped = (key[order] ^ np.uint64(1 << 63)).view(np.int64)
    payload = np.asarray(idx, np.uint32)[order].view(np.int32)
    return SortedXTable(torch.from_numpy(flipped).to(device),
                        torch.from_numpy(payload).to(device))


def query_keys(qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 words in int32 (or int64) tensors -> flipped int64 keys."""
    hi = qhi.to(torch.int64) & 0xFFFFFFFF
    lo = qlo.to(torch.int64) & 0xFFFFFFFF
    # hi * 2^32 + lo as the two's-complement bits of the u64, then flip bit 63
    signed_hi = (hi ^ 0x80000000) - 0x80000000
    return (signed_hi * (1 << 32) + lo) ^ _FLIP


def lookup(table: SortedXTable, qhi: torch.Tensor, qlo: torch.Tensor) -> LookupResult:
    """Lower-bound search of (B,) query keys, with the JAX package's
    found/found2 semantics; no host sync."""
    m = table.key.shape[0]
    q = query_keys(qhi, qlo)
    lb = torch.searchsorted(table.key, q)
    pos = lb.clamp(max=m - 1)
    pos2 = (lb + 1).clamp(max=m - 1)
    found = (lb < m) & (table.key[pos] == q)
    found2 = (lb + 1 < m) & (table.key[pos2] == q)
    return LookupResult(found, table.idx[pos], found2, table.idx[pos2])


def trunc64_from_limbs(x: torch.Tensor):
    """(hi, lo) 64-bit truncation of (8, ...) limb-major field elements:
    the low 64 bits, limbs 1 and 0 (the xpoint compare key)."""
    return x[1], x[0]
