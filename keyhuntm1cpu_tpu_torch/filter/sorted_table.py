"""Sorted 64-bit-truncated key table with a batched lower-bound search.

Port of keyhuntm1cpu_tpu/filter/sorted_table.py (``SortedXTable``,
``build_sorted_table``, ``build_sorted_table_device``, ``lookup``,
``trunc64_from_limbs``): the minikeys and brute paths' target tables and
the device-resolve BSGS baby table. Keys are
64-bit truncations (hi, lo) of a hash160 or an x coordinate with a payload
index. The JAX package keeps two u32 planes and runs a lock-step binary
search; here the packed key (hi << 32 | lo) is stored with bit 63 flipped,
so its order as a signed int64 is the unsigned order, and one
``torch.searchsorted`` finds every query's lower bound.

Truncation collisions: two entries may share a key; the lower-bound
position and its successor are both checked (``found``, ``found2``), so a
duplicated key still surfaces both payloads. The engines verify every
candidate exactly on the host anyway.

``lookup_summary`` is the walker step's exact lookup of its compacted
probe survivors fused with the step's summary row (the XLA glue of the
JAX ``_brute_chunk_impl`` after its filtered lookup): one launch of
csrc/lookup.cu ``kh_lookup_summary`` on the card, counted in
``lookup_summary.launches``; its plain version ``lookup_summary_ref``
(``lookup`` and the same torch ops) runs for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build

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


def sort_keys(key: torch.Tensor, idx: Optional[torch.Tensor] = None) -> SortedXTable:
    """A table from flipped int64 keys in payload order, on their device:
    one stable sort (ties keep their order, as the JAX package's stable
    lax.sort keeps them) and the payload gathered by its permutation. idx:
    (m,) int32; None means the payload j = position + 1 (a baby table in j
    order)."""
    if not key.numel():
        raise ValueError("empty key table")
    skey, order = torch.sort(key, stable=True)
    del key
    payload = (order + 1).to(torch.int32) if idx is None else idx[order]
    return SortedXTable(skey, payload)


def build_sorted_table_device(hi: torch.Tensor, lo: torch.Tensor,
                              idx: torch.Tensor) -> SortedXTable:
    """Device: sort (hi, lo, idx) (int32 tensors holding u32 bits) by the
    packed 64-bit key where they live, stably (sorted_table.
    build_sorted_table_device): no host round trip."""
    return sort_keys(query_keys(hi, lo), idx)


def write_keys(key: torch.Tensor, start: int, hi: torch.Tensor, lo: torch.Tensor) -> None:
    """key[start:start + n] = the flipped int64 keys of n (hi, lo) int32
    words, in place (two strided copies into the key's halves)."""
    w = key.view(torch.int32).view(-1, 2)  # little-endian: lo, then hi with bit 31 flipped
    w[start: start + hi.shape[0], 0] = lo
    w[start: start + hi.shape[0], 1] = hi ^ -(1 << 31)


def key_words(key: torch.Tensor):
    """(hi, lo) int32 words of flipped int64 keys (contiguous copies)."""
    w = key.view(torch.int32).view(-1, 2)
    return (w[:, 1] ^ -(1 << 31)).contiguous(), w[:, 0].contiguous()


def table_planes(table: SortedXTable):
    """(hi, lo, idx) uint32 numpy arrays of a table, in its sorted order:
    the JAX package's planes (table files, the host rescan)."""
    key = table.key.cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)
    return ((key >> np.uint64(32)).astype(np.uint32), key.astype(np.uint32),
            table.idx.cpu().numpy().view(np.uint32).copy())


def table_from_planes(hi: np.ndarray, lo: np.ndarray, idx: np.ndarray,
                      device="cpu") -> SortedXTable:
    """A table from planes that are sorted already (a JAX table or a table
    file) on `device`, without a sort; raises ValueError if they are not
    sorted by the packed key."""
    key = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    if not len(key) or len(idx) != len(key):
        raise ValueError("a table needs equal, non-empty hi, lo and idx planes")
    if np.any(key[1:] < key[:-1]):
        raise ValueError("table planes are not sorted by their 64-bit key")
    flipped = (key ^ np.uint64(1 << 63)).view(np.int64)
    payload = np.array(idx, dtype=np.uint32).view(np.int32)  # a writable copy
    return SortedXTable(torch.from_numpy(flipped).to(device), torch.from_numpy(payload).to(device))


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


# ---------------------------------------------------------------------------
# lookup_summary: the walker step's exact lookup and summary row
# ---------------------------------------------------------------------------


def summary_width(C: int, W: int) -> int:
    """Words of a walker step's summary row: C positions, C table rows,
    per walker n_deg, first_deg and adv_deg, and the survivor count."""
    return 2 * C + 3 * W + 1


def lookup_summary_ref(table: SortedXTable, pos, qhi, qlo, n, degenerate, adv_degenerate,
                       total: int) -> torch.Tensor:
    """Plain torch version of the kernel (see lookup_summary): ``lookup``
    of the survivors and the summary ops of the JAX _brute_chunk_impl."""
    W, U = degenerate.shape
    npts = 2 * U + 1
    lr = lookup(table, qhi, qlo)
    valid = pos < total
    # hits on degenerate lanes (garbage x) are dropped: lanes +u and -u
    # share the flag, the center never has one
    degm = torch.cat([degenerate, degenerate, torch.zeros_like(degenerate[:, :1])],
                     dim=1).reshape(-1)
    live = ~degm[pos.clamp(max=total - 1).long() % (W * npts)]
    hit = (lr.found | lr.found2) & valid & live
    return torch.cat([
        torch.where(hit, pos, total).to(torch.int32),
        torch.where(hit, lr.idx, 0).to(torch.int32),
        degenerate.sum(dim=1, dtype=torch.int32),
        degenerate.to(torch.uint8).argmax(dim=1).to(torch.int32),
        adv_degenerate.to(torch.int32),
        n.reshape(1)])


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need a contiguous {dtype} tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def lookup_summary(table: SortedXTable, pos: torch.Tensor, qhi: torch.Tensor,
                   qlo: torch.Tensor, n: torch.Tensor, degenerate: torch.Tensor,
                   adv_degenerate: torch.Tensor, total: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One walker step's summary row (2C + 3W + 1,) int32 from the probe's
    C compacted survivors: pos (C,) int32 (total = padding), their key
    words qhi, qlo (C,) int32 and count n () int32; the step's degenerate
    (W, U) and adv_degenerate (W,) bool flags; total = nq*W*(2U+1).
    Words: the candidate positions (total where no live hit), their table
    payloads (0 there), per walker the degenerate-lane count, the first
    degenerate lane (0 when none) and the advance flag, then n. Written
    into `out` (a contiguous (2C + 3W + 1,) int32 row) when given."""
    C = pos.shape[0] if pos.dim() == 1 else -1
    W, U = degenerate.shape if degenerate.dim() == 2 else (-1, -1)
    m = table.key.shape[0]
    for name, t, dtype, shape in (
            ("pos", pos, torch.int32, (C,)), ("qhi", qhi, torch.int32, (C,)),
            ("qlo", qlo, torch.int32, (C,)), ("n", n, torch.int32, ()),
            ("table key", table.key, torch.int64, (m,)),
            ("table idx", table.idx, torch.int32, (m,)),
            ("degenerate", degenerate, torch.bool, (W, U)),
            ("adv_degenerate", adv_degenerate, torch.bool, (W,))):
        _check(name, t, dtype, shape)
    if min(C, W, U, m, total) < 1 or total >= 1 << 31:
        raise ValueError(f"lookup_summary needs C, W, U, m, total >= 1 and total < 2^31 "
                         f"(C={C}, W={W}, U={U}, m={m}, total={total})")
    if out is not None:
        _check("out", out, torch.int32, (summary_width(C, W),))
    args = (pos, qhi, qlo, n, table.key, table.idx, degenerate, adv_degenerate)
    if not _build.on_cuda(*args, *(() if out is None else (out,))):
        row = lookup_summary_ref(table, pos, qhi, qlo, n, degenerate, adv_degenerate, total)
        return row if out is None else out.copy_(row)
    if out is None:
        out = torch.empty((summary_width(C, W),), dtype=torch.int32, device=pos.device)
    _build.launch("kh_lookup_summary", *(t.data_ptr() for t in args + (out,)), m, C, W, U,
                  total, _build.stream(pos))
    lookup_summary.launches += 1
    return out


lookup_summary.launches = 0
