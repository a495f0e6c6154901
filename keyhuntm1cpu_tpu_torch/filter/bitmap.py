"""Device bitmap + level-2 bloom cascade, the filter-insert kernel (K3) and
the probe kernel.

Port of keyhuntm1cpu_tpu/filter/bitmap.py:

- level 1: a 2^b-bit direct-address bitmap over the low bits of each
  64-bit key (one gather per query), built by K3 on the card for a brute
  target set (``build_bitmap``, on the host for CPU tensors), streamed on
  the card for host-resolve BSGS (``insert_keys``), or built from a
  device-resolve baby table (``build_bitmap_device``);
- level 2: a k=2 hashed bloom (fmix32 mixes of the key), probed only on
  level-1 survivors; a device-resolve table's (``build_bloom2_device``,
  K3's bloom-only form) is capped at 2^32 bits as the JAX package's is;
- compaction keeps the first `size` survivor positions in ascending order
  (``compact_positions``: a prefix sum and one searchsorted — no host sync);
- ``filtered_survivors``: probe and compaction (and the bloom2 stage): the
  cascade of the BSGS chunk in both resolve modes, whose exact search
  (device resolve) runs in the chunk's summary kernel;
  ``filtered_lookup``: the same cascade, then the exact sorted-table
  search of the survivors. The large-target brute path's step runs the
  probe and then sorted_table.lookup_summary, the search fused with the
  step's summary.

``probe`` and ``probe_bloom2`` run the probe kernel (csrc/probe.cu: the
word gather of ``dma_gather`` fused with the bit test) for CUDA tensors
and their plain torch versions for CPU ones. ``probe_compact`` is the
level-1 probe fused with the ordered compaction of its survivors (one
launch in place of the mask, its prefix sum, the searchsorted and the key
gathers); the cascade's level-1 stage runs it where no kernel probed the
keys before. ``bloom2_compact`` is the bloom2 stage in the same form
(csrc/probe.cu kh_bloom2_compact): the bloom2 probe of the stage-1
survivors and their ordered compaction, with the stage-1 overflow's
poison, in one launch. In the BSGS chunk K2 probes the level-1 bitmap
itself (curve/pwalk.walk_blocks with a bitmap: a survivor mask of 32 keys
a word, ``survivor_mask_ref``), and ``mask_compact`` is the level-1 stage:
the ordered compaction of the mask, with probe_compact's output over the
same keys (csrc/probe.cu kh_mask_compact).

Keys are (qhi, qlo) int32 tensors holding u32 bits; filter words are
int32 tensors holding u32 bits. Index math is done in int64 with masks
(torch on the CPU has no u32 arithmetic); 32-bit products are split into
16-bit halves so no int64 product overflows.

``insert_keys`` ORs the first n_keep keys into both filters, or into one
of them alone, IN PLACE, and may count the walk's degenerate lanes in the
same launch: the CUDA kernel K3 (csrc/filter.cu) for CUDA tensors, the
plain torch version for CPU ones. ``build_bitmap`` builds a brute target
bitmap with it on the card.
Nothing on the chunk path calls ``.item()``, ``.cpu()``, ``nonzero`` or
boolean-mask indexing.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..core.metrics import spanned
from ..field.fe import M16, M32, i32, u32
from .sorted_table import LookupResult, SortedXTable, key_words, lookup

MAX_BITS_LOG2 = 35  # 2^30 words (4 GiB): the largest filter either package builds
TABLE_SLICE = 1 << 26  # table keys a K3 launch takes in the filters built from a table


class DeviceBitmap(NamedTuple):
    words: torch.Tensor  # (2^(bits_log2-5),) int32
    bits_log2: int


class DeviceBloom2(NamedTuple):
    words: torch.Tensor  # (2^(bits_log2-5),) int32
    bits_log2: int


def default_bits_log2(m: int) -> int:
    """fp = m/2^b = 2^-12, capped at 2^34 bits (bitmap.default_bits_log2)."""
    return min(34, max(16, int(np.ceil(np.log2(max(m, 2)))) + 12))


def scaled_bits_log2(m: int, mult: int) -> Optional[int]:
    """Bitmap size for the filter-size multiplier -z (bitmap.scaled_bits_log2):
    ceil(log2(mult)) more bits than default_bits_log2(m), at most
    MAX_BITS_LOG2; None for mult <= 1 (the engine's default)."""
    if mult <= 1:
        return None
    return min(MAX_BITS_LOG2, default_bits_log2(m) + math.ceil(math.log2(mult)))


def bloom2_bits_log2(m: int) -> int:
    """Load 2m/2^b = 1/8, capped at 2^32 bits: a device-resolve table's
    bloom2 (bitmap.bloom2_bits_log2)."""
    return min(32, max(16, int(np.ceil(np.log2(max(m, 2)))) + 4))


def bloom2_bits_log2_host(m: int) -> int:
    """Load 2m/2^b = 1/16, capped at 2^35 bits (bitmap.bloom2_bits_log2_host)."""
    return min(35, max(16, int(np.ceil(np.log2(max(m, 2)))) + 5))


def bloom2_fp(m: int, bits_log2: int) -> float:
    """False-positive rate of the k=2 bloom at 2m insertions."""
    load = 2.0 * m / float(1 << bits_log2)
    return float((1.0 - np.exp(-load)) ** 2)


def build_bitmap(hi: np.ndarray, lo: np.ndarray, bits_log2: Optional[int] = None,
                 device="cpu") -> DeviceBitmap:
    """The bitmap over 64-bit keys (hi, lo) (u32 arrays), the level-1
    filter of a brute target set, on `device`. bits_log2 defaults to
    default_bits_log2(len(lo)). On a CUDA device it is built there, as the
    JAX package's on_device build is: the keys are uploaded (8 bytes a
    key) and one K3 launch ORs their bits into an empty bitmap (duplicates
    are harmless under OR). On the CPU the distinct bit indices are sorted
    and OR-reduced per word on the host."""
    if bits_log2 is None:
        bits_log2 = default_bits_log2(len(lo))
    if not 5 <= bits_log2 <= MAX_BITS_LOG2:
        raise ValueError(f"bits_log2 out of range (5..{MAX_BITS_LOG2}): {bits_log2}")
    if torch.device(device).type == "cuda":
        words = empty_filter(bits_log2, device)
        qhi, qlo = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))
                    .to(device) for a in (hi, lo))
        insert_keys(words, bits_log2, None, 0, qhi, qlo, qhi.shape[0])
        return DeviceBitmap(words, bits_log2)
    idx = np.asarray(lo, dtype=np.uint64)
    if bits_log2 > 32:
        ext = np.asarray(hi, dtype=np.uint64) & np.uint64((1 << (bits_log2 - 32)) - 1)
        idx = idx | (ext << np.uint64(32))
    else:
        idx = idx & np.uint64((1 << bits_log2) - 1)
    words = np.zeros(1 << (bits_log2 - 5), dtype=np.uint32)
    uniq = np.unique(idx)
    if len(uniq):
        word = uniq >> np.uint64(5)
        vals = np.left_shift(np.uint32(1), (uniq & np.uint64(31)).astype(np.uint32))
        starts = np.flatnonzero(np.concatenate([[True], word[1:] != word[:-1]]))
        words[word[starts].astype(np.int64)] = np.bitwise_or.reduceat(vals, starts)
    return DeviceBitmap(torch.from_numpy(words.view(np.int32)).to(device), bits_log2)


def empty_filter(bits_log2: int, device) -> torch.Tensor:
    if not 5 <= bits_log2 <= MAX_BITS_LOG2:
        raise ValueError(f"bits_log2 out of range (5..{MAX_BITS_LOG2}): {bits_log2}")
    return torch.zeros(1 << (bits_log2 - 5), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Bit planes (int64 tensors of u32 values in, int64 word index + bit value out)
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 values x and a u32 constant c."""
    return (x * (c & M16) + (((x * (c >> 16)) & M16) << 16)) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bloom2_hashes(qhi: torch.Tensor, qlo: torch.Tensor):
    """The two level-2 32-bit mixes of the 64-bit key (bitmap.bloom2_hashes)."""
    h1 = _fmix32(qlo ^ _mul32(qhi, 0x9E3779B1) ^ 0x2545F491)
    h2 = _fmix32(qhi ^ _mul32(qlo, 0x85EBCA77) ^ 0x633D9ABD)
    return h1, h2


def bloom2_ext_hashes(qhi: torch.Tensor, qlo: torch.Tensor):
    """Index-extension mixes for blooms past 2^32 bits (bitmap.bloom2_ext_hashes)."""
    e1 = _fmix32(qhi ^ _mul32(qlo, 0xC2B2AE3D) ^ 0x27D4EB2F)
    e2 = _fmix32(qlo ^ _mul32(qhi, 0x165667B1) ^ 0x9E3779B9)
    return e1, e2


def _low_bits_index(h: torch.Tensor, ext: Optional[torch.Tensor], bits_log2: int):
    """(word, bit) of a probe: the low bits_log2 bits of ext:h."""
    if bits_log2 > 32:
        emask = (1 << (bits_log2 - 32)) - 1
        return (h >> 5) | ((ext & emask) << 27), h & 31
    idx = h & ((1 << bits_log2) - 1)
    return idx >> 5, idx & 31


def bitmap_bit_planes(qhi: torch.Tensor, qlo: torch.Tensor, bits_log2: int):
    """(word int64, bitval int64) for the direct-address bitmap."""
    word, bit = _low_bits_index(qlo, qhi, bits_log2)
    return word, torch.ones_like(bit) << bit


def bloom2_bit_planes(qhi: torch.Tensor, qlo: torch.Tensor, bits_log2: int):
    """(word int64, bitval int64), both probes concatenated."""
    h1, h2 = bloom2_hashes(qhi, qlo)
    e1, e2 = (bloom2_ext_hashes(qhi, qlo) if bits_log2 > 32 else (None, None))
    w1, b1 = _low_bits_index(h1, e1, bits_log2)
    w2, b2 = _low_bits_index(h2, e2, bits_log2)
    bit = torch.cat([b1, b2])
    return torch.cat([w1, w2]), torch.ones_like(bit) << bit


# ---------------------------------------------------------------------------
# K3: insert keys into both filters
# ---------------------------------------------------------------------------


def _or_into(words: torch.Tensor, word: torch.Tensor, bitval: torch.Tensor) -> None:
    """words[word] |= bitval, exact under duplicates (torch has no scatter-OR):
    distinct (word, bit) pairs summed per word equal their OR."""
    pairs = torch.unique((word << 32) | bitval)
    uw, inv = torch.unique(pairs >> 32, return_inverse=True)
    vals = torch.zeros(uw.shape, dtype=torch.int64, device=words.device)
    vals.scatter_add_(0, inv, pairs & M32)
    words[uw] = i32(u32(words[uw]) | vals)


def insert_keys_ref(words1, bits_log2, words2, b2bits, qhi, qlo, n_keep, degenerate=None,
                    adv_degenerate=None, bad=None) -> None:
    """Plain torch version of K3 (see insert_keys)."""
    hi, lo = u32(qhi[:n_keep]), u32(qlo[:n_keep])
    if words1 is not None:
        _or_into(words1, *bitmap_bit_planes(hi, lo, bits_log2))
    if words2 is not None:
        _or_into(words2, *bloom2_bit_planes(hi, lo, b2bits))
    if bad is not None:
        bad += degenerate[:n_keep].sum() + adv_degenerate.sum()


def insert_keys(words1: Optional[torch.Tensor], bits_log2: int,
                words2: Optional[torch.Tensor], b2bits: int, qhi: torch.Tensor,
                qlo: torch.Tensor, n_keep: int, degenerate: Optional[torch.Tensor] = None,
                adv_degenerate: Optional[torch.Tensor] = None,
                bad: Optional[torch.Tensor] = None) -> None:
    """OR the bitmap bit of each of the first n_keep keys into words1 and
    both its bloom2 bits into words2, IN PLACE; either filter may be None
    (not both). qhi/qlo: (n,) int32, 0 <= n_keep <= n. With `bad` (a ()
    int64 tensor): bad += the set flags of degenerate[:n_keep] ((n,) bool)
    and of adv_degenerate ((k,) bool), in the same launch."""
    n = qhi.shape[0] if qhi.dim() == 1 else -1
    filters = [(name, w, b) for name, w, b in (("words1", words1, bits_log2),
                                               ("words2", words2, b2bits)) if w is not None]
    if not filters:
        raise ValueError("insert_keys needs words1 or words2")
    for name, w, b in filters:
        if not 5 <= b <= MAX_BITS_LOG2:
            raise ValueError(f"{name}: bits out of range (5..{MAX_BITS_LOG2}): {b}")
        if (w.dtype != torch.int32 or not w.is_contiguous()
                or tuple(w.shape) != (1 << (b - 5),)):
            raise ValueError(f"{name}: need contiguous int32 ({1 << (b - 5)},)")
    checks = [("qhi", qhi, torch.int32, (n,)), ("qlo", qlo, torch.int32, (n,))]
    flags = (degenerate, adv_degenerate, bad)
    if any(t is not None for t in flags):
        if any(t is None for t in flags):
            raise ValueError("degenerate, adv_degenerate and bad go together")
        checks += [("degenerate", degenerate, torch.bool, (n,)),
                   ("adv_degenerate", adv_degenerate, torch.bool, (adv_degenerate.numel(),)),
                   ("bad", bad, torch.int64, ())]
    for name, t, dt, shape in checks:
        if t.dtype != dt or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need contiguous {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not 0 <= n_keep <= n:
        raise ValueError(f"n_keep must be in [0, {n}], got {n_keep}")
    tensors = [t for _, t, _, _ in checks] + [w for _, w, _ in filters]
    if not _build.on_cuda(*tensors):
        return insert_keys_ref(words1, bits_log2, words2, b2bits, qhi, qlo, n_keep,
                               degenerate, adv_degenerate, bad)
    n_adeg = 0 if bad is None else adv_degenerate.numel()
    if n_keep == 0 and n_adeg == 0:
        return
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch("kh_insert_keys", ptr(words1), ptr(words2), qhi.data_ptr(),
                  qlo.data_ptr(), n_keep, ptr(degenerate), ptr(adv_degenerate), n_adeg,
                  ptr(bad), bits_log2, b2bits, _build.stream(qhi))
    insert_keys.launches += 1


insert_keys.launches = 0


def _from_table(table: SortedXTable, words1, bits_log2: int, words2, b2bits: int) -> None:
    """K3 over the table's keys, TABLE_SLICE keys a launch (the slice's
    key words are the only transient)."""
    m = table.key.shape[0]
    for s in range(0, m, TABLE_SLICE):
        hi, lo = key_words(table.key[s: s + TABLE_SLICE])
        insert_keys(words1, bits_log2, words2, b2bits, hi, lo, hi.shape[0])


@spanned("table_build")
def build_bitmap_device(table: SortedXTable, bits_log2: Optional[int] = None) -> DeviceBitmap:
    """The bitmap over a baby table's keys, built where the table lives
    (bitmap.build_bitmap_device): K3's bitmap-only form, one launch a
    TABLE_SLICE keys. bits_log2 defaults to default_bits_log2(m)."""
    if bits_log2 is None:
        bits_log2 = default_bits_log2(table.key.shape[0])
    words = empty_filter(bits_log2, table.key.device)
    _from_table(table, words, bits_log2, None, 0)
    return DeviceBitmap(words, bits_log2)


def build_bloom2_device(table: SortedXTable, bits_log2: Optional[int] = None) -> DeviceBloom2:
    """The k=2 bloom over a baby table's keys, built where the table lives
    (bitmap.build_bloom2_device): K3's bloom-only form, one launch a
    TABLE_SLICE keys. bits_log2 defaults to bloom2_bits_log2(m)."""
    if bits_log2 is None:
        bits_log2 = bloom2_bits_log2(table.key.shape[0])
    words = empty_filter(bits_log2, table.key.device)
    _from_table(table, None, 0, words, bits_log2)
    return DeviceBloom2(words, bits_log2)


# ---------------------------------------------------------------------------
# Probes, compaction, cascade
# ---------------------------------------------------------------------------


def _test_bits(words: torch.Tensor, word: torch.Tensor, bitval: torch.Tensor):
    return (u32(words[word]) & bitval) != 0


def probe_ref(bm: DeviceBitmap, qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the bitmap probe (see probe)."""
    return _test_bits(bm.words, *bitmap_bit_planes(u32(qhi), u32(qlo), bm.bits_log2))


def probe_bloom2_ref(b2: DeviceBloom2, qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the bloom2 probe (see probe_bloom2)."""
    hit = _test_bits(b2.words, *bloom2_bit_planes(u32(qhi), u32(qlo), b2.bits_log2))
    return hit[: qhi.shape[0]] & hit[qhi.shape[0]:]


def _check_probe(filt, qhi: torch.Tensor, qlo: torch.Tensor) -> int:
    """The number of keys; raises on what the probe kernels do not take."""
    n = qhi.shape[0] if qhi.dim() == 1 else -1
    for name, t in (("qhi", qhi), ("qlo", qlo)):
        if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: need contiguous int32 ({n},) keys, got "
                             f"{t.dtype} {tuple(t.shape)}")
    check_filter(filt)
    return n


def check_filter(filt) -> None:
    """Raise on a filter (DeviceBitmap, DeviceBloom2) the kernels do not take."""
    w, bits = filt.words, filt.bits_log2
    if not 5 <= bits <= MAX_BITS_LOG2:
        raise ValueError(f"bits_log2 out of range (5..{MAX_BITS_LOG2}): {bits}")
    if w.dtype != torch.int32 or not w.is_contiguous() or tuple(w.shape) != (1 << (bits - 5),):
        raise ValueError(f"filter words: need contiguous int32 ({1 << (bits - 5)},)")


def _probe(filt, qhi: torch.Tensor, qlo: torch.Tensor, bloom2: bool, ref) -> torch.Tensor:
    n = _check_probe(filt, qhi, qlo)
    w = filt.words
    if not _build.on_cuda(w, qhi, qlo):
        return ref(filt, qhi, qlo)
    mask = torch.empty((n,), dtype=torch.bool, device=qhi.device)
    if n:
        _build.launch("kh_probe", w.data_ptr(), qhi.data_ptr(), qlo.data_ptr(),
                      mask.data_ptr(), n, filt.bits_log2, int(bloom2), _build.stream(qhi))
        (probe_bloom2 if bloom2 else probe).launches += 1
    return mask


def probe(bm: DeviceBitmap, qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """(B,) bool possibly-present mask — one word read per query. qhi/qlo:
    (B,) int32 key words."""
    return _probe(bm, qhi, qlo, False, probe_ref)


def probe_bloom2(b2: DeviceBloom2, qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """(B,) bool mask — 2 word reads per query; no false negatives."""
    return _probe(b2, qhi, qlo, True, probe_bloom2_ref)


probe.launches = 0
probe_bloom2.launches = 0


class ProbeCompact(NamedTuple):
    pos: torch.Tensor  # (C,) int32 ascending positions of the first C survivors, fill = B
    qhi: torch.Tensor  # (C,) int32 their key words (the last query's at fill)
    qlo: torch.Tensor
    n: torch.Tensor  # () int32: the true survivor count


def probe_compact_ref(bm: DeviceBitmap, qhi: torch.Tensor, qlo: torch.Tensor,
                      size: int) -> ProbeCompact:
    """Plain torch version of the fused probe (see probe_compact)."""
    return _compact_ref(probe_ref(bm, qhi, qlo), qhi, qlo, size)


def _compact_ref(hit: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                 size: int) -> ProbeCompact:
    """The level-1 compaction of the (B,) survivor mask `hit` of keys qhi,
    qlo: compact_positions, the gathers and the count."""
    b = qhi.shape[0]
    pos = compact_positions(hit, size, b)
    safe = pos.clamp(max=b - 1).long()
    return ProbeCompact(pos, qhi[safe], qlo[safe], hit.sum(dtype=torch.int32))


def probe_compact(bm: DeviceBitmap, qhi: torch.Tensor, qlo: torch.Tensor,
                  size: int) -> ProbeCompact:
    """The bitmap probe of the (B,) keys fused with the ordered compaction
    of its survivors: the first `size` positions in ascending order, padded
    with B, their keys (the last key at the padding) and the survivor count
    (compact_positions of the probe mask, then the gathers). One launch of
    the probe kernel (csrc/probe.cu kh_probe_compact), counted in
    probe.launches; B >= 1."""
    n = _check_probe(bm, qhi, qlo)
    if size < 0 or n < 1:
        raise ValueError(f"probe_compact needs B >= 1 keys and size >= 0 (B={n}, size={size})")
    if not _build.on_cuda(bm.words, qhi, qlo):
        return probe_compact_ref(bm, qhi, qlo, size)
    dev = qhi.device
    pos = torch.empty((size,), dtype=torch.int32, device=dev)
    ohi, olo = torch.empty_like(pos), torch.empty_like(pos)
    count = torch.empty((), dtype=torch.int32, device=dev)
    _launch_compact("kh_probe_compact", qhi, n, 0,
                    (bm.words.data_ptr(), qhi.data_ptr(), qlo.data_ptr(), pos.data_ptr(),
                     ohi.data_ptr(), olo.data_ptr(), count.data_ptr()),
                    (n, bm.bits_log2, size))
    probe.launches += 1
    return ProbeCompact(pos, ohi, olo, count)


def survivor_mask_ref(bm: DeviceBitmap, qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """The bitmap probe of (R, U) keys as K2's survivor mask: (R, ceil(U /
    32)) int32 words, bit b of word w of row r set where key (r, 32w + b)
    passes (ragged columns 0). Plain torch version of the probe inside K2
    (curve/pwalk.walk_blocks with a bitmap)."""
    R, U = qhi.shape
    W = -(-U // 32)
    hit = probe_ref(bm, qhi.reshape(-1), qlo.reshape(-1)).reshape(R, U).to(torch.int64)
    hit = torch.cat([hit, hit.new_zeros((R, 32 * W - U))], 1).reshape(R, W, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=hit.device)
    return i32((hit << shifts).sum(2))


def mask_compact_ref(mask: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                     size: int) -> ProbeCompact:
    """Plain torch version of mask_compact: the mask's bits in position
    order, then probe_compact_ref's compaction."""
    R, W = mask.shape
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    bits = ((u32(mask)[:, :, None] >> shifts) & 1).reshape(R, 32 * W)[:, : qhi.shape[0] // R]
    return _compact_ref(bits.reshape(-1).bool(), qhi, qlo, size)


def mask_compact(mask: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                 size: int) -> ProbeCompact:
    """The level-1 stage of a BSGS chunk whose keys K2 probed: mask (R,
    ceil(U / 32)) int32, K2's survivor mask of the (R*U,) keys qhi, qlo.
    Returns what probe_compact returns over the same keys against the
    bitmap that K2 read: the first `size` survivor positions in ascending
    order, padded with R*U, their keys (the last key at the padding) and
    the survivor count. One launch of csrc/probe.cu kh_mask_compact,
    counted in mask_compact.launches."""
    n = qhi.shape[0] if qhi.dim() == 1 else -1
    R, W = mask.shape if mask.dim() == 2 else (0, 0)
    U = n // R if R > 0 else 0
    for name, t, shape in (("qhi", qhi, (n,)), ("qlo", qlo, (n,)), ("mask", mask, (R, W))):
        if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need contiguous int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if R < 1 or U < 1 or R * U != n or W != -(-U // 32) or n >= 1 << 31 or size < 0:
        raise ValueError(f"mask_compact needs (R, ceil(U/32)) words of R*U < 2^31 keys and "
                         f"size >= 0 (mask {tuple(mask.shape)}, {n} keys, size={size})")
    if not _build.on_cuda(mask, qhi, qlo):
        return mask_compact_ref(mask, qhi, qlo, size)
    dev = qhi.device
    pos = torch.empty((size,), dtype=torch.int32, device=dev)
    ohi, olo = torch.empty_like(pos), torch.empty_like(pos)
    count = torch.empty((), dtype=torch.int32, device=dev)
    _launch_compact("kh_mask_compact", qhi, R * W, 2,
                    (mask.data_ptr(), qhi.data_ptr(), qlo.data_ptr(), pos.data_ptr(),
                     ohi.data_ptr(), olo.data_ptr(), count.data_ptr()), (R, U, size))
    mask_compact.launches += 1
    return ProbeCompact(pos, ohi, olo, count)


mask_compact.launches = 0


@lru_cache(maxsize=3)
def _probe_tile(form: int) -> int:
    """Keys a tile of kh_probe_compact (form 0) or kh_bloom2_compact (1), or
    mask words a tile of kh_mask_compact (2)."""
    return _build.kernels().kh_probe_tile(form)


# kh_probe_compact, kh_bloom2_compact and kh_mask_compact share a pair a
# stream; each zeroes all of the other buffer (its tickets and tile status
# words)
_COMPACT = _build.ScratchPairs(whole=True)


def _launch_compact(fn: str, t: torch.Tensor, n: int, form: int, head: tuple,
                    tail: tuple) -> None:
    """Launch compact kernel fn (kh_probe_compact, kh_bloom2_compact,
    kh_mask_compact: form 0, 1, 2) over n keys (mask words) on the current
    stream of t's device: its arguments head, the stream's scratches
    (_COMPACT), tail, the stream."""
    _COMPACT.launch(fn, t, 1 + -(-n // _probe_tile(form)), head, tail)


def compact_positions(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Ascending positions of set entries of the (B,) mask, the first `size`
    kept, padded with `fill` (bitmap.compact_positions_sort semantics), by a
    prefix sum instead of a B-wide sort: the j-th set entry is the first
    position where the inclusive count reaches j + 1 (one searchsorted of
    `size` queries). Exact at any density, so it also stands for the JAX
    package's compact_positions_dense, whose kmax = 8 lanes per 128-lane row
    drop the rest of a denser row."""
    B = mask.shape[0]
    csum = torch.cumsum(mask, 0, dtype=torch.int32)
    want = torch.arange(1, size + 1, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(csum, want, out_int32=True)
    return torch.where(pos < B, pos, fill)


def bloom2_compact_ref(b2: DeviceBloom2, stage1: ProbeCompact, total: int,
                      size: int) -> ProbeCompact:
    """Plain torch version of the bloom2 stage (see bloom2_compact): the
    probe, the pos1 < total mask, its count, compact_positions, the clamps
    and gathers, and the poison."""
    pos1, qh1, ql1, n1 = stage1
    C1 = pos1.shape[0]
    mask2 = probe_bloom2_ref(b2, qh1, ql1) & (pos1 < total)
    pos2 = compact_positions(mask2, size, C1)
    safe2 = pos2.clamp(max=C1 - 1).long()
    return ProbeCompact(torch.where(pos2 < C1, pos1[safe2], total), qh1[safe2], ql1[safe2],
                        torch.where(n1 > C1, n1 + size, mask2.sum(dtype=torch.int32)))


def bloom2_compact(b2: DeviceBloom2, stage1: ProbeCompact, total: int,
                   size: int) -> ProbeCompact:
    """The cascade's bloom2 stage: the bloom2 probe of the C1 stage-1
    survivors (a probe_compact of total queries: an entry is live where its
    position is below total) fused with the ordered compaction of its own
    survivors. Returns the first `size` of them in ascending order: their
    positions in the (total,) query space, padded with total, their keys
    (stage-1 entry C1 - 1's at the padding) and their count, poisoned to
    n1 + size where the stage-1 count n1 passed C1 (bitmap.filtered_lookup's
    stage 2). One launch of csrc/probe.cu kh_bloom2_compact, counted in
    bloom2_compact.launches; C1 >= 1."""
    pos1, qh1, ql1, n1 = stage1
    C1 = _check_probe(b2, qh1, ql1)
    for name, t, shape in (("stage-1 positions", pos1, (C1,)), ("stage-1 count", n1, ())):
        if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need contiguous int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if C1 < 1 or size < 0 or not 1 <= total < 1 << 31:
        raise ValueError(f"bloom2_compact needs C1 >= 1, size >= 0 and 1 <= total < 2^31 "
                         f"(C1={C1}, size={size}, total={total})")
    if not _build.on_cuda(b2.words, pos1, qh1, ql1, n1):
        return bloom2_compact_ref(b2, stage1, total, size)
    dev = qh1.device
    pos = torch.empty((size,), dtype=torch.int32, device=dev)
    ohi, olo = torch.empty_like(pos), torch.empty_like(pos)
    count = torch.empty((), dtype=torch.int32, device=dev)
    _launch_compact("kh_bloom2_compact", qh1, C1, 1,
                    (b2.words.data_ptr(), qh1.data_ptr(), ql1.data_ptr(), pos1.data_ptr(),
                     n1.data_ptr(), pos.data_ptr(), ohi.data_ptr(), olo.data_ptr(),
                     count.data_ptr()),
                    (C1, b2.bits_log2, size, total))
    bloom2_compact.launches += 1
    return ProbeCompact(pos, ohi, olo, count)


bloom2_compact.launches = 0


class FilteredLookup(NamedTuple):
    pos: torch.Tensor  # (C,) int32 flat query positions of survivors (B = none)
    result: LookupResult  # exact lookup over the C compacted survivors
    n_candidates: torch.Tensor  # () int32: the true survivor count (overflow check)


def filtered_lookup(bm: DeviceBitmap, table: SortedXTable, qhi: torch.Tensor,
                    qlo: torch.Tensor, cand_max: int, bm2: Optional[DeviceBloom2] = None,
                    stage1_max: Optional[int] = None) -> FilteredLookup:
    """Bitmap probe -> compact survivors -> exact search of the cand_max
    compacted keys (bitmap.filtered_lookup): filtered_survivors, then
    sorted_table.lookup of its keys. Survivors past cand_max are dropped:
    callers check n_candidates > cand_max and rescan exactly. With bm2 the
    cascade has two stages (see filtered_survivors); positions are in the
    original (B,) query space (B where none). No host sync. The BSGS chunk
    does not come here: its search runs in the summary kernel
    (engine/bsgs.py chunk_summary)."""
    fs = filtered_survivors(bm, qhi, qlo, cand_max, bm2, stage1_max)
    lr = lookup(table, fs.qhi, fs.qlo)
    valid = fs.pos < qhi.shape[0]
    return FilteredLookup(fs.pos, LookupResult(lr.found & valid, lr.idx, lr.found2 & valid,
                                               lr.idx2), fs.n_candidates)


class FilteredSurvivors(NamedTuple):
    pos: torch.Tensor  # (C,) int32 flat query positions, fill = B
    qhi: torch.Tensor  # (C,) int32 survivor key planes (garbage at fill)
    qlo: torch.Tensor
    n_candidates: torch.Tensor  # () int32, poisoned past cand_max on overflow


def filtered_survivors(bm: DeviceBitmap, qhi: torch.Tensor, qlo: torch.Tensor,
                       cand_max: int, bm2: Optional[DeviceBloom2] = None,
                       stage1_max: Optional[int] = None,
                       mask: Optional[torch.Tensor] = None) -> FilteredSurvivors:
    """Bitmap probe -> compact -> (bloom2 probe -> compact), no exact search
    (bitmap.filtered_survivors): probe_compact, then with bm2 its survivors
    compacted to stage1_max (default 4 * cand_max) and bloom2_compact of
    those to cand_max. With `mask`, the survivor mask of bm's probe of
    these keys that K2 wrote (curve/pwalk.walk_blocks with a bitmap), the
    level-1 stage is mask_compact of it, with the same output. Two
    launches on the card. Callers check n_candidates > cand_max and fall
    back to an exact rescan; a stage-1 overflow is poisoned to n +
    cand_max so the one check covers both stages."""

    def stage1(size: int) -> ProbeCompact:
        if mask is None:
            return probe_compact(bm, qhi, qlo, size)
        return mask_compact(mask, qhi, qlo, size)

    if bm2 is None:
        return FilteredSurvivors(*stage1(cand_max))
    C1 = stage1_max if stage1_max is not None else 4 * cand_max
    return FilteredSurvivors(*bloom2_compact(bm2, stage1(C1), qhi.shape[0], cand_max))
