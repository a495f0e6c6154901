"""Minikey validity (K5) and key derivation: base58 suffixes and SHA-256.

Port of keyhuntm1cpu_tpu/hash/pminikey.py and of the compaction and
key-derivation glue of keyhuntm1cpu_tpu/engine/minikeys.py
(``_minikey_finish_impl``, lines 458-479). A minikey is 'S' + 16 prefix
characters + 5 device digits; lane i of a chunk is the counter v =
base_lo + i (v < 58^5 < 2^31), whose 5 base-58 digits, mapped through the
alphabet, fill message bytes 17..21.

- **K5** ``minikey_valid``: (B,) bool mask, sha256(minikey + '?')[0] == 0.
- ``compact_keys``: the exact count of valid lanes, the first V of them in
  ascending order and their private keys sha256(minikey) as (8, V)
  little-endian scalar limbs (limb j = digest word 7 - j), in one launch.

Each wrapper runs its plain torch version for CPU tensors and launches its
kernel (csrc/minikey.cu) for CUDA tensors; launches are counted in
``<wrapper>.launches``. The message bases ``w23_base`` / ``w22_base`` are
(16,) int32 tensors of padded SHA-256 block words with the digit bytes
zeroed (engine/minikeys._pack_block_words); the alphabet goes to the kernel
by value, as its runs. The JAX package divides by 58 with a 16-bit-partial
magic multiply because Mosaic has no 32x32->64 multiply; here the plain
version divides exactly and the kernel lets nvcc turn ``v / 58u`` into a
multiply-high.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..field import fe
from ..filter.bitmap import compact_positions
from .phash import M32, _sha256_compress_unrolled

DEVICE_DIGITS = 5


@lru_cache(maxsize=16)
def b58_runs(alphabet: str) -> Tuple[Tuple[int, int, int], ...]:
    """Decompose an alphabet into maximal consecutive-ASCII runs
    (start_digit, end_digit, uint32 wrap-add offset)."""
    vals = [ord(c) for c in alphabet]
    runs = []
    i = 0
    while i < 58:
        j = i
        while j + 1 < 58 and vals[j + 1] == vals[j] + 1:
            j += 1
        runs.append((i, j, (vals[i] - i) & 0xFFFFFFFF))
        i = j + 1
    return tuple(runs)


@lru_cache(maxsize=16)
def _runs_array(alphabet: str) -> np.ndarray:
    """The runs as the kernels take them: (3, R) int32 rows lo, hi, offset."""
    return np.ascontiguousarray(np.array(b58_runs(alphabet), dtype=np.uint32).T.view(np.int32))


def _char_from_digit(d: torch.Tensor, runs) -> torch.Tensor:
    c = torch.zeros_like(d)
    for i, j, off in runs:
        hit = (d <= j) if i == 0 else ((d >= i) & (d <= j))
        c = torch.where(hit, (d + off) & M32, c)
    return c


def suffix_digits(v: torch.Tensor, n: int) -> List[torch.Tensor]:
    """n base-58 digits of v (int64, >= 0), most-significant first."""
    digits = []
    x = v
    for _ in range(n):
        digits.append(x % 58)
        x = x // 58
    digits.reverse()
    return digits


def suffix_or_words(v: torch.Tensor, runs) -> Tuple[torch.Tensor, torch.Tensor]:
    """OR-masks for message words 4 and 5 (bytes 17..21) of counters v."""
    ch = [_char_from_digit(d, runs) for d in suffix_digits(v, DEVICE_DIGITS)]
    return (ch[0] << 16) | (ch[1] << 8) | ch[2], (ch[3] << 24) | (ch[4] << 16)


def _block_words(base: Sequence, v: torch.Tensor, runs) -> List[torch.Tensor]:
    w4or, w5or = suffix_or_words(v, runs)
    zero = torch.zeros_like(v)
    w = [zero + int(base[i]) for i in range(16)]
    w[4] = w[4] | w4or
    w[5] = w[5] | w5or
    return w


def minikey_valid_tile(v: torch.Tensor, w23: Sequence, runs) -> torch.Tensor:
    """Validity of counters v (int64 tensor, any shape) under the 16 base
    words w23 (ints): sha256(block)[0] >> 24 == 0, as a bool tensor."""
    h0 = _sha256_compress_unrolled(_block_words(w23, v, runs))[0]
    return (h0 >> 24) == 0


def _check_base(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != (16,):
        raise ValueError(f"{name}: need a contiguous int32 (16,) tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_alphabet(alphabet: str) -> None:
    if len(alphabet) != 58 or len(set(alphabet)) != 58:
        raise ValueError("alphabet must be 58 distinct characters")


# ---------------------------------------------------------------------------
# K5: validity
# ---------------------------------------------------------------------------


def minikey_valid_ref(base_lo: int, w23_base: torch.Tensor, B: int,
                      alphabet: str) -> torch.Tensor:
    """Plain torch version of K5 (see minikey_valid)."""
    v = (base_lo + torch.arange(B, dtype=torch.int64, device=w23_base.device)) & M32
    return minikey_valid_tile(v, fe.u32(w23_base).tolist(), b58_runs(alphabet))


def minikey_valid(base_lo: int, w23_base: torch.Tensor, B: int,
                  alphabet: str) -> torch.Tensor:
    """(B,) bool validity mask of the minikeys of counters [base_lo,
    base_lo + B) on w23_base's device; w23_base: (16,) int32 block words of
    the 23-byte message 'S' + 16 prefix chars + 5 zero bytes + '?'."""
    _check_base("w23_base", w23_base)
    _check_alphabet(alphabet)
    if B < 1:
        raise ValueError(f"minikey_valid needs B >= 1, got {B}")
    if not _build.on_cuda(w23_base):
        return minikey_valid_ref(base_lo, w23_base, B, alphabet)
    mask = torch.empty(B, dtype=torch.bool, device=w23_base.device)
    runs = _runs_array(alphabet)
    _build.launch("kh_minikey_valid", w23_base.data_ptr(), mask.data_ptr(), base_lo & M32, B,
                  runs.ctypes.data, runs.shape[1], _build.stream(w23_base))
    minikey_valid.launches += 1
    return mask


minikey_valid.launches = 0


# ---------------------------------------------------------------------------
# Compaction of the valid lanes and key derivation
# ---------------------------------------------------------------------------


def compact_keys_ref(valid: torch.Tensor, V: int, base_lo: int, w22_base: torch.Tensor,
                     B: int, alphabet: str):
    """Plain torch version of compact_keys: the count, compact_positions
    and the key derivation of the compacted lanes."""
    n_valid = valid.sum(dtype=torch.int32)
    vidx = compact_positions(valid, V, B)
    v = (base_lo + vidx.to(torch.int64).clamp(max=B - 1)) & M32
    kw = _sha256_compress_unrolled(_block_words(fe.u32(w22_base).tolist(), v,
                                                b58_runs(alphabet)))
    return n_valid, vidx, fe.i32(torch.stack([kw[7 - i] for i in range(8)]))


def compact_keys(valid: torch.Tensor, V: int, base_lo: int, w22_base: torch.Tensor, B: int,
                 alphabet: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n_valid, vidx, k) of K5's (B,) bool mask `valid` of the counters
    [base_lo, base_lo + B): the exact number of valid lanes (() int32), the
    first V valid lanes in ascending order ((V,) int32, fill B) and their
    private keys sha256(minikey) as (8, V) int32 little-endian scalar limbs
    (limb j = digest word 7 - j; a fill slot hashes lane B - 1). w22_base:
    (16,) int32 block words of the 22-byte message. One launch of
    csrc/minikey.cu kh_minikey_compact_keys (with its scratch's memset)."""
    _check_base("w22_base", w22_base)
    _check_alphabet(alphabet)
    if not 1 <= B < 1 << 31 or V < 1:
        raise ValueError(f"compact_keys needs 1 <= B < 2^31 and V >= 1, got B={B}, V={V}")
    if valid.dtype != torch.bool or not valid.is_contiguous() or tuple(valid.shape) != (B,):
        raise ValueError(f"valid: need a contiguous bool ({B},) tensor, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if not _build.on_cuda(valid, w22_base):
        return compact_keys_ref(valid, V, base_lo, w22_base, B, alphabet)
    dev = valid.device
    n_valid = torch.empty((), dtype=torch.int32, device=dev)
    vidx = torch.empty((V,), dtype=torch.int32, device=dev)
    k = torch.empty((8, V), dtype=torch.int32, device=dev)
    scratch = torch.empty((1 + -(-B // _tile()),), dtype=torch.int64, device=dev)
    runs = _runs_array(alphabet)
    _build.launch("kh_minikey_compact_keys", valid.data_ptr(), w22_base.data_ptr(),
                  n_valid.data_ptr(), vidx.data_ptr(), k.data_ptr(), scratch.data_ptr(),
                  base_lo & M32, B, V, runs.ctypes.data, runs.shape[1], _build.stream(valid))
    compact_keys.launches += 1
    return n_valid, vidx, k


compact_keys.launches = 0


@lru_cache(maxsize=1)
def _tile() -> int:
    """Lanes per tile of kh_minikey_compact_keys (its scratch holds one word a tile)."""
    return _build.kernels().kh_minikey_tile()
