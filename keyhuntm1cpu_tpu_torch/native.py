"""ctypes bindings for the native host library (native/keyhunt_host.cpp):
the port of keyhuntm1cpu_tpu/native.py.

sha256, hash160, exact k*G, the bulk base58check parse of address files
and batched exact hash160 verification, on the host. The library is the
one ``_build.host_lib()`` builds with g++ at first use (the baby-table
builder's); unlike the JAX module there is no pure-Python fallback: a
failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from . import _build


def load() -> ctypes.CDLL:
    """The native host library, built on first use (RuntimeError if the
    build fails)."""
    return _build.host_lib()


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def sha256(msg: bytes) -> bytes:
    buf = np.frombuffer(msg, dtype=np.uint8).copy()
    out = np.zeros(32, dtype=np.uint8)
    load().kh_sha256(_u8(buf), len(msg), _u8(out))
    return out.tobytes()


def hash160(msg: bytes) -> bytes:
    buf = np.frombuffer(msg, dtype=np.uint8).copy()
    out = np.zeros(20, dtype=np.uint8)
    load().kh_hash160(_u8(buf), len(msg), _u8(out))
    return out.tobytes()


def scalar_mult(k: int) -> Optional[Tuple[int, int]]:
    """k*G (k < 2^256) as python ints, or None for the point at infinity."""
    kb = np.frombuffer(k.to_bytes(32, "big"), dtype=np.uint8).copy()
    x = np.zeros(32, dtype=np.uint8)
    y = np.zeros(32, dtype=np.uint8)
    if load().kh_scalar_mult(_u8(kb), _u8(x), _u8(y)) != 0:
        return None
    return int.from_bytes(x.tobytes(), "big"), int.from_bytes(y.tobytes(), "big")


def parse_addresses(text: bytes, max_count: int) -> np.ndarray:
    """Bulk base58check -> (N, 20) uint8 hash160s, one row per non-empty
    line (its first token), at most max_count; zeros for a bad line."""
    out = np.zeros((max_count, 20), dtype=np.uint8)
    n = load().kh_parse_addresses(text, len(text), _u8(out), max_count)
    return out[:n]


def verify_h160(keys: List[int], target: bytes, compressed: bool = True) -> List[bool]:
    """Batch exact verification: hash160(pubkey(k)) == target?"""
    kb = np.zeros((len(keys), 32), dtype=np.uint8)
    for i, k in enumerate(keys):
        kb[i] = np.frombuffer((k % (1 << 256)).to_bytes(32, "big"), dtype=np.uint8)
    tgt = np.frombuffer(target, dtype=np.uint8).copy()
    res = np.zeros(len(keys), dtype=np.uint8)
    load().kh_verify_h160(_u8(kb), len(keys), 0 if compressed else 1, _u8(tgt), _u8(res))
    return [bool(v) for v in res]
