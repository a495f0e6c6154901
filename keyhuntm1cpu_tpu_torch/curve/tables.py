"""Host-side exact point tables (numpy copy of keyhuntm1cpu_tpu/curve/tables.py).

Built once with exact python-int arithmetic (ref/ecref.py) and uploaded
to the device as u32 limbs.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from ..field.fe import LIMBS, int_to_limbs
from ..ref import ecref


@lru_cache(maxsize=32)
def _step_table_np(px: int, py: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    xs = np.empty((count, LIMBS), dtype=np.uint32)
    ys = np.empty((count, LIMBS), dtype=np.uint32)
    cur = (px, py)
    for i in range(count):
        xs[i] = int_to_limbs(cur[0])
        ys[i] = int_to_limbs(cur[1])
        cur = ecref.point_add(cur, (px, py))
        if cur is None and i != count - 1:
            raise ValueError("step table hit infinity — count exceeds point order")
    return xs, ys


def step_table(point: Tuple[int, int], count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) numpy (count, 8) uint32 limb tables of i*point, i = 1..count."""
    return _step_table_np(point[0], point[1], count)


@lru_cache(maxsize=32)
def _pair_table_np(px: int, py: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    xs = np.empty((count, LIMBS), dtype=np.uint32)
    ys = np.empty((count, LIMBS), dtype=np.uint32)
    cur = ecref.scalar_mult((ecref.N + 1) // 2, (px, py))  # point / 2
    for d in range(count):
        xs[d] = int_to_limbs(cur[0])
        ys[d] = int_to_limbs(cur[1])
        cur = ecref.point_add(cur, (px, py))
    return xs, ys


def pair_table(point: Tuple[int, int], count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) numpy (count, 8) uint32 limb tables of (d + 1/2)*point, d =
    0..count-1 (1/2 the inverse of 2 mod the group order): the paired walk's
    offsets from its half-step centres (curve/pwalk.pair_tables). Against
    step_table(point, 2*count), entry d is half the difference of columns
    count + d and count - 1 - d."""
    return _pair_table_np(point[0], point[1], count)


@lru_cache(maxsize=1)
def gtable_np() -> Tuple[np.ndarray, np.ndarray]:
    """Windowed generator table of the scalar-mult ladder (curve/pladder.py):
    [w, b] = (b * 2^(8w)) * G for b = 1..255; the b == 0 entries are
    zero-filled (the ladder treats a zero byte as infinity and never reads
    them). Shape (32, 256, 8) uint32, x and y."""
    xs = np.zeros((32, 256, LIMBS), dtype=np.uint32)
    ys = np.zeros((32, 256, LIMBS), dtype=np.uint32)
    base = ecref.G
    for w in range(32):
        cur = base
        for b in range(1, 256):
            xs[w, b] = int_to_limbs(cur[0])
            ys[w, b] = int_to_limbs(cur[1])
            cur = ecref.point_add(cur, base)
        base = cur  # 256 * the window's base: the next window's base
    return xs, ys
