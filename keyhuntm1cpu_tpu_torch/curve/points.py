"""Batched affine points: the part of keyhuntm1cpu_tpu/curve/points.py the
walker brute path needs (``PointBatch``, ``point_batch_from_ints``).

The port keeps its limb-major layout: ``x`` and ``y`` are (8, n) int32
tensors holding u32 limbs (the JAX package's are (n, 8) uint32); ``inf``
is (n,) bool.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import fe


class PointBatch(NamedTuple):
    x: torch.Tensor  # (8, n) int32 limbs
    y: torch.Tensor  # (8, n) int32 limbs
    inf: torch.Tensor  # (n,) bool


def point_batch_from_ints(pts: Sequence[Optional[Tuple[int, int]]],
                          device="cpu") -> PointBatch:
    """Host: affine python-int points (None = infinity, stored as 0, 0) ->
    a PointBatch on `device`."""
    xs = np.stack([fe.int_to_limbs(0 if p is None else p[0]) for p in pts], axis=1)
    ys = np.stack([fe.int_to_limbs(0 if p is None else p[1]) for p in pts], axis=1)
    inf = np.array([p is None for p in pts], dtype=bool)
    return PointBatch(torch.from_numpy(xs.view(np.int32)).to(device),
                      torch.from_numpy(ys.view(np.int32)).to(device),
                      torch.from_numpy(inf).to(device))
