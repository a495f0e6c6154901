"""Deterministic range partitioning across devices and processes.

Copy of keyhuntm1cpu_tpu/parallel/partition.py (the port imports nothing
of the JAX package): a static disjoint assignment of window-aligned
slices replaces the reference's mutex range claiming
(keyhunt.cpp:3824-3841). Slices are aligned to whole giant-step windows,
so every shard's step indexing stays integral.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class RangeSlice:
    start: int  # first key of the slice
    end: int  # one past the last key
    step0: int  # global step index of the slice's first device step

    @property
    def n_keys(self) -> int:
        return self.end - self.start


class RangePartitioner:
    @staticmethod
    def split_equal(
        start: int, end: int, n_shards: int, window: int
    ) -> List[RangeSlice]:
        """Split [start, end) into n_shards contiguous window-aligned slices.

        window = keys covered by one device step (U * stride for BSGS).
        The last slice absorbs the remainder (and may overshoot `end` by
        less than one window, matching the engines' overshoot semantics).
        """
        total_windows = max(1, math.ceil((end - start) / window))
        per = math.ceil(total_windows / n_shards)
        out = []
        for s in range(n_shards):
            w0 = min(s * per, total_windows)
            w1 = min((s + 1) * per, total_windows)
            if w0 == w1:
                # degenerate shard (more shards than windows): give it a
                # repeat of the last window; hits dedupe at verification
                w0 = max(0, total_windows - 1)
                w1 = total_windows
            out.append(
                RangeSlice(
                    start=start + w0 * window,
                    end=min(start + w1 * window, end) if w1 < total_windows else end,
                    step0=w0,
                )
            )
        return out

    @staticmethod
    def split_by_weight(
        start: int, end: int, weights: List[float], window: int
    ) -> List[RangeSlice]:
        """Weighted split (heterogeneous shards), window-aligned."""
        total_windows = max(1, math.ceil((end - start) / window))
        wsum = sum(weights)
        bounds = [0]
        acc = 0.0
        for w in weights[:-1]:
            acc += w
            bounds.append(round(total_windows * acc / wsum))
        bounds.append(total_windows)
        out = []
        for s in range(len(weights)):
            w0, w1 = bounds[s], max(bounds[s + 1], bounds[s] + 1)
            w1 = min(w1, total_windows)
            w0 = min(w0, w1 - 1) if w1 > 0 else 0
            out.append(
                RangeSlice(
                    start=start + w0 * window,
                    end=min(start + w1 * window, end) if w1 < total_windows else end,
                    step0=w0,
                )
            )
        return out
