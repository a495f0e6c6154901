"""The card's busy seconds in a window, from the profiler's trace.

Where a cell's end-to-end metrics read the device trace (``source``
"device_trace"), an untraced run (``--trace 0``) starts ``torch.profiler``
with CUDA activity alone before its window and stops it after the window:
CUPTI records every kernel and copy each card ran, whatever launched it,
with the card's own start and end. A card's busy seconds are the union of
those intervals. The host's clock plays no part in them, so a host that
changes speed from run to run moves them little, where it moves the
window's wall time as much as it paces the card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple


def union_s(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by (start_ns, end_ns) intervals, overlaps counted once."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def device_intervals(prof) -> Dict[int, List[Tuple[int, int]]]:
    """(start_ns, end_ns) of every device operation in a profile, by card."""
    out: Dict[int, List[Tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            out.setdefault(e.device_index(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


class CardClock:
    """The profiler around one window (inert when off or off the card)."""

    def __init__(self, on: bool, devices: List):
        self.on = on and all(d.type == "cuda" for d in devices)
        self.n_cards = len(dict.fromkeys(devices))
        self._prof = None
        self.readings: Dict[str, float] = {}

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.readings["card_clock_start_s"] = time.perf_counter() - t

    def stop(self) -> None:
        if self._prof is not None:
            t = time.perf_counter()
            self._prof.stop()
            self.readings["card_clock_stop_s"] = time.perf_counter() - t

    def busy_s(self) -> Optional[float]:
        """Mean busy seconds of the cards the window used; None where the
        clock was off or saw no device operation on some card."""
        if self._prof is None:
            return None
        t = time.perf_counter()
        iv = device_intervals(self._prof)
        self.readings["card_clock_reduce_s"] = time.perf_counter() - t
        self.readings["card_ops"] = sum(len(v) for v in iv.values())
        if len(iv) < self.n_cards:
            return None
        return sum(union_s(v) for v in iv.values()) / len(iv)
