"""The card clock's arithmetic and its reader, on the CPU (the profiler's
CUDA trace itself runs only on the card)."""

import pytest

from khbench import card_clock
from khbench.metrics import card_keys_per_s


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10e-9),
    ([(0, 10), (20, 25)], 15e-9),
    ([(0, 10), (5, 15)], 15e-9),  # overlapping: counted once
    ([(20, 25), (0, 30)], 30e-9),  # one inside another, out of order
    ([(0, 10), (10, 20)], 20e-9),  # touching
])
def test_union_counts_overlaps_once(intervals, want):
    assert card_clock.union_s(intervals) == pytest.approx(want)


def test_clock_is_inert_off_the_card():
    import torch

    c = card_clock.CardClock(True, [torch.device("cpu")])
    c.start()
    c.stop()
    assert not c.on and c.busy_s() is None and c.readings == {}


def test_reader_divides_keys_by_busy_seconds():
    r = dict(keys=3 * 2**50, wall_s=2.0, n_devices=1, card_busy_s=1.5)
    assert card_keys_per_s.read(r) == pytest.approx(2**51)
    assert card_keys_per_s.read(dict(r, card_busy_s=None)) is None
    assert card_keys_per_s.read(dict(r, card_busy_s=0.0)) is None
    assert card_keys_per_s.read(dict(r, n_devices=4)) is None
