"""Keys of the range covered a second of the card's busy time: every chunk
decoded in the window, times the mode's multiplier, over the seconds in
which a kernel or a copy of the window ran on the card, by the profiler's
trace (khbench/card_clock.py). The rate the search reaches where the host
keeps the card fed; where it does, the same as keys_per_s within the
card's idle share."""


def read(r):
    busy = r.get("card_busy_s")
    if not busy or r["n_devices"] != 1:
        return None
    return r["keys"] / busy
