"""Percent of the card's time idle between the window's first chunk start
and last chunk end, from a pair of CUDA events around each chunk (busy is
the sum of the pairs' intervals)."""


def read(r):
    tr = r["trace"]
    if not tr or r["n_devices"] != 1 or not tr["cards"]:
        return None
    (card,) = tr["cards"].values()
    return 100.0 * card["idle"]
