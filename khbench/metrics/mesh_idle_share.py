"""Percent of each card's time idle in a sharded window, from a pair of
CUDA events around that card's chunk in every sharded chunk: the mean of
the cards' shares."""


def read(r):
    tr = r["trace"]
    if not tr or r["n_devices"] < 2 or len(tr["cards"]) < 2:
        return None
    return 100.0 * sum(c["idle"] for c in tr["cards"].values()) / len(tr["cards"])
