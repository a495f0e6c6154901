"""Keys of the range covered a second by every card of a sharded run
together, as keys_per_s counts them."""


def read(r):
    if r["n_devices"] < 2 or r["wall_s"] <= 0:
        return None
    return r["keys"] / r["wall_s"]
