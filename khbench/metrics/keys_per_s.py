"""Keys of the range covered a second on one card: every chunk decoded in
the window, over the window's whole wall time (the search call until it
returned, drain included), times the mode's multiplier."""


def read(r):
    if r["n_devices"] != 1 or r["wall_s"] <= 0:
        return None
    return r["keys"] / r["wall_s"]
