"""K2's (kh_walk_blocks) share of its least-work bound: the frozen model's
least time for the chunk's T*K rows of U points at the card's
clocks.max.sm, over K2's event-timed card time a chunk."""

from khbench import roofline


def read(r):
    tr, sh = r["trace"], r["shape"]
    ms = tr and tr["kernel_ms"].get("kh_walk_blocks")
    if not ms or not r.get("clock_mhz"):
        return None
    bound, _ = roofline.bound_ms(*roofline.k2_ops_bytes(sh["T"] * sh["K"], sh["U"]),
                                 r["clock_mhz"])
    return 100.0 * bound / (ms / tr["n_sampled"])
