"""K4's (kh_brute_walk_blocks) share of its least-work bound: the frozen
model's least time for the chunk's K steps of U keys in the cell's mode,
interval compares and lane rows at the card's clocks.max.sm, over K4's
event-timed card time a chunk."""

from khbench import roofline


def read(r):
    tr, sh = r["trace"], r["shape"]
    ms = tr and tr["kernel_ms"].get("kh_brute_walk_blocks")
    if not ms or not r.get("clock_mhz"):
        return None
    ops, nbytes = roofline.k4_ops_bytes(sh["mode"], sh["n_endo"], sh["T"], sh["TB"],
                                        sh["K"], sh["U"])
    bound, _ = roofline.bound_ms(ops, nbytes, r["clock_mhz"])
    return 100.0 * bound / (ms / tr["n_sampled"])
