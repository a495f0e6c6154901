"""Card milliseconds of one BSGS chunk's launches (K1, K2, the level-1
probe, the bloom2 stage, the summary), each timed by a pair of CUDA events
around its launch, in the chunks that carry kernel events."""

BSGS_KERNELS = ("kh_walk_blocks", "kh_bsgs_summary")


def read(r):
    tr = r["trace"]
    if not tr or not tr["n_sampled"] or not all(k in tr["kernel_ms"] for k in BSGS_KERNELS):
        return None
    return sum(tr["kernel_ms"].values()) / tr["n_sampled"]
