"""Card milliseconds of one fused brute chunk's launches (K1, K4, the
compaction), each timed by a pair of CUDA events around its launch, in
the chunks that carry kernel events."""


def read(r):
    tr = r["trace"]
    if not tr or not tr["n_sampled"] or "kh_brute_walk_blocks" not in tr["kernel_ms"]:
        return None
    return sum(tr["kernel_ms"].values()) / tr["n_sampled"]
