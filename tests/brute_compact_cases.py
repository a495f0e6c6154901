"""Hit words for the fused brute chunk's compaction and summary
(keyhuntm1cpu_tpu_torch/curve/pbrute.py compact_hits), made from a seed
with numpy, for tests/test_torch_pbrute.py (the plain version against the
JAX compaction) and tests/test_torch_kernels_cuda.py (the kernel against
its plain version). Imports neither JAX nor torch.

A case is K steps of U hit words (U % 128 == 0: rows of 128 words, U/128
rows a step) and C candidate slots, so R = max(8, C // 32) rows are
picked. Query bits are bits 0..29 of a word, bit 30 the degenerate flag.
The cases:

- none: no word set;
- rows_r: exactly R flagged rows, two words each;
- rows_r1: R + 1 flagged rows (the row overflow: n = C + 1);
- over_c: R flagged rows holding more than C non-zero words;
- dense: one row with every word set, and two sparse rows after it;
- degenerate: degenerate words in step 0 (twice), in the last step's
  last word and in a middle step, some of them beside query bits;
- bit30: a row whose only set bits are degenerate flags (not flagged),
  and one query word in another row;
- adeg: advance flags at three steps, a few hits;
- mixed: ~1 % of the words random 31-bit values (query bits and the flag
  together, in any combination).
"""

import numpy as np

CASES = ("none", "rows_r", "rows_r1", "over_c", "dense", "degenerate", "bit30", "adeg",
         "mixed")
DEG = 1 << 30
LANES = 128


def make_case(name, K, U, C, seed=0):
    """(hits (K, U) uint32, adeg (K,) bool) of case `name`."""
    rng = np.random.default_rng(seed)
    hits = np.zeros((K, U), np.uint32)
    rows = hits.reshape(-1, LANES)
    nr = rows.shape[0]
    R = max(8, C // 32)
    adeg = np.zeros(K, bool)

    def plant(n_rows, per_row):
        for r in np.sort(rng.choice(nr, n_rows, replace=False)):
            lanes = rng.choice(LANES, per_row, replace=False)
            rows[r, lanes] = rng.integers(1, 1 << 9, per_row)

    if name == "rows_r":
        plant(R, 2)
    elif name == "rows_r1":
        plant(R + 1, 2)
    elif name == "over_c":
        plant(R, min(LANES, C // R + 3))
    elif name == "dense":
        r = int(rng.integers(0, nr - 2))
        rows[r] = rng.integers(1, 1 << 30, LANES)
        rows[r + 1, 5] = 3
        rows[nr - 1, LANES - 1] = 1
    elif name == "degenerate":
        hits[0, 0] = DEG
        hits[0, U // 2 + 3] = DEG
        hits[K - 1, U - 1] = DEG
        hits[K // 2, 7] = DEG | 5
        hits[K // 2, U - 2] = 9
        plant(3, 1)
    elif name == "bit30":
        r = int(rng.integers(1, nr))
        rows[r, rng.choice(LANES, 3, replace=False)] = DEG
        rows[r - 1, 17] = 6
    elif name == "adeg":
        adeg[rng.choice(K, 3, replace=False)] = True
        plant(2, 1)
    elif name == "mixed":
        live = rng.random((K, U)) < 0.01
        hits[live] = rng.integers(1, 1 << 31, int(live.sum()))
    elif name != "none":
        raise ValueError(name)
    return hits, adeg
