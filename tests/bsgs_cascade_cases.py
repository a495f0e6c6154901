"""Inputs of the BSGS chunk's cascade after the level-1 probe
(keyhuntm1cpu_tpu_torch/filter/bitmap.py bloom2_compact, the bloom2
stage, and engine/bsgs.py chunk_summary / chunk_summary_host, the
summary), made from a seed with numpy, for tests/test_torch_bsgs_cascade.py
(small shapes, against the JAX package) and tests/test_torch_kernels_cuda.py
(the main path's shape, each kernel against its plain version). Imports
neither JAX nor torch.

The bloom2 stage takes a level-1 output (``stage1``): C1 entries, the
first min(n1, C1) at ascending positions below B, then padding (position
B, one fill key, as the level-1 probe pads with its last query's key).
STAGE_CASES name its n1:

- half: n1 = C1 / 2 (stage-1 padding: the stage-2 padding's key is the
  fill key);
- full: n1 = C1 (no stage-1 padding: the stage-2 padding's key is stage-1
  entry C1 - 1's, a real survivor's);
- none: n1 = 0 (every entry padding: no survivors at all);
- over: n1 = C1 + 17 (a stage-1 overflow: the count is poisoned).

TILE_EDGES name the kernel's tiles (TILE2 = 256 entries a tile of the
bloom2 stage, csrc/probe.cu kStage2Q * kProbeThreads) as (C1, n1): one
entry below, at and one above a two-tile boundary with a full stage 1,
and a single tile with stage-1 padding.

The summary takes C survivors (``survivors``) in B = R*U queries, the
(R, U) degenerate flags without the lane U - 1 fix-up and the (R,)
advance flags (``flags``), and a sorted table holding some survivors' keys
(``table_keys``; one key twice: found2). SUMMARY_CASES:

- mixed: rows of different first degenerate lanes (row r % 4 == 1 from
  lane 37r mod (U - 1) on, r % 4 == 2 advance and lane U - 1 both,
  r % 4 == 3 the advance flag alone, r % 4 == 0 none), survivors planted on
  flagged lanes, on lane U - 1 of the advance rows and on live lanes;
- adv_only: the advance flags alone set degenerate lanes (every third
  row), survivors on their lane U - 1;
- none: no survivors (count 0, every entry padding);
- over: C survivors and a count past C.

SUMMARY_SHAPES are the row role's edges as (R, U, C) with the layout
the kernel takes (csrc/lookup.cu: a group of 32 to 256 threads a row,
four loads a thread, 16 bytes each when U % 16 == 0 and the rows are
16-byte aligned): rows_ragged, 12 rows of U = 64 (a warp a row, 8 rows a
block: R not a multiple of them); u_odd, U = 1,000 (a byte a load);
u_one, U = 1 (every lane is lane U - 1); unaligned, 6 rows of U = 4,096
(64 threads a row, 4 rows a block) that the card tests read from a view
one byte past an aligned start (a byte a load).
"""

import numpy as np

STAGE_CASES = ["half", "full", "none", "over"]
SUMMARY_CASES = ["mixed", "adv_only", "none", "over"]
TILE2 = 256
TILE_EDGES = {"below": (2 * TILE2 - 1, 2 * TILE2 - 1), "at": (2 * TILE2, 2 * TILE2),
              "above": (2 * TILE2 + 1, 2 * TILE2 + 1), "single": (200, 150)}
SUMMARY_SHAPES = {"rows_ragged": (12, 64, 64), "u_odd": (5, 1000, 64), "u_one": (40, 1, 16),
                  "unaligned": (6, 4096, 64)}


def u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def stage1(case, C1, B, seed=0):
    """(pos1 (C1,) int32, qh1, ql1 (C1,) uint32, n1 int): a level-1 output
    over B queries (B >= C1)."""
    rng = np.random.default_rng(seed + STAGE_CASES.index(case))
    n1 = {"half": C1 // 2, "full": C1, "none": 0, "over": C1 + 17}[case]
    return _stage1(rng, n1, C1, B)


def edge_stage1(edge, B, seed=0):
    """stage1 at TILE_EDGES[edge]'s C1 and n1."""
    C1, n1 = TILE_EDGES[edge]
    return _stage1(np.random.default_rng(seed + 50 + list(TILE_EDGES).index(edge)), n1, C1, B)


def _stage1(rng, n1, C1, B):
    k = min(n1, C1)
    pos1 = np.full(C1, B, np.int32)
    pos1[:k] = np.sort(rng.choice(B, k, replace=False))
    qh1, ql1 = u32(rng, C1), u32(rng, C1)
    qh1[k:], ql1[k:] = qh1[-1], ql1[-1]
    return pos1, qh1, ql1, n1


def flags(case, R, U, seed=0):
    """(deg (R, U) bool, without the lane U - 1 fix-up; adv (R,) bool)."""
    rng = np.random.default_rng(seed + SUMMARY_CASES.index(case))
    deg = np.zeros((R, U), bool)
    adv = np.zeros(R, bool)
    if case == "adv_only":
        adv[::3] = True
        return deg, adv
    for r in range(R):
        if r % 4 == 1:
            first = 37 * r % max(U - 1, 1)
            deg[r, first] = True
            deg[r, first:] |= rng.random(U - first) < 0.01
        elif r % 4 == 2:
            adv[r] = deg[r, U - 1] = True
        elif r % 4 == 3:
            adv[r] = True
    return deg, adv


def table_keys(m, seed=0):
    """(m,) uint64 keys, unsorted, the last two equal (a duplicated
    truncated key), and the payloads j = 1..m."""
    rng = np.random.default_rng(seed + 100)
    keys = (u32(rng, m).astype(np.uint64) << np.uint64(32)) | u32(rng, m)
    keys[-1] = keys[-2]
    return keys, np.arange(1, m + 1, dtype=np.uint32)


def survivors(case, C, deg, adv, hits, seed=0):
    """(pos (C,) int32, qhi, qlo (C,) uint32, n int) in B = R*U queries:
    ascending positions (padding B with the last survivor's key), every
    other survivor's key one of `hits` ((k,) uint64 table keys; hits[-1]
    duplicated in the table), the rest random."""
    rng = np.random.default_rng(seed + 200 + SUMMARY_CASES.index(case))
    R, U = deg.shape
    B = R * U
    n = {"none": 0, "over": C + 5}.get(case, C - C // 4)
    k = min(n, C)
    flagged = np.flatnonzero(deg.reshape(-1))
    adv_lanes = np.flatnonzero(adv) * U + U - 1
    planted = np.unique(np.concatenate([rng.permutation(flagged)[: k // 4],
                                        rng.permutation(adv_lanes)[: k // 4]]))
    others = np.setdiff1d(rng.choice(B, 2 * k, replace=False), planted)
    pos_k = np.sort(np.concatenate([planted, rng.permutation(others)[: k - len(planted)]]))
    keys = (u32(rng, C).astype(np.uint64) << np.uint64(32)) | u32(rng, C)
    keys[: k: 2] = hits[rng.integers(0, len(hits), len(keys[: k: 2]))]
    keys[1: k: 7] = hits[-1]
    pos = np.full(C, B, np.int32)
    pos[:k] = pos_k
    if 0 < k < C:
        keys[k:] = keys[k - 1]
    return (pos, (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32), n)
