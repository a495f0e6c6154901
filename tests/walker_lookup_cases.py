"""Inputs of the walker step's exact lookup and summary
(keyhuntm1cpu_tpu_torch/filter/sorted_table.py lookup_summary), made
from a seed with numpy, for tests/test_torch_lookup.py (against the JAX
package) and tests/test_torch_kernels_cuda.py (the kernel against its
plain version). Imports neither JAX nor torch.

A case is a walker step of W walkers with U table lanes (npts = 2U + 1
points a walker) and nq query sets, so total = nq*W*npts query
positions; C compacted probe survivors at ascending positions, padded
with total (and with the last survivor's key, as the probe pads); a
sorted table of m truncated keys holding every other survivor's key;
random degenerate (W, U) and advance (W,) flags. The cases:

- random: nothing planted;
- dup: two table entries share a survivor's key (found2);
- above: a survivor's key above every table key (lower bound == m);
- m1: a table of one key, a survivor's;
- padding: the padding's key (the last survivor's) is in the table;
- degenerate: hits on lanes +u and -u of a flagged u (dropped, in both
  query sets) and on the flagged walker's center (kept);
- no_deg: walker 1 has no flag (first_deg 0);
- overflow: C survivors and a count past C;
- wide: W = 11, U = 48, C = 300 (more walkers than warps and more
  survivors than threads in the kernel's block; rows of 16 bytes);
- m32, m33, m34, m1089, m1090: tables of 32 keys (the 32-ary warp
  search's last level alone), 33 and 34 (one level, then the rest), 33^2
  and 33^2 + 1 (a power of 33 and just above);
- pivot_dup: 1,090 keys holding two duplicated keys, one pair across the
  first level's 16th pivot (positions p - 1 and p) and one starting at the
  8th (p and p + 1), each a survivor's key (found2);
- ends: survivors' keys equal to the table's first and last keys;
- smoke: chip_smoke.py's walker shape, W = 8, U = 4096, C = 256, over
  2^22 keys.
"""

import numpy as np

CASES = ["random", "dup", "above", "m1", "padding", "degenerate", "no_deg", "overflow", "wide",
         "m32", "m33", "m34", "m1089", "m1090", "pivot_dup", "ends"]
# each case's seed offset: its place in the order the cases were added, so
# a case appended to CASES leaves the data of the others as they were
SEED_ORDER = CASES[:9] + ["smoke"] + CASES[9:]
SHAPES = {"wide": dict(W=11, U=48, C=300), "smoke": dict(W=8, U=4096, C=256, m=1 << 22),
          "m32": dict(m=32), "m33": dict(m=33), "m34": dict(m=34), "m1089": dict(m=1089),
          "m1090": dict(m=1090), "pivot_dup": dict(m=1090)}
# pivot_dup: the sorted positions of its duplicated pairs, (p - 1, p) and
# (p, p + 1) for the warp search's first-level pivots p = m * (i + 1) // 33
PIVOT_PAIRS = ((1090 * 16 // 33 - 1, 1090 * 16 // 33), (1090 * 8 // 33, 1090 * 8 // 33 + 1))
PIVOT_SURVIVORS = (2, 3)  # the survivors whose keys they are
ENDS_SURVIVORS = (1, 3)  # ends: the survivors with the first and the last key


def make_case(case, W=3, U=20, nq=2, C=16, m=64, seed=0):
    """dict of numpy arrays: table hi, lo, idx (m,) uint32; pos (C,) int32;
    qhi, qlo (C,) uint32; n (the survivor count); deg (W, U) and adeg (W,)
    bool; total."""
    shape = dict(W=W, U=U, C=C, m=m) | SHAPES.get(case, {})
    W, U, C, m = shape["W"], shape["U"], shape["C"], shape["m"]
    if case == "m1":
        m = 1
    rng = np.random.default_rng(seed + SEED_ORDER.index(case))
    npts = 2 * U + 1
    total = nq * W * npts
    words = lambda k: rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32)
    qh, ql = words(total), words(total)
    deg = rng.random((W, U)) < 0.1
    adeg = rng.random(W) < 0.3
    k = C if case in ("overflow", "wide", "smoke") else C - 5  # survivors
    must = []
    if case == "degenerate":
        u = 4  # lane index u - 1 = 3 of walker 1 in both query sets
        deg[1, u - 1] = True
        for q in range(nq):
            base = q * W * npts + npts
            must += [base + u - 1, base + U + u - 1, base + 2 * U]
    if case == "no_deg":
        deg[1:3] = False
        deg[2, [5, 9]] = True  # first_deg 5
    rest = np.setdiff1d(np.arange(total), must)
    pos = np.sort(np.concatenate([np.asarray(must, np.int64),
                                  rng.choice(rest, k - len(must), replace=False)]))
    if case == "above":
        qh[pos[1]] = ql[pos[1]] = 0xFFFFFFFF
    hits = list(pos[::2]) + must + ([pos[-1]] if case == "padding" else [])
    hits = sorted(set(hits) - ({pos[1]} if case == "above" else set()))
    hits = np.asarray(hits, np.int64)
    thi, tlo = qh[hits], ql[hits]
    if case == "dup":
        thi, tlo = np.append(thi, qh[pos[2]]), np.append(tlo, ql[pos[2]])
    if case == "m1":
        thi, tlo = qh[pos[:1]], ql[pos[:1]]
    fill = m - len(thi)
    if fill < 0:
        thi, tlo = thi[:m], tlo[:m]
    else:
        thi, tlo = np.append(thi, words(fill)), np.append(tlo, words(fill))
    if case == "above":  # no table key equals the all-ones key
        keep = ~((thi == 0xFFFFFFFF) & (tlo == 0xFFFFFFFF))
        thi, tlo = thi[keep], tlo[keep]
    if case in ("pivot_dup", "ends"):  # the table in its sorted order, keys placed in it
        key = np.sort(np.unique((thi.astype(np.uint64) << np.uint64(32)) | tlo))
        while len(key) < m:  # (a repeat among the random fill: top it up)
            key = np.sort(np.unique(np.append(key, words(1).astype(np.uint64) << np.uint64(32))))
        plant = (PIVOT_PAIRS if case == "pivot_dup" else
                 ((0, 0), (len(key) - 1, len(key) - 1)))
        survivors = PIVOT_SURVIVORS if case == "pivot_dup" else ENDS_SURVIVORS
        for (a, b), j in zip(plant, survivors):
            key[b] = key[a]
            qh[pos[j]], ql[pos[j]] = key[a] >> np.uint64(32), key[a] & np.uint64(0xFFFFFFFF)
            lane = pos[j] % (W * npts) % npts  # a live lane: its flag cleared
            if lane < 2 * U:
                deg[pos[j] % (W * npts) // npts, lane % U] = False
        thi, tlo = (key >> np.uint64(32)).astype(np.uint32), key.astype(np.uint32)
    idx = words(len(thi))
    pad = C - len(pos)
    qhi = np.append(qh[pos], np.full(pad, qh[pos[-1]], np.uint32))
    qlo = np.append(ql[pos], np.full(pad, ql[pos[-1]], np.uint32))
    n = C + 17 if case == "overflow" else len(pos)
    pos = np.append(pos, np.full(pad, total)).astype(np.int32)
    return dict(hi=thi, lo=tlo, idx=idx, pos=pos, qhi=qhi, qlo=qlo, n=n, deg=deg, adeg=adeg,
                total=total)
