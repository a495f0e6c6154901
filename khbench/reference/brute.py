"""The rmd160 reference: what a sequential brute-force scan must report.

Index algebra (the scan's definition, stride 1): key j of the range
[a, b) is a + j; a device step covers U consecutive keys, a chunk K steps,
so chunk c's summary position p names key a + c*K*U + p. Each key is
hashed in both compressed forms (02 || x and 03 || x): query set q is
prefix 2 + q. The walk state handed to chunk c + 1 is (a - 1 + (c + 1)*K*U)*G.
A target set past the compare's budget sits in the bucketed lane table
(filters.bucket_lanes), which can also pass a query whose high word alone
matches its lane: the reference holds every reported candidate to the
membership it stands for, and the host verification to the full digest.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from . import hashes
from . import secp256k1 as ec
from .bsgs import limbs_to_int


class Layout:
    def __init__(self, a: int, U: int, K: int):
        self.a, self.U, self.K = a, U, K
        self.per_chunk = U * K

    def key(self, chunk: int, pos: int) -> int:
        return self.a + chunk * self.per_chunk + pos

    def base(self, chunk: int):
        """The walk state handed to chunk `chunk`."""
        return ec.mul(self.a - 1 + chunk * self.per_chunk)

    def expected_hit(self, k: int) -> Tuple[int, int, int]:
        """(chunk, position, hit bit) of key k."""
        chunk, pos = divmod(k - self.a, self.per_chunk)
        return chunk, pos, 1 << (ec.mul(k)[1] & 1)


def query_values(k: int, bits: int) -> Dict[int, int]:
    """hit bit -> the 64-bit compare value of that query of key k."""
    x = ec.mul(k)[0].to_bytes(32, "big")
    out = {}
    for q in range(2):
        if bits >> q & 1:
            out[1 << q] = hashes.cmp64(hashes.hash160(bytes([2 + q]) + x))
    return out


def candidate_errors(lay: Layout, cands: Iterable[Tuple[int, int, int]], exact: set,
                     lanes: Optional[Dict[int, set]]) -> int:
    """Candidates (chunk, position, hit bits) whose reported query does not
    pass the membership: an exact compare value (exact), or with the lane
    table (lanes) its high word among its lane's. Bits past the two query
    sets, or none at all, are errors too."""
    bad = 0
    for chunk, pos, bits in cands:
        if bits <= 0 or bits >> 2 or not 0 <= pos < lay.per_chunk:
            bad += 1
            continue
        for v in query_values(lay.key(chunk, pos), bits).values():
            ok = v in exact or (lanes is not None and v >> 32 in lanes.get(v & 127, ()))
            bad += not ok
    return bad


def state_errors(lay: Layout, chunk: int, xs: np.ndarray, ys: np.ndarray) -> int:
    return int((limbs_to_int(xs), limbs_to_int(ys)) != lay.base(chunk))


def target_table_errors(values: Sequence[int], tgt: np.ndarray, btab: np.ndarray,
                        n_rows: int) -> int:
    """Targets missing from what the program packed: with lane rows, a
    target's high word must be in its lane's first n_rows rows; without,
    its value inside one of the (4, T) [lo_hi, lo_lo, hi_hi, hi_lo] u32
    intervals."""
    v = np.asarray(values, dtype=np.uint64)
    if n_rows:
        rows = btab[:n_rows].astype(np.uint64)  # (rows, 128)
        lane = (v & np.uint64(127)).astype(np.int64)
        hi = v >> np.uint64(32)
        bad = 0
        for s in range(0, len(v), 4096):
            bad += int((~(rows[:, lane[s:s + 4096]] == hi[None, s:s + 4096]).any(axis=0)).sum())
        return bad
    t = tgt.astype(np.uint64)
    lo = t[0] << np.uint64(32) | t[1]
    hi = t[2] << np.uint64(32) | t[3]
    return int((~((v[:, None] >= lo[None, :]) & (v[:, None] <= hi[None, :])).any(axis=1)).sum())
