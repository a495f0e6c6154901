"""The BSGS reference: what a giant-step search over [a, b) must report.

Index algebra (the search's definition): the baby table holds
trunc64(x(j*G)) for j = 1..m; stride = 2m; centre i is c_i = a + m +
i*stride and covers the keys c_i - m .. c_i + m; a device step walks U
consecutive centres, a chunk K steps; query (t, s, u) of a chunk is
Q_t - c*G with c the centre of step s, lane u, and sits at flat position
(t*K + s)*U + u of the chunk's summary. A slice of a sharded range starts
at centre step0*U of the whole range. The walk state handed from one
chunk to the next is P_t = Q_t - c_base*G, c_base = a + m + (s*U - 1)*stride
for the next chunk's first step s.

Everything is worked out again from the inputs (a, m, U, K, the targets)
with the benchmark's own curve arithmetic; the program's tables and
summaries are only read to be judged.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from . import filters
from . import secp256k1 as ec


class Layout:
    def __init__(self, a: int, m: int, U: int, K: int, T: int):
        self.a, self.m, self.U, self.K, self.T = a, m, U, K, T
        self.stride = 2 * m
        self.B = T * K * U

    def centre(self, step: int, lane: int) -> int:
        return self.a + self.m + (step * self.U + lane) * self.stride

    def base(self, target, step: int):
        """The walk state of `target` at the start of device step `step`."""
        return ec.add(target, ec.neg(ec.mul(self.centre(step, -1))))

    def expected_hits(self, k: int, t: int, step0: int = 0) -> List[Tuple[int, int, int]]:
        """(chunk, position, j) where key k of target t shows in the
        summaries of a search whose first step is step0 (a slice's)."""
        out = []
        off = k - self.a - self.m
        i0 = off // self.stride
        for i in (i0, i0 + 1):
            j = abs(k - (self.a + self.m + i * self.stride))
            if 1 <= j <= self.m and i >= step0 * self.U:
                step, lane = divmod(i, self.U)
                chunk, s = divmod(step - step0, self.K)
                out.append((chunk, (t * self.K + s) * self.U + lane, j))
        return out


def live_errors(lay: Layout, targets: Sequence, chunk: int, step0: int,
                entries: Iterable[Tuple[int, int, int]]) -> int:
    """Entries (position, j at the lower bound, j at its successor) that a
    chunk's summary marks as table matches: each j given must have the
    query's key; a live position needs at least one."""
    bad = 0
    for pos, j1, j2 in entries:
        if not 0 <= pos < lay.B or not (j1 or j2):
            bad += 1
            continue
        blk, lane = divmod(pos, lay.U)
        t, s = divmod(blk, lay.K)
        q = ec.add(targets[t], ec.neg(ec.mul(lay.centre(step0 + chunk * lay.K + s, lane))))
        key = None if q is None else ec.trunc64(q)
        for j in (j1, j2):
            if j and (j > lay.m or key != ec.trunc64(ec.mul(j))):
                bad += 1
    return bad


def limbs_to_int(limbs: np.ndarray) -> int:
    """(8,) little-endian 32-bit limbs -> integer."""
    return sum(int(v) << (32 * i) for i, v in enumerate(np.asarray(limbs).astype(np.uint32)))


def state_errors(lay: Layout, targets: Sequence, step: int, xs: np.ndarray,
                 ys: np.ndarray) -> int:
    """Targets whose walk state (T, 8) limbs is not the base at `step`."""
    bad = 0
    for t, q in enumerate(targets):
        want = lay.base(q, step)
        got = (limbs_to_int(xs[t]), limbs_to_int(ys[t]))
        bad += want is None or got != want
    return bad


def table_errors(key: torch.Tensor, idx: torch.Tensor, m: int, bitmap: torch.Tensor,
                 bits_log2: int, bloom2: "torch.Tensor | None", bloom2_bits_log2: int,
                 samples: Sequence[int]) -> int:
    """The baby table as the program holds it: key (m,) int64 (trunc64 with
    bit 63 flipped, ascending), idx (m,) int32 payload j. Counts: an
    unsorted key, a payload set that is not 1..m, and each sampled j whose
    key is not trunc64(x(j*G)) at j's row or whose bits are not set in the
    bitmap and bloom2 (int32 word tensors)."""
    bad = int(key.shape != (m,)) + int(idx.shape != (m,))
    if bad:
        return bad
    bad += int((key[1:] < key[:-1]).any())
    srt = torch.sort(idx.long()).values
    bad += int(not torch.equal(srt, torch.arange(1, m + 1, device=srt.device)))
    del srt
    rows = torch.full((len(samples),), -1, dtype=torch.int64, device=idx.device)
    for n, j in enumerate(samples):
        r = (idx == j).nonzero()
        if len(r) == 1:
            rows[n] = r[0, 0]
    got = key[rows.clamp(min=0)].cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)
    for n, j in enumerate(samples):
        k = ec.trunc64(ec.mul(j))
        bad += int(rows[n] < 0 or int(got[n]) != k)
        bits = [(bitmap, filters.bitmap_bit(k, bits_log2))]
        if bloom2 is not None:
            bits += [(bloom2, b) for b in filters.bloom2_bits(k, bloom2_bits_log2)]
        for words, b in bits:
            bad += int((int(words[b >> 5]) >> (b & 31)) & 1 == 0)
    return bad
