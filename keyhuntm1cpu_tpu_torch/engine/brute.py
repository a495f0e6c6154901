"""Brute-force scanning engine: address / rmd160 / xpoint / eth, fused path.

Port of the fused-kernel path of keyhuntm1cpu_tpu/engine/brute.py
(``_init_fast`` and ``_search_pallas``). One chunk walks K device steps of
U consecutive stride-spaced keys from a single chain (curve/pbrute.py: K1
advance chain, K4 walk + hash + membership, compaction) and returns one
packed summary; the host verifies every candidate exactly.

Index algebra (the JAX package's): key(j) = a' + j*stride for the flat
index j = s*U + u, u in 0..U-1; the base scalar of step s is
a' - stride + s*U*stride, and the table holds (u+1)*stride*G. a' = a,
shifted by one stride when a - stride == 0 (mod n): that base would be the
point at infinity, and the skipped key a is verified on the host.

Membership: up to compare_max exact targets are point intervals compared
in the kernel; larger exact sets, up to bucket_max, go to the lane-bucketed
table (high-word compares, spurious candidates removed by host
verification). Past bucket_max there is no path in this port yet.

Modes (the reference's -m and -l):
- 'xpoint'     : the low 64 bits of X
- 'rmd160'     : hash160 of both compressed parities ('address' parses
                 base58 targets into the same mode)
- 'address_u'  : hash160(04 || x || y)
- 'rmd160_both': both compressed parities and the uncompressed key (-l both)
- 'eth'        : keccak256(x || y)[12:]
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..curve import pbrute, pwalk, tables
from ..field import fe
from ..ref import ecref, hashref
from ..utils.targets import TargetSet
from .common import Deadline, FoundKey, SearchStats, summary_to_host

# lambda^e factors for GLV endomorphism key reconstruction (keyhunt.cpp:2800-2851)
_LAM_POW = (1, ecref.LAMBDA, ecref.LAMBDA * ecref.LAMBDA % ecref.N)


@dataclass(frozen=True)
class BruteParams:
    """The fused-path subset of keyhuntm1cpu_tpu's BruteParams."""

    block_u: int = 256  # U: consecutive keys per device step (multiple of 128)
    steps_per_chunk: int = 8  # K: device steps per chunk
    endo: bool = False  # GLV endomorphism (reference -e): also check
    # beta*x and beta^2*x, covering lambda*k and lambda^2*k (rmd160, xpoint)
    stride: int = 1  # key-space stride (reference -I)
    random_mode: bool = False  # reference -R: each chunk starts at a random
    # step-aligned position instead of scanning in order
    seed: int = 0
    seq_per_base: Optional[int] = None  # reference -n with -R: scan this many
    # sequential keys from each random base (rounded up to whole chunks of
    # K*U keys); None = one chunk per base
    chunk_cand: int = 1024  # compacted candidates per chunk; overflow ->
    # exact host rescan of the chunk
    compare_max: int = 512  # largest exact target set for interval compares
    bucket_max: int = 1 << 16  # largest exact target set for the bucketed table
    pipeline_depth: int = 8  # chunks in flight ahead of host decode


def _limbs(v: int, device) -> torch.Tensor:
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32)).to(device)


class BruteEngine:
    def __init__(self, targets: TargetSet, range_start: int, range_end: int,
                 mode: str = "rmd160", params: BruteParams = BruteParams(),
                 device="cuda"):
        if mode not in ("xpoint", "rmd160", "address", "address_u", "eth",
                        "rmd160_both"):
            raise ValueError(f"bad mode {mode}")
        if not (1 <= range_start < range_end <= ecref.N):
            raise ValueError("bad range")
        if not len(targets.raw):
            raise ValueError("no targets")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        p = params
        if p.block_u % pbrute.LANES or p.block_u < pbrute.LANES:
            raise ValueError(f"block_u must be a positive multiple of {pbrute.LANES}")
        if p.stride < 1:
            raise ValueError("stride must be >= 1")
        n_exact = len(targets.raw)
        if n_exact > p.bucket_max:
            raise ValueError(
                f"{n_exact} targets exceed bucket_max={p.bucket_max}: larger sets need "
                "the large-T brute fallback (ROADMAP.md section 1, item 5b), which "
                "this port does not have yet")
        self.mode = "rmd160" if mode == "address" else mode
        self.targets = targets
        # first occurrence wins on duplicate targets
        self._raw_index = {r: i for i, r in reversed(list(enumerate(targets.raw)))}
        self.a = range_start
        self.b = range_end
        self.p = p
        self.stride = p.stride
        self.stats = SearchStats()
        mult = {"rmd160": 2, "rmd160_both": 3}.get(self.mode, 1)
        if p.endo and self.mode in pbrute.ENDO_MODES:
            mult *= 3
        self.stats.multiplier = mult

        self._n_endo = 3 if (p.endo and self.mode in pbrute.ENDO_MODES) else 1
        self._parities = {"rmd160": 2, "rmd160_both": 3}.get(self.mode, 1)
        tab_x, tab_y = tables.step_table(ecref.scalar_mult(self.stride), p.block_u)
        self.tab_x = pwalk.table_to_limb_major(tab_x, self.device)
        self.tab_y = pwalk.table_to_limb_major(tab_y, self.device)
        adv = ecref.scalar_mult(p.block_u * self.stride)
        self.adv_x = _limbs(adv[0], self.device)
        self.adv_y = _limbs(adv[1], self.device)

        # exact targets: point intervals, or the bucketed table past compare_max
        self._bucketed = n_exact > p.compare_max
        vals = [self._cmp64(r) for r in targets.raw]
        if self._bucketed:
            # one impossible interval (lo > hi) keeps the kernel uniform
            tgt = pbrute.pack_intervals([1], [0])
            btab = pbrute.pack_buckets(vals)
            self._btab = torch.from_numpy(btab.view(np.int32)).to(self.device)
            self._n_bucket_rows = self._btab.shape[0]
        else:
            tgt = pbrute.pack_intervals(vals, vals)
            self._btab = torch.zeros((8, pbrute.LANES), dtype=torch.int32,
                                     device=self.device)
            self._n_bucket_rows = 0
        self._tgt = torch.from_numpy(tgt.view(np.int32)).to(self.device)

        # lattice-shift edge: base(0) = a - stride would be the point at
        # infinity when a == stride; shift by one stride, host-verify key a
        self._fast_a = self.a
        self._fast_prefix: List[int] = []
        if (self.a - self.stride) % ecref.N == 0:
            self._fast_prefix.append(self.a)
            self._fast_a = self.a + self.stride
        self._fast_total_idx = max(0, math.ceil((self.b - self._fast_a) / self.stride))
        self._fast_total_steps = math.ceil(self._fast_total_idx / p.block_u)

    def _cmp64(self, raw: bytes) -> int:
        """64-bit big-endian compare value of a target: the low 64 bits of
        X (xpoint) or the first 8 digest bytes."""
        if self.mode == "xpoint":
            return int.from_bytes(raw, "big") & ((1 << 64) - 1)
        return int.from_bytes(raw[:8], "big")

    def _chunk_fn(self, px, py):
        p = self.p
        return pbrute.brute_chunk(
            px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y, self._tgt,
            self._btab, K=p.steps_per_chunk, U=p.block_u, C=p.chunk_cand,
            mode=self.mode, n_endo=self._n_endo, n_bucket_rows=self._n_bucket_rows)

    def _fast_base(self, step0: int):
        """Device point of the chunk's base scalar, or (None, None) when it
        is the point at infinity (the caller rescans on the host)."""
        s = (self._fast_a - self.stride + step0 * self.p.block_u * self.stride) % ecref.N
        if s == 0:
            return None, None
        pt = ecref.scalar_mult(s)
        return _limbs(pt[0], self.device), _limbs(pt[1], self.device)

    def _fast_key(self, j: int) -> int:
        return self._fast_a + j * self.stride

    def search(self, max_steps: Optional[int] = None, stop_on_first: bool = False,
               progress_every: int = 0,
               max_seconds: Optional[float] = None) -> List[FoundKey]:
        return self._search_fused(max_steps, stop_on_first, progress_every, max_seconds)

    def _search_fused(self, max_steps: Optional[int] = None, stop_on_first: bool = False,
                      progress_every: int = 0,
                      max_seconds: Optional[float] = None) -> List[FoundKey]:
        """Scan up to max_steps device steps; up to pipeline_depth chunks are
        in flight, the walk state chains on the device and only summaries
        come back (pinned, non-blocking). max_seconds stops dispatch at the
        first chunk boundary past the deadline."""
        p = self.p
        dl = Deadline(max_seconds)
        U, K = p.block_u, p.steps_per_chunk
        total = (self._fast_total_steps if max_steps is None
                 else min(self._fast_total_steps, max_steps))
        found: List[FoundKey] = []
        seen = set()

        def take(fk: Optional[FoundKey]) -> None:
            if fk and fk.private_key not in seen:
                seen.add(fk.private_key)
                found.append(fk)

        for k0 in self._fast_prefix:
            take(self._verify(k0))
            if found and stop_on_first:
                return found

        rng = np.random.default_rng(p.seed) if p.random_mode else None
        # chunks per random base (reference -n): a chunk covers K*U keys
        cpb = 1
        if rng is not None and p.seq_per_base:
            cpb = max(1, math.ceil(p.seq_per_base / (K * U)))
        group_left = 0  # chunks left on the current random base
        s_next = 0  # continuation step on the current base
        n_chunks = math.ceil(total / K) if total else 0
        chunks_done = 0
        pending: deque = deque()
        disp_step = 0  # next step to dispatch (sequential order)
        disp_chunks = 0  # chunks dispatched (random order)
        px = py = None
        if rng is None and total:
            px, py = self._fast_base(0)

        def can_dispatch() -> bool:
            if dl.expired():
                return False
            return disp_chunks < n_chunks if rng is not None else disp_step < total

        while pending or can_dispatch():
            while can_dispatch() and len(pending) < p.pipeline_depth:
                if rng is not None:
                    if (group_left <= 0 or px is None
                            or s_next + K > self._fast_total_steps):
                        s0 = int(rng.integers(0, max(1, self._fast_total_steps - K + 1)))
                        px, py = self._fast_base(s0)
                        group_left = cpb
                    else:
                        s0 = s_next  # -n: the chained state is K steps on
                    group_left -= 1
                    s_next = s0 + K
                else:
                    s0 = disp_step
                if px is None:
                    pending.append((s0, None))  # base at infinity: host rescan
                else:
                    px, py, out = self._chunk_fn(px, py)
                    pending.append((s0, summary_to_host(out)))
                disp_step = s0 + K
                disp_chunks += 1
            if not pending:
                break  # the deadline passed between the checks
            step0, out = pending.popleft()
            if out is None:
                new_found, k_eff = self._host_rescan_fast(step0, K), K
            else:
                host, ev = out
                if ev is not None:
                    ev.synchronize()
                k_eff, new_found = self._decode_fast(step0, host.numpy())
            for fk in new_found:
                take(fk)
            self.stats.add(max(0, min(k_eff, total - step0)) * U)
            chunks_done += 1
            if found and stop_on_first:
                return found
            if rng is None and k_eff < K:
                # advance-chain degeneracy: the chunks after this one walked
                # garbage state; drop them and restart from the first bad step
                pending.clear()
                disp_step = step0 + k_eff
                if disp_step < total:
                    px, py = self._fast_base(disp_step)
            if progress_every and chunks_done % progress_every == 0:
                print(f"[brute] chunk {chunks_done}/{n_chunks} {self.stats.human()}")
        return found

    def _decode_fast(self, step0: int, arr: np.ndarray) -> Tuple[int, List[FoundKey]]:
        """Decode one packed chunk summary -> (valid steps, found keys)."""
        p = self.p
        C, K, U = p.chunk_cand, p.steps_per_chunk, p.block_u
        pos = arr[:C]
        bits = arr[C : 2 * C].view(np.uint32)
        n_deg = arr[2 * C : 2 * C + K]
        first_deg = arr[2 * C + K : 2 * C + 2 * K]
        adv = arr[2 * C + 2 * K : 2 * C + 3 * K]
        ncand = int(arr[2 * C + 3 * K])
        k_eff = int(np.argmax(adv)) + 1 if adv.any() else K
        found: List[FoundKey] = []
        if ncand > C:
            found += self._host_rescan_fast(step0, k_eff)
        for c in np.nonzero(pos < K * U)[0]:
            s_local, u0 = divmod(int(pos[c]), U)
            j = (step0 + s_local) * U + u0
            if j >= self._fast_total_idx:
                continue
            key = self._fast_key(j)
            b, q = int(bits[c]), 0
            while b:
                if b & 1:
                    e = q // self._parities
                    fk = self._verify(key * _LAM_POW[e] % ecref.N)
                    if fk:
                        found.append(fk)
                b >>= 1
                q += 1
        for s_local in np.nonzero(n_deg > 0)[0]:
            s_local = int(s_local)
            if int(n_deg[s_local]) > 1:
                # several degenerate lanes (only on garbage steps after an
                # advance degeneracy): exact rescan of the step
                found += self._host_rescan_fast(step0 + s_local, 1)
                continue
            j = (step0 + s_local) * U + int(first_deg[s_local])
            if j < self._fast_total_idx:
                fk = self._verify(self._fast_key(j))
                if fk:
                    found.append(fk)
        return k_eff, found

    def _host_rescan_fast(self, step0: int, k: int) -> List[FoundKey]:
        """Exact host rescan of k device steps (python-int walk, per-key
        artifact compare): candidate overflow or a base at infinity."""
        U = self.p.block_u
        j0 = step0 * U
        j1 = min((step0 + k) * U, self._fast_total_idx)
        rawset = set(self.targets.raw)
        step_pt = ecref.scalar_mult(self.stride)
        found: List[FoundKey] = []
        pt = None
        key = self._fast_key(j0)
        for _ in range(j0, j1):
            kk = key % ecref.N
            if pt is None:
                pt = ecref.scalar_mult(kk) if kk else None
            if pt is not None:
                x, y = pt
                for e in range(self._n_endo):
                    xv = x * pow(ecref.BETA, e, ecref.P) % ecref.P
                    arts = []
                    if self.mode == "xpoint":
                        arts = [xv.to_bytes(32, "big")]
                    elif self.mode in ("rmd160", "rmd160_both"):
                        arts = [hashref.hash160(bytes([pfx]) + xv.to_bytes(32, "big"))
                                for pfx in (2, 3)]
                    if self.mode in ("address_u", "rmd160_both"):
                        arts.append(hashref.pubkey_to_hash160((xv, y), compressed=False))
                    elif self.mode == "eth":
                        arts = [hashref.pubkey_to_eth_address((xv, y))]
                    if any(a in rawset for a in arts):
                        fk = self._verify(kk * _LAM_POW[e] % ecref.N)
                        if fk:
                            found.append(fk)
            key += self.stride
            nxt = key % ecref.N
            pt = (ecref.point_add(pt, step_pt) if pt is not None
                  else (ecref.scalar_mult(nxt) if nxt else None))
        return found

    def _artifacts(self, pt):
        """[(artifact bytes, compressed?)] the mode checks per point."""
        if self.mode == "xpoint":
            return [(pt[0].to_bytes(32, "big"), True)]
        if self.mode == "rmd160":
            return [(hashref.pubkey_to_hash160(pt, compressed=True), True)]
        if self.mode == "address_u":
            return [(hashref.pubkey_to_hash160(pt, compressed=False), False)]
        if self.mode == "rmd160_both":
            return [(hashref.pubkey_to_hash160(pt, compressed=True), True),
                    (hashref.pubkey_to_hash160(pt, compressed=False), False)]
        return [(hashref.pubkey_to_eth_address(pt), True)]  # eth

    def _verify(self, k: int) -> Optional[FoundKey]:
        """Exact host check of candidate scalar k and its negation."""
        for cand in (k, ecref.N - (k % ecref.N)):
            if not (1 <= cand < ecref.N):
                continue
            pt = ecref.scalar_mult(cand)
            for got, compressed in self._artifacts(pt):
                i = self._raw_index.get(got)
                if i is not None:
                    return FoundKey(private_key=cand, pubkey=pt, compressed=compressed,
                                    target=self.targets.labels[i])
        return None
