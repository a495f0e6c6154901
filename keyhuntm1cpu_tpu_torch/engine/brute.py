"""Brute-force scanning engine: address / rmd160 / xpoint / eth.

Port of keyhuntm1cpu_tpu/engine/brute.py with its vanity intervals and
position checkpoints. The path is chosen by the target set alone, never by
the device:

- **Fused path** (``_search_fused``; the JAX package's ``_init_fast`` and
  ``_search_pallas``), for up to bucket_max exact targets: one chunk walks
  K device steps of U consecutive stride-spaced keys from a single chain
  (curve/pbrute.py: K1 advance chain, K4 walk + hash + membership,
  compaction) and returns one packed summary. Exact targets are point
  intervals and vanity prefixes real 64-bit [lo, hi] ranges of one
  compare, up to compare_max entries together; past that, exact targets
  go to the lane-bucketed table and the intervals alone stay in the
  compare. U must be a multiple of 128. Interval hits are checked against
  their base58 prefixes on the host; on the card the chunk's candidate
  keys first go through one K6 batch (curve/pladder.scalar_mult_points).
- **Walker path** (``_search_walker``; the JAX package's XLA fallback,
  ``_brute_chunk_impl`` and its ``search``), past bucket_max targets, for
  a U that is not a positive multiple of 128 (the JAX engine's "shapes
  untiled"), or for any set with compare_max = bucket_max = 0 (the JAX
  pallas="off"; intervals have no walker path): W
  walkers each own a slice of the range; a device step moves every walker
  by a window of 2U+1 keys around its center (curve/walk.py: one batched
  inversion), hashes every point (hash/phash.py kernels, or the raw x in
  xpoint mode) and probes the target bitmap (filter/bitmap.probe_compact),
  then searches the compacted survivors in the sorted target table and
  writes the step's summary row (filter/sorted_table.lookup_summary).
  Any U works.

The JAX package runs the walker path on its CPU backend whatever the set;
the port's CPU runs either path through the kernels' plain versions. The
host verifies every candidate exactly.

Fused index algebra: key(j) = a' + j*stride for the flat index
j = s*U + u, u in 0..U-1; the base scalar of step s is
a' - stride + s*U*stride, and the table holds (u+1)*stride*G. a' = a,
shifted by one stride when a - stride == 0 (mod n): that base would be the
point at infinity, and the skipped key a is verified on the host.

Walker index algebra: walker w starts at window index w*slice_len; at
step s its center is key a + (base + s*(2U+1) + U)*stride and it covers
the 2U+1 keys around it (lanes +u, -u, the center).

Modes (the reference's -m and -l):
- 'xpoint'     : the low 64 bits of X
- 'rmd160'     : hash160 of both compressed parities ('address' parses
                 base58 targets into the same mode)
- 'address_u'  : hash160(04 || x || y)
- 'rmd160_both': both compressed parities and the uncompressed key (-l both)
- 'eth'        : keccak256(x || y)[12:]
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.log import get_logger
from ..core.checkpoint import fingerprint
from ..core.metrics import current_call, spanned
from ..curve import pbrute, pladder, pwalk, tables, walk
from ..curve.points import PointBatch, point_batch_from_ints
from ..field import fe
from ..filter import bitmap as bmp
from ..filter import sorted_table as st
from ..hash import phash
from ..ref import ecref, hashref
from ..utils.targets import TargetSet
from . import pipeline
from .common import FoundKey, SearchStats

# lambda^e factors for GLV endomorphism key reconstruction (keyhunt.cpp:2800-2851)
_LAM_POW = (1, ecref.LAMBDA, ecref.LAMBDA * ecref.LAMBDA % ecref.N)
_UNSET = object()  # _verify's point argument when the caller has none


@dataclass(frozen=True)
class BruteParams:
    """keyhuntm1cpu_tpu's BruteParams without its TPU knobs (pallas,
    pallas_sb, hash_rows)."""

    walkers: int = 4  # W walkers of the walker path (reference -t)
    block_u: int = 256  # U: keys per device step on the fused path (a
    # multiple of 128, or the walker path runs); the walker path's window is
    # 2U+1 keys per walker
    steps_per_chunk: int = 8  # K: device steps per chunk
    chain_len: int = 32  # walker path: Montgomery chain length of a step's
    # batched inversion (pinv.inv_batch inverts ceil(W*(U+2)/chain_len) totals)
    endo: bool = False  # GLV endomorphism (reference -e): also check
    # beta*x and beta^2*x, covering lambda*k and lambda^2*k (rmd160 and
    # xpoint; the walker path, like the JAX one, runs it in every mode)
    stride: int = 1  # key-space stride (reference -I)
    random_mode: bool = False  # reference -R: each chunk (each walker, on the
    # walker path) starts at a random step-aligned position
    seed: int = 0
    seq_per_base: Optional[int] = None  # reference -n with -R: scan this many
    # sequential keys from each random base (rounded up to whole chunks);
    # None = one chunk per base
    cand_max: int = 256  # walker path: compacted probe survivors per step;
    # overflow -> exact host rescan of the step
    chunk_cand: int = 1024  # fused path: compacted candidates per chunk;
    # overflow -> exact host rescan of the chunk
    compare_max: int = 512  # largest exact target set for interval compares
    bucket_max: int = 1 << 16  # largest exact target set for the bucketed
    # table; larger sets take the walker path
    pipeline_depth: int = 8  # chunks in flight ahead of host decode


def _limbs(v: int, device) -> torch.Tensor:
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32)).to(device)


class BruteEngine:
    @spanned("engine_init")
    def __init__(self, targets: TargetSet, range_start: int, range_end: int,
                 mode: str = "rmd160", params: BruteParams = BruteParams(),
                 device="cuda", intervals=None, prefixes=None):
        """intervals: [(lo20, hi20)] hash160 bounds (engine/vanity.py), which
        compose with the exact targets in one scan (the reference's -v beside
        address mode); prefixes: the base58 prefixes an interval hit's
        address is checked against on the host."""
        if mode not in ("xpoint", "rmd160", "address", "address_u", "eth",
                        "rmd160_both"):
            raise ValueError(f"bad mode {mode}")
        if not (1 <= range_start < range_end <= ecref.N):
            raise ValueError("bad range")
        self.intervals = list(intervals or [])
        self.prefixes = list(prefixes or [])
        if not len(targets.raw) and not self.intervals:
            raise ValueError("no targets")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        p = params
        if p.stride < 1:
            raise ValueError("stride must be >= 1")
        n_exact, n_iv = len(targets.raw), len(self.intervals)
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
        self._parities = {"rmd160": 2, "rmd160_both": 3}.get(self.mode, 1)
        smem_ok = n_exact + n_iv <= p.compare_max
        # large exact sets: the lane-bucketed table; the intervals stay in
        # the compare, so they alone must fit its budget
        self._bucketed = not smem_ok and n_iv <= p.compare_max and n_exact <= p.bucket_max
        untiled = p.block_u % pbrute.LANES != 0 or p.block_u < pbrute.LANES
        self._walker = untiled or not (smem_ok or self._bucketed)
        if self._walker:
            if n_iv:
                raise ValueError(
                    "interval membership (vanity prefixes) needs the fused path: at most "
                    f"{p.compare_max} intervals, {p.bucket_max} exact targets and a "
                    f"block_u that is a multiple of {pbrute.LANES}")
            get_logger().warn(
                f"brute fused-kernel path disabled (target set {n_exact}+{n_iv} > "
                f"{p.compare_max} (bucketed cap {p.bucket_max}) or shapes untiled): "
                "the walker path runs instead")
            self._init_walker()
        else:
            self._init_fused()

    def _init_fused(self) -> None:
        p, n_exact = self.p, len(self.targets.raw)
        self._n_endo = 3 if (p.endo and self.mode in pbrute.ENDO_MODES) else 1
        tab_x, tab_y = tables.step_table(ecref.scalar_mult(self.stride), p.block_u)
        self.tab_x = pwalk.table_to_limb_major(tab_x, self.device)
        self.tab_y = pwalk.table_to_limb_major(tab_y, self.device)
        adv = ecref.scalar_mult(p.block_u * self.stride)
        self.adv_x = _limbs(adv[0], self.device)
        self.adv_y = _limbs(adv[1], self.device)
        self.adv_tab = pwalk.adv_multiples(adv, p.steps_per_chunk, self.device)

        # membership = 64-bit big-endian intervals: exact targets as point
        # intervals (or the bucketed table past compare_max), vanity
        # prefixes as real ranges
        vals = [self._cmp64(r) for r in self.targets.raw]
        lo64 = [] if self._bucketed else list(vals)
        hi64 = list(lo64)
        for lo20, hi20 in self.intervals:
            lo64.append(int.from_bytes(lo20[:8], "big"))
            hi64.append(int.from_bytes(hi20[:8], "big"))
        if not lo64:
            # one impossible interval (lo > hi) keeps the kernel uniform
            lo64, hi64 = [1], [0]
        if self._bucketed:
            btab = pbrute.pack_buckets(vals)
            self._btab = torch.from_numpy(btab.view(np.int32)).to(self.device)
            self._n_bucket_rows = self._btab.shape[0]
        else:
            self._btab = torch.zeros((8, pbrute.LANES), dtype=torch.int32,
                                     device=self.device)
            self._n_bucket_rows = 0
        self._tgt = torch.from_numpy(pbrute.pack_intervals(lo64, hi64).view(np.int32)).to(
            self.device)
        # interval hits are true hits about as often as the intervals cover
        # hash160 space (~1.9 a chunk for a 5-character prefix at U = 16384,
        # K = 256), too many for a host scalar mult each: on the card their
        # keys go through one K6 batch a chunk, on a stream of its own
        self._k6 = None
        if self.intervals and self.device.type == "cuda":
            self._k6 = pladder.gtable_tensors(self.device)
            self._k6_stream = torch.cuda.Stream(self.device, priority=-1)

        self._set_fused_range()
        self._chunk_fn = self._fused_chunk

    def _set_fused_range(self) -> None:
        """The fused path's index range over [a, b). Lattice-shift edge:
        base(0) = a - stride would be the point at infinity when a ==
        stride; shift by one stride, host-verify key a."""
        self._fast_a = self.a
        self._fast_prefix: List[int] = []
        if (self.a - self.stride) % ecref.N == 0:
            self._fast_prefix.append(self.a)
            self._fast_a = self.a + self.stride
        self._fast_total_idx = max(0, math.ceil((self.b - self._fast_a) / self.stride))
        self._fast_total_steps = math.ceil(self._fast_total_idx / self.p.block_u)

    def for_range(self, range_start: int, range_end: int) -> "BruteEngine":
        """A fused-path engine over [range_start, range_end) that shares
        this one's device structures (step tables, target words, bucket
        table, K6 tables): a shallow copy with its own range and stats."""
        if self._walker:
            raise ValueError("for_range needs the fused path")
        if not (1 <= range_start < range_end <= ecref.N):
            raise ValueError("bad range")
        eng = copy.copy(self)
        eng.a, eng.b = range_start, range_end
        eng.stats = SearchStats()
        eng.stats.multiplier = self.stats.multiplier
        eng._set_fused_range()
        eng._chunk_fn = eng._fused_chunk
        return eng

    def _init_walker(self) -> None:
        """The walker path's state (the JAX engine's __init__ past
        _use_pallas, and _make_chunk_fn)."""
        p = self.p
        if min(p.walkers, p.block_u, p.steps_per_chunk, p.chain_len, p.cand_max) < 1:
            raise ValueError("walkers, block_u, steps_per_chunk, chain_len and cand_max "
                             "must be >= 1")
        self.window = 2 * p.block_u + 1
        total_idx = math.ceil((self.b - self.a) / self.stride)
        slice_len = math.ceil(total_idx / p.walkers)
        # whole windows per slice keep the walkers aligned
        self.slice_len = math.ceil(slice_len / self.window) * self.window
        self.steps_per_walker = self.slice_len // self.window
        self.total_steps = self.steps_per_walker * p.walkers
        tab_x, tab_y = tables.step_table(ecref.scalar_mult(self.stride), p.block_u)
        self.tab_x = pwalk.table_to_limb_major(tab_x, self.device)
        self.tab_y = pwalk.table_to_limb_major(tab_y, self.device)
        adv = ecref.scalar_mult(self.window * self.stride)
        self.adv_x = _limbs(adv[0], self.device)
        self.adv_y = _limbs(adv[1], self.device)
        self._n_endo = 3 if p.endo else 1
        self.n_qsets = pbrute.n_qsets(self.mode, self._n_endo)
        self.table = self.targets.build_table(self.device)
        self.bitmap = self.targets.build_bitmap(device=self.device)
        self._chunk_fn = self._walker_chunk

    def _cmp64(self, raw: bytes) -> int:
        """64-bit big-endian compare value of a target: the low 64 bits of
        X (xpoint) or the first 8 digest bytes."""
        if self.mode == "xpoint":
            return int.from_bytes(raw, "big") & ((1 << 64) - 1)
        return int.from_bytes(raw[:8], "big")

    def _fused_chunk(self, px, py):
        p = self.p
        return pbrute.brute_chunk(
            px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y, self._tgt,
            self._btab, K=p.steps_per_chunk, U=p.block_u, C=p.chunk_cand,
            mode=self.mode, n_endo=self._n_endo, n_bucket_rows=self._n_bucket_rows,
            adv_tab=self.adv_tab)

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
               progress_every: int = 0, checkpoint=None,
               max_seconds: Optional[float] = None) -> List[FoundKey]:
        """Scan up to max_steps device steps (per walker on the walker path);
        max_seconds stops dispatch at the first chunk boundary past it.
        checkpoint: a core.checkpoint.CheckpointManager; the run resumes
        past its saved position and saves the exactly decoded one."""
        fn = self._search_walker if self._walker else self._search_fused
        return fn(max_steps, stop_on_first, progress_every, checkpoint, max_seconds)

    def _reverify_saved(self, ck) -> List[FoundKey]:
        """The keys an interrupted run saved, verified again: the caller
        writes found keys from the return value only."""
        return [f for f in (self._verify(int(h, 16)) for h in ck.found) if f is not None]

    # ------------------------------------------------------------------
    # fused path
    # ------------------------------------------------------------------

    def _search_fused(self, max_steps: Optional[int] = None, stop_on_first: bool = False,
                      progress_every: int = 0, checkpoint=None,
                      max_seconds: Optional[float] = None) -> List[FoundKey]:
        """Scan up to max_steps device steps in engine/pipeline.py's loop:
        up to pipeline_depth chunks in flight, the walk state chains on the
        device and only summaries come back (pinned, non-blocking).
        Progress is saved for decoded chunks only, never for the ones in
        flight."""
        total = (self._fast_total_steps if max_steps is None
                 else min(self._fast_total_steps, max_steps))
        return pipeline.run("_search_fused", _FusedPlan(self, total, checkpoint), stop_on_first,
                            max_seconds, progress_every)

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
            current_call().count("cascade_overflows")
            found += self._host_rescan_fast(step0, k_eff)
        cands = []  # candidate scalars, one a hit bit, then degenerate lanes
        for c in np.nonzero(pos < K * U)[0]:
            s_local, u0 = divmod(int(pos[c]), U)
            j = (step0 + s_local) * U + u0
            if j >= self._fast_total_idx:
                continue
            key = self._fast_key(j)
            b, q = int(bits[c]), 0
            while b:
                if b & 1:
                    cands.append(key * _LAM_POW[q // self._parities] % ecref.N)
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
                cands.append(self._fast_key(j))
        return k_eff, found + self._verify_all(cands)

    def _verify_all(self, cands: Sequence[int]) -> List[FoundKey]:
        """_verify of each candidate (counted; false where it gives no key).
        An engine with intervals on the card first computes the candidates'
        points in one K6 batch, on a stream of its own so that it does not
        queue behind the chunks in flight."""
        tr = current_call()
        with tr.span("verify"):
            pts = {}
            if cands and self._k6 is not None:
                uniq = sorted({k % ecref.N for k in cands})
                with torch.cuda.stream(self._k6_stream):
                    pts = dict(zip(uniq, pladder.scalar_mult_points(uniq, *self._k6)))
            out = []
            for k in cands:
                fk = self._verify(k, 0, pts.get(k % ecref.N, _UNSET))
                if fk:
                    out.append(fk)
        if cands:
            tr.count("candidates_verified", len(cands))
            tr.count("false_candidates", len(cands) - len(out))
        return out

    def _host_rescan_fast(self, step0: int, k: int) -> List[FoundKey]:
        """Exact host rescan of k device steps (python-int walk, per-key
        artifact compare): candidate overflow or a base at infinity."""
        tr = current_call()
        tr.count("host_rescans", k)
        with tr.span("rescan"):
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
                        if any(a in rawset for a in arts) or any(
                                lo20[:8] <= a[:8] <= hi20[:8]
                                for a in arts for lo20, hi20 in self.intervals):
                            fk = self._verify(kk * _LAM_POW[e] % ecref.N)
                            if fk:
                                found.append(fk)
                key += self.stride
                nxt = key % ecref.N
                pt = (ecref.point_add(pt, step_pt) if pt is not None
                      else (ecref.scalar_mult(nxt) if nxt else None))
            return found

    # ------------------------------------------------------------------
    # walker path (the JAX package's XLA fallback)
    # ------------------------------------------------------------------

    def _centers_for_bases(self, bases: Sequence[int]) -> PointBatch:
        """Walker centers for per-walker window-start indices `bases`
        (flat index units: key = a + idx*stride)."""
        return point_batch_from_ints(
            [ecref.scalar_mult(self.a + (b + self.p.block_u) * self.stride) for b in bases],
            self.device)

    def _sequential_bases(self, step0: int = 0) -> List[int]:
        return [w * self.slice_len + step0 * self.window for w in range(self.p.walkers)]

    def _queries(self, res: walk.FusedWalkResult):
        """(qhi, qlo) (nq*W*npts,) int32: the mode's compare words of every
        point, GLV variant major, then the mode's hashes, then walker and
        lane (the JAX chunk's concatenation order)."""
        y = None if res.y_all is None else res.y_all.reshape(8, -1)
        qhis, qlos = [], []
        for xv in res.x_all.reshape(self._n_endo, 8, -1):
            if self.mode == "xpoint":
                hi, lo = st.trunc64_from_limbs(xv)
                qhis.append(hi)
                qlos.append(lo)
                continue
            words = []
            if self.mode in ("rmd160", "rmd160_both"):
                words += list(phash.hash160_x2_from_batch(xv))
            if self.mode in ("address_u", "rmd160_both"):
                words.append(phash.hash160_u_from_batch(xv, y))
            elif self.mode == "eth":
                words.append(phash.keccak_eth_from_batch(xv, y))
            qlos += [lo for lo, _ in words]
            qhis += [hi for _, hi in words]
        if len(qhis) == 1:
            return qhis[0], qlos[0]
        return torch.cat(qhis), torch.cat(qlos)

    def _walker_chunk(self, cx, cy):
        """K walker steps from centers (8, W) -> (next centers x2, the
        (K, 2C + 3W + 1) int32 summary of _brute_chunk_impl): per step the
        C candidate positions (nq*W*npts = none), their table rows, per
        walker the degenerate-lane count, the first degenerate lane and the
        advance degeneracy, and the true survivor count."""
        p = self.p
        W, C = p.walkers, p.cand_max
        total = self.n_qsets * W * self.window
        out = torch.empty((p.steps_per_chunk, st.summary_width(C, W)), dtype=torch.int32,
                          device=cx.device)
        for s in range(p.steps_per_chunk):
            res = walk.walk_fused(PointBatch(cx, cy, None), self.tab_x, self.tab_y,
                                  self.adv_x, self.adv_y, need_y=self.mode in pbrute.NEEDS_Y,
                                  chain_len=p.chain_len, n_endo=self._n_endo)
            qhi, qlo = self._queries(res)
            pc = bmp.probe_compact(self.bitmap, qhi, qlo, C)
            st.lookup_summary(self.table, *pc, res.degenerate, res.adv_degenerate, total,
                              out=out[s])
            cx, cy = res.adv_x, res.adv_y
        return cx, cy, out

    def _search_walker(self, max_steps: Optional[int] = None, stop_on_first: bool = False,
                       progress_every: int = 0, checkpoint=None,
                       max_seconds: Optional[float] = None) -> List[FoundKey]:
        """The JAX walker search in engine/pipeline.py's loop: one chunk of K
        steps in flight, its summary decoded (_decode_walker) before the
        next; the checkpoint counts device steps per walker."""
        total = self.steps_per_walker if max_steps is None else min(self.steps_per_walker,
                                                                     max_steps)
        return pipeline.run("_search_walker", _WalkerPlan(self, total, checkpoint), stop_on_first,
                            max_seconds, progress_every)

    def _decode_walker(self, bases: Sequence[int], k: int, arr: np.ndarray):
        """(found, a walker's advance degenerated) of a walker chunk's (K,
        2C + 3W + 1) summary from window starts `bases`: its first k steps'
        candidates and degenerate lanes verified, an overflow rescanned."""
        p = self.p
        W, U, C = p.walkers, p.block_u, p.cand_max
        npts = self.window
        cand_pos = arr[:, :C]
        cand_row = arr[:, C : 2 * C].view(np.uint32)
        n_deg = arr[:, 2 * C : 2 * C + W]
        first_deg = arr[:, 2 * C + W : 2 * C + 2 * W]
        adv_deg = arr[:, 2 * C + 2 * W : 2 * C + 3 * W]
        ncand = arr[:, 2 * C + 3 * W]
        total_q = self.n_qsets * W * npts
        found: List[FoundKey] = []
        for s in range(k):
            if ncand[s] > C:
                found += self._host_rescan_step(bases, s)
            for c in np.nonzero(cand_pos[s] < total_q)[0]:
                q, rem = divmod(int(cand_pos[s, c]), W * npts)
                w, lane = divmod(rem, npts)
                e = q // self._parities  # endomorphism power
                cand = self._key_for_lane(bases[w], s, lane)
                if e:
                    cand = cand * _LAM_POW[e] % ecref.N
                found.append(self._verify(cand, int(cand_row[s, c])))
            for w in range(W):
                # a degenerate lane: x(center) == x(off*stride*G), so the
                # center scalar is +-off*stride mod n; also the doubling lane 2c
                offs = ([int(first_deg[s, w]) + 1] if n_deg[s, w] > 0 else []) + (
                    [npts] if adv_deg[s, w] else [])
                c0 = self._key_for_lane(bases[w], s, 2 * U)
                for off in offs:
                    d = off * self.stride % ecref.N
                    found += [self._verify(c, 0) for c in (d, ecref.N - d, 2 * c0 % ecref.N)]
        return [f for f in found if f], bool(adv_deg[:k].any())

    def _host_rescan_step(self, bases: Sequence[int], s: int) -> List[FoundKey]:
        """Exact host rescan of one walker step (probe-survivor overflow):
        every key of every walker's window is verified with python ints."""
        found = []
        for w in range(self.p.walkers):
            for lane in range(self.window):
                fk = self._verify(self._key_for_lane(bases[w], s, lane), 0)
                if fk:
                    found.append(fk)
        return found

    def _key_for_lane(self, base_idx: int, s: int, lane: int) -> int:
        """Scalar of point lane `lane` of step s from window-start index
        base_idx: lanes 0..U-1 = +u, U..2U-1 = -u, 2U = the center."""
        u = self.p.block_u
        center = base_idx + s * self.window + u
        if lane < u:
            idx = center + (lane + 1)
        elif lane < 2 * u:
            idx = center - (lane - u + 1)
        else:
            idx = center
        return self.a + idx * self.stride

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

    def _verify(self, k: int, row: int = 0, pt=_UNSET) -> Optional[FoundKey]:
        """Exact host check of candidate scalar k, then of its negation:
        exact targets first, then (interval hits) the vanity prefixes, in
        every mode but xpoint. One scalar mult serves both, since (N - k)*G
        is the negation of k*G; pt: (k mod N)*G when the caller has it. row
        (the device's table row of a walker candidate) is not needed: the
        artifact's exact bytes find the target."""
        kk = k % ecref.N
        if pt is _UNSET:
            pt = ecref.scalar_mult(kk) if kk else None
        if pt is None:
            return None
        for cand, cpt in ((k, pt), (ecref.N - kk, ecref.point_neg(pt))):
            if not (1 <= cand < ecref.N):
                continue
            for got, compressed in self._artifacts(cpt):
                i = self._raw_index.get(got)
                if i is not None:
                    return FoundKey(private_key=cand, pubkey=cpt, compressed=compressed,
                                    target=self.targets.labels[i])
                if self.prefixes and self.mode != "xpoint":
                    addr = hashref.b58check_encode(b"\x00" + got)
                    if any(addr.startswith(pref) for pref in self.prefixes):
                        return FoundKey(private_key=cand, pubkey=cpt, compressed=compressed,
                                        target=addr)
        return None


class _BrutePlan(pipeline.ChunkPlan):
    """A brute search's chunks of K steps from its checkpoint's position
    (``unit`` steps a unit), in order or (-R) from random bases kept for
    cpb chunks (-n), the resumed run's draws replayed."""

    label = "brute"
    unit = 1

    def __init__(self, eng: BruteEngine, total: int, mgr, chunk_keys: int):
        p = eng.p
        self.eng, self.total, self.K, self.device = eng, total, p.steps_per_chunk, eng.device
        self.n_chunks = -(-total // self.K)
        self.resumed = 0
        if mgr is not None:
            ck = pipeline.open_checkpoint(self, mgr, eng.stats, dict(
                mode=f"brute:{eng.mode}", range_start=eng.a, range_end=eng.b,
                policy="random" if p.random_mode else "sequential", seed=p.seed,
                params_fp=fingerprint(eng.mode, p.block_u, self.K, eng.stride, p.endo, p.walkers,
                                      p.random_mode, p.seed, not eng._walker),
                targets_fp=fingerprint(sorted(eng.targets.raw), sorted(eng.intervals),
                                       sorted(eng.prefixes))))
            if ck is not None:  # its saved keys: the resumed run skips their chunks
                self.found0 = self.found0 + eng._reverify_saved(ck)
                self.resumed = ck.chunks_done
        self.rng = np.random.default_rng(p.seed) if p.random_mode else None
        self.cpb = max(1, math.ceil((p.seq_per_base or 0) / chunk_keys))
        for _ in range(math.ceil(self.resumed // self.unit / self.cpb) if p.random_mode else 0):
            self._draw()


class _FusedPlan(_BrutePlan):
    """The fused path's chunks of K*U keys (units with -R: chunks); exact
    bases by _fast_base; an advance degeneracy restarts at the first
    invalid step (in order only)."""

    def __init__(self, eng: BruteEngine, total: int, mgr):
        self.found0 = [f for f in map(eng._verify, eng._fast_prefix) if f]
        super().__init__(eng, total, mgr, eng.p.steps_per_chunk * eng.p.block_u)
        self.U, self.depth = eng.p.block_u, eng.p.pipeline_depth
        self.k_eff, self.group_left = self.K, 0
        self.step = 0 if self.rng is not None else min(self.resumed, total)
        self.done = self.done0 = min(self.resumed, self.n_chunks)  # chunks drawn (-R)

    def _draw(self) -> int:
        return int(self.rng.integers(0, max(1, self.eng._fast_total_steps - self.K + 1)))

    def next(self):
        if self.rng is None:
            if self.step >= self.total:
                return None
            s0 = self.step
        else:
            if self.done >= self.n_chunks:
                return None
            if (self.group_left <= 0 or self.chain is None
                    or self.step + self.K > self.eng._fast_total_steps):
                s0 = self._draw()
                self.chain = (s0, self.exact(s0))
                self.group_left = self.cpb
            else:
                s0 = self.step  # -n: the chained state is K steps on
            self.group_left -= 1
            self.done += 1
        self.step = s0 + self.K
        return s0, s0

    def exact(self, s0: int):
        px, py = self.eng._fast_base(s0)
        return pipeline.BaseIsKey() if px is None else (px, py)

    def dispatch(self, s0: int, base):
        px, py, out = self.eng._chunk_fn(*base)
        self.chain = (s0 + self.K, (px, py))
        return out

    def decode(self, s0: int, arr: np.ndarray):
        self.k_eff, found = self.eng._decode_fast(s0, arr)
        nxt = s0 + self.k_eff  # past an advance degeneracy the walk state is garbage
        restart = nxt if self.rng is None and self.k_eff < self.K and nxt < self.total else None
        return found, max(0, min(self.k_eff, self.total - s0)) * self.U, restart

    def on_host(self, s0: int, scalar):
        self.k_eff = self.K
        return self.eng._host_rescan_fast(s0, self.K), max(0, min(self.K, self.total - s0)) * self.U

    def mark(self, ck, s0: int, n_done: int) -> None:
        ck.chunks_done = s0 + self.k_eff if self.rng is None else self.done0 + n_done


class _WalkerPlan(_BrutePlan):
    """The walker path's chunks, one in flight: a position is (step, the
    walkers' window-start indices); units are steps a walker."""

    def __init__(self, eng: BruteEngine, total: int, mgr):
        self.unit = eng.p.steps_per_chunk
        super().__init__(eng, total, mgr, eng.p.steps_per_chunk * eng.window)
        self.step = min(self.resumed, total)
        self.bases = eng._sequential_bases(self.step)
        self.since_base = 0

    def _draw(self):
        return self.rng.integers(0, max(1, self.eng.total_steps - self.K), size=self.eng.p.walkers)

    def next(self):
        if self.step >= self.total:
            return None
        npts = self.eng.window
        if self.rng is not None and (
                self.since_base % self.cpb == 0
                or any(b // npts + self.K > self.eng.total_steps for b in self.bases)):
            # each walker re-bases to a uniform window-aligned position
            self.bases = [int(s0) * npts for s0 in self._draw()]
            self.chain, self.since_base = None, 0
        self.since_base += 1
        self.step += self.K
        return self.step - self.K, (self.step - self.K, self.bases)

    def exact(self, pos):
        ctr = self.eng._centers_for_bases(pos[1])
        return ctr.x, ctr.y

    def dispatch(self, pos, centers):
        cx, cy, out = self.eng._chunk_fn(*centers)
        self.bases = [b + self.K * self.eng.window for b in pos[1]]
        self.chain = (pos[0] + self.K, (cx, cy))
        return out

    def decode(self, pos, arr: np.ndarray):
        step, bases = pos
        eng, k, nxt = self.eng, min(self.K, self.total - step), step + self.K
        found, rebase = eng._decode_walker(bases, k, arr)
        chained = self.rng is None or self.since_base % self.cpb != 0  # the next chunk goes on
        return found, k * eng.p.walkers * eng.window, (
            nxt if rebase and chained and nxt < self.total else None)

    def restart(self, step: int) -> None:
        self.chain = (step, self.exact((step, self.bases)))

    def mark(self, ck, pos, n_done: int) -> None:
        ck.chunks_done = pos[0] + self.K
