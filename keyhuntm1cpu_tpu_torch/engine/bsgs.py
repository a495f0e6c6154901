"""Baby-Step Giant-Step engine, host-resolve mode, on PyTorch + CUDA.

Port of keyhuntm1cpu_tpu/engine/bsgs.py (host-resolve, sequential order).
Index algebra is the JAX package's:

- stride = 2m. Centers c_i = a + m + i*stride tile the range [a, b).
- The device keeps only two probabilistic filters over the m baby keys
  trunc64(x(j*G)), j = 1..m: a direct-address bitmap and a k=2 hashed
  bloom ("bloom2"). The exact table (key -> j) lives on the host
  (filter/host_table.py, built by the native library).
- Giant walk: P(t, i) = Q_t - c_i*G. One chunk walks K steps of U centers
  for all T targets (curve/pwalk.py: advance chain K1 + walk blocks K2),
  runs the cascade (filter/bitmap.py) and returns ONE int32 summary of
  3*C2 + 3*T*K + 1 words: survivor positions, their 64-bit keys, the
  per-row degenerate summary and the (poisoned) survivor count.
- The host resolves survivors with np.searchsorted, verifies k = c +- j
  exactly with ref/ecref, and rescans a step exactly when the cascade
  overflowed or the walk state became invalid.

Every giant step covers `stride` keys, so keys/s = steps/s * U * stride.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.log import get_logger
from ..curve import pwalk, tables
from ..field import fe
from ..filter import bitmap as bmp
from ..filter import host_table as ht
from ..ref import ecref
from .common import (Deadline, FoundKey, SearchStats, summary_to_host,
                     verify_candidate_scalar)

BUILD_BLOCKS = 128  # baby blocks of build_block keys per streaming-build step
CHUNK_WORD_CAP = 1 << 27  # bound on T*K*U query words per chunk


def resolve_m(m_babies: "int | None" = None, n_value: "int | None" = None,
              k_factor: int = 1) -> int:
    """Reference BSGS table sizing: m = sqrt(N)*k, N defaulting to 2^44 and
    required to be a perfect square; an explicit m_babies overrides."""
    if m_babies is not None:
        return m_babies
    n_val = n_value if n_value is not None else (1 << 44)
    r = math.isqrt(n_val)
    if r * r != n_val:
        raise ValueError(
            f"-n value 0x{n_val:x} must have an exact integer square root"
        )
    return r * max(1, k_factor)


@dataclass(frozen=True)
class BSGSParams:
    """The host-resolve subset of keyhuntm1cpu_tpu's BSGSParams."""

    m: int = 1 << 20  # baby steps
    block_u: int = 1024  # giant centers per device step (U)
    steps_per_chunk: int = 16  # K: device steps per chunk
    build_block: int = 4096  # baby keys per walk row in the filter build
    chunk_cand_max: int = 1024  # floor of the cascade budgets C1, C2
    bits_log2: Optional[int] = None  # bitmap size (None: see _filter_sizes)
    pipeline_depth: int = 8  # chunks in flight ahead of host decode
    bloom2_bits: Optional[int] = None  # bloom2 size (None: see _filter_sizes)
    table_cache: Optional[str] = None  # host-table cache dir override


def filter_build_step(px, py, tx, ty, ax, ay, adv_tab, K: int, ub: int, words1,
                      bits_log2: int, words2, b2bits: int, n_keep: int, bad):
    """One step of the streaming filter build: K1 and K2 walk K*ub baby keys
    from the base (px, py) ((1, 8) limbs) by the step table (tx, ty) and ADV
    (ax, ay; adv_tab its multiples); K3 ORs the first n_keep into both
    filters and adds the kept lanes' degenerate flags and the advance flags
    to `bad` (a () int64 tensor). Three device operations. Returns the next
    base."""
    res = pwalk.chunk_multi(px, py, tx, ty, ax, ay, K=K, U=ub, T=1, adv_tab=adv_tab)
    bmp.insert_keys(words1, bits_log2, words2, b2bits, res.qhi.reshape(-1),
                    res.qlo.reshape(-1), n_keep, res.degenerate.reshape(-1),
                    res.adv_degenerate.reshape(-1), bad)
    return res.next_x, res.next_y


class _ImmediateHit(Exception):
    def __init__(self, scalar: int):
        self.scalar = scalar


def _limbs(v: int, device) -> torch.Tensor:
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32)).to(device)


def chunk_impl_host(px, py, tab_x, tab_y, adv_x, adv_y, bitmap, bloom2,
                    *, U: int, K: int, T: int, C1: int, C2: int, adv_tab=None):
    """One host-resolve chunk (bsgs._pallas_chunk_impl_host): walk, cascade,
    packed summary. Returns (next_x, next_y, summary (3*C2+3*T*K+1,) int32).
    adv_tab: pwalk.adv_multiples(ADV, K), built per call when None.
    No host sync: the summary stays on the device until the caller copies it."""
    res = pwalk.chunk_multi(px, py, tab_x, tab_y, adv_x, adv_y, K=K, U=U, T=T,
                            adv_tab=adv_tab)
    adv_flat = res.adv_degenerate.reshape(-1)  # (T*K,)
    deg = res.degenerate
    # adv degenerate == walk lane U degenerate (ADV = U*S = tab[U-1]); fresh
    # tensor from the walk, updated in place
    deg[:, U - 1] |= adv_flat
    fs = bmp.filtered_survivors(bitmap, res.qhi.reshape(-1), res.qlo.reshape(-1),
                                C2, bm2=bloom2, stage1_max=C1)
    B = T * K * U
    live = ~deg.reshape(-1)[fs.pos.clamp(max=B - 1).long()]
    cand_pos = torch.where((fs.pos < B) & live, fs.pos, B)
    deg8 = deg.to(torch.uint8)
    degsum = torch.stack([deg8.sum(dim=1, dtype=torch.int32),
                          deg8.argmax(dim=1).to(torch.int32),
                          adv_flat.to(torch.int32)])
    out = torch.cat([cand_pos, fs.qhi, fs.qlo, degsum.reshape(-1),
                     fs.n_candidates.reshape(1)])
    return res.next_x, res.next_y, out


class BSGSEngine:
    """Single-device BSGS search in host-resolve mode."""

    def __init__(self, pubkeys: Sequence[Tuple[int, int]], range_start: int,
                 range_end: int, params: BSGSParams = BSGSParams(),
                 device="cuda", host_table: "ht.HostTable | None" = None,
                 bitmap: "bmp.DeviceBitmap | None" = None,
                 bloom2: "bmp.DeviceBloom2 | None" = None):
        if not (1 <= range_start < range_end <= ecref.N):
            raise ValueError("bad range")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.targets = list(pubkeys)
        self.a = range_start
        self.b = range_end
        self.p = params
        self.stats = SearchStats()
        m = params.m
        self.stride = 2 * m
        n_centers = max(1, math.ceil((self.b - self.a) / self.stride))
        self.n_steps = math.ceil(n_centers / params.block_u)

        U = params.block_u
        s_pt = ecref.point_neg(ecref.scalar_mult(self.stride))  # S = -(stride)*G
        tab_x, tab_y = tables.step_table(s_pt, U)
        self.tab_x = pwalk.table_to_limb_major(tab_x, self.device)
        self.tab_y = pwalk.table_to_limb_major(tab_y, self.device)
        big = ecref.point_neg(ecref.scalar_mult(U * self.stride))  # U*S
        self.adv_x = _limbs(big[0], self.device)
        self.adv_y = _limbs(big[1], self.device)

        if host_table is None:
            host_table = ht.ensure_host_table(
                m, params.table_cache or ht.DEFAULT_CACHE_DIR)
        if host_table.m != m:
            raise ValueError(f"host table m={host_table.m} != params.m={m}")
        self.host_table = host_table
        if bitmap is not None and bloom2 is not None:
            self.bitmap, self.bloom2 = bitmap, bloom2
        else:
            self.bitmap, self.bloom2 = self._build_filters_streaming(
                *self._filter_sizes())

        T, K = len(self.targets), params.steps_per_chunk
        if T * K * U > CHUNK_WORD_CAP:
            k_new = max(1, CHUNK_WORD_CAP // (T * U))
            if k_new < K:
                get_logger().warn(
                    f"multi-target chunk would need {T}*{K}*{U} query words; "
                    f"shrinking steps_per_chunk {K} -> {k_new} to bound "
                    "device memory")
                self.p = dataclasses.replace(self.p, steps_per_chunk=k_new)
        self.C1, self.C2 = self._cascade_budgets(
            T * self.p.steps_per_chunk * U)
        self.adv_tab = pwalk.adv_multiples(big, self.p.steps_per_chunk, self.device)

    # ------------------------------------------------------------------
    # streaming filter build
    # ------------------------------------------------------------------

    def _filter_sizes(self) -> Tuple[int, int]:
        """(bitmap bits, bloom2 bits). Defaults follow the JAX engine on the
        matching backend: its accelerator path pins both at 2^35 bits (4 GiB
        each, load 1/8 even at m = 2^31); its CPU path sizes them from m."""
        p = self.p
        if self.device.type == "cuda":
            bits, b2 = 35, 35
        else:
            bits, b2 = bmp.default_bits_log2(p.m), bmp.bloom2_bits_log2_host(p.m)
        return (p.bits_log2 if p.bits_log2 is not None else bits,
                p.bloom2_bits if p.bloom2_bits is not None else b2)

    def _build_filters_streaming(self, bits_log2: int, b2bits: int):
        """Bitmap + bloom2 over j = 1..m, built on the device with no m-sized
        key planes: keys 1..2*Ub come from the native exact walk; blocks
        t >= 2 are walked by K1/K2 from base (2*Ub)*G with ADV = Ub*G and
        ORed into both filters by K3, BUILD_BLOCKS blocks per step. Base
        (2*Ub)*G is degeneracy-free (a lane would need t*Ub == +-u, u <= Ub);
        that is checked once per slice of KEYHUNT_STREAM_SLICE steps. Key
        indices are python ints / int64, so any m the table supports works."""
        p, dev = self.p, self.device
        m, ub = p.m, p.build_block
        words1 = bmp.empty_filter(bits_log2, dev)
        words2 = bmp.empty_filter(b2bits, dev)

        n_seed = min(2 * ub, m)
        seed = ht.native_keys_range(1, n_seed)
        shi = torch.from_numpy((seed >> np.uint64(32)).astype(np.uint32).view(np.int32))
        slo = torch.from_numpy(seed.astype(np.uint32).view(np.int32))
        bmp.insert_keys(words1, bits_log2, words2, b2bits, shi.to(dev), slo.to(dev), n_seed)

        rest = m - 2 * ub
        if rest > 0:
            btab_x, btab_y = tables.step_table(ecref.G, ub)
            tx = pwalk.table_to_limb_major(btab_x, dev)
            ty = pwalk.table_to_limb_major(btab_y, dev)
            adv = ecref.scalar_mult(ub)
            ax, ay = _limbs(adv[0], dev), _limbs(adv[1], dev)
            base = ecref.scalar_mult(2 * ub)
            px, py = _limbs(base[0], dev)[None], _limbs(base[1], dev)[None]
            K = min(BUILD_BLOCKS, -(-rest // ub))
            adv_tab = pwalk.adv_multiples(adv, K, dev)
            KU = K * ub
            n_iter = -(-rest // KU)
            slice_iters = max(1, int(os.environ.get("KEYHUNT_STREAM_SLICE", 256)))
            bad = torch.zeros((), dtype=torch.int64, device=dev)
            t0 = time.time()
            for it in range(n_iter):
                # key j = 2*Ub + it*KU + lane + 1 <= m: the step keeps a prefix
                px, py = filter_build_step(px, py, tx, ty, ax, ay, adv_tab, K, ub, words1,
                                           bits_log2, words2, b2bits,
                                           min(KU, rest - it * KU), bad)
                if (it + 1) % slice_iters == 0 or it + 1 == n_iter:
                    if int(bad) != 0:
                        raise RuntimeError(
                            "degenerate walk lane in the streaming filter "
                            "build (impossible for base >= 2*Ub*G)")
                    if n_iter > slice_iters:
                        print(f"[build] filter stream {it + 1}/{n_iter} steps "
                              f"({time.time() - t0:.1f}s)", flush=True)
        return (bmp.DeviceBitmap(words1, bits_log2),
                bmp.DeviceBloom2(words2, b2bits))

    # ------------------------------------------------------------------
    # giant-step search
    # ------------------------------------------------------------------

    def _cascade_budgets(self, n_queries: int) -> Tuple[int, int]:
        """(C1, C2): mean + 8*sqrt(mean) + 512 rounded up to 512, floored at
        chunk_cand_max, for expected stage-1 (B*m/2^bits) and stage-2
        (stage-1 * bloom2_fp) survivors; overflow is safe (host rescan)."""
        p = self.p
        expected = max(1, n_queries * p.m // (1 << self.bitmap.bits_log2))

        def budget(mean: int) -> int:
            need = mean + 8 * int(mean ** 0.5) + 512
            return ((need + 511) // 512) * 512

        C1 = max(p.chunk_cand_max, budget(expected))
        fp2 = bmp.bloom2_fp(p.m, self.bloom2.bits_log2)
        C2 = max(p.chunk_cand_max, budget(int(expected * fp2) + 1))
        return C1, C2

    def _initial_base(self, step0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """P_base(s=step0) per target (host-exact), as (T, 8) limb tensors."""
        c_base = self.a + self.p.m + (step0 * self.p.block_u - 1) * self.stride
        offset = ecref.scalar_mult((-c_base) % ecref.N)
        pts = [ecref.point_add(q, offset) for q in self.targets]
        if any(pt is None for pt in pts):
            raise _ImmediateHit(c_base)  # Q == c_base*G: the base IS a key
        px = np.stack([fe.int_to_limbs(pt[0]) for pt in pts]).view(np.int32)
        py = np.stack([fe.int_to_limbs(pt[1]) for pt in pts]).view(np.int32)
        return (torch.from_numpy(px).to(self.device),
                torch.from_numpy(py).to(self.device))

    def _chunk_fn(self, px, py):
        p = self.p
        return chunk_impl_host(
            px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y,
            self.bitmap, self.bloom2, U=p.block_u, K=p.steps_per_chunk,
            T=len(self.targets), C1=self.C1, C2=self.C2, adv_tab=self.adv_tab)

    def _consume_summary(self, step0: int, k: int, arr: np.ndarray):
        """Decode one chunk's summary -> (found, rebase, interesting)."""
        p = self.p
        C2 = self.C2
        K = p.steps_per_chunk
        U = p.block_u
        T = len(self.targets)
        B = T * K * U
        cand_pos = arr[:C2]
        qhi = arr[C2 : 2 * C2].view(np.uint32)
        qlo = arr[2 * C2 : 3 * C2].view(np.uint32)
        degsum = arr[3 * C2 : 3 * C2 + 3 * T * K].reshape(3, T, K)
        ncand = int(arr[3 * C2 + 3 * T * K])
        found: List[FoundKey] = []
        interesting = False
        if ncand > C2:
            interesting = True
            for s_ in range(k):  # cascade overflow: exact host rescan
                found += self._host_rescan_step(step0 + s_)
        # steps after a mid-chunk advance degeneracy hold garbage walk state
        adv_any = degsum[2, :, :k].any(axis=0)  # (k,)
        adv_first = int(np.argmax(adv_any)) if adv_any.any() else k
        for s_ in range(adv_first + 1, k):
            interesting = True
            found += self._host_rescan_step(step0 + s_)
        valid = cand_pos < B
        if valid.any():
            rows, js = self.host_table.resolve(qhi[valid], qlo[valid])
            vpos = cand_pos[valid]
            for r, j in zip(rows.tolist(), js.tolist()):
                blk, u0 = divmod(int(vpos[r]), U)
                t, s_ = divmod(blk, K)
                if s_ >= k:
                    continue
                interesting = True
                found += self._try_candidates(
                    self._candidates_for_hit(step0 + s_, u0 + 1, int(j)), t)
        for t, s_ in zip(*np.nonzero(degsum[0, :, :k] > 0)):
            interesting = True
            u = int(degsum[1, t, s_]) + 1
            found += self._try_candidates(
                self._candidates_for_degenerate(step0 + int(s_), u), int(t))
        return found, bool(adv_any.any()), interesting

    def _center(self, step: int, u: int) -> int:
        """Center scalar for device step `step`, offset u in 1..U."""
        return self.a + self.p.m + (step * self.p.block_u + u - 1) * self.stride

    def _candidates_for_hit(self, step: int, u: int, baby: int) -> List[int]:
        c = self._center(step, u)
        return [c - baby, c + baby]

    def _candidates_for_degenerate(self, step: int, u: int) -> List[int]:
        c_base = self._center(step, 0)  # = c_{sU} - stride
        return [c_base - u * self.stride, c_base + u * self.stride]

    def search(self, max_steps: Optional[int] = None, start_step: int = 0,
               stop_on_first: bool = True, progress_every: int = 0,
               max_seconds: Optional[float] = None) -> List[FoundKey]:
        """Run the giant-step scan in order; returns verified found keys.

        Up to pipeline_depth chunks are in flight: the walk state chains on
        the device and only summaries come back. max_seconds stops dispatch
        at the first chunk boundary past the deadline; in-flight chunks are
        drained, so stats stay exact."""
        p = self.p
        dl = Deadline(max_seconds)
        remaining = self.n_steps - start_step
        total = remaining if max_steps is None else min(remaining, max_steps)
        end_step = start_step + total
        K = p.steps_per_chunk

        found: List[FoundKey] = []
        base = None
        while base is None:
            try:
                base = self._initial_base(start_step)
            except _ImmediateHit as hit:
                # the base center itself is a target key: record it, rescan
                # the chunk anchored there exactly, move to the next chunk
                found += self._try_candidates_all([hit.scalar])
                if found and stop_on_first:
                    return self._dedupe_found(found)
                for s_ in range(start_step, min(start_step + K, end_step)):
                    found += self._host_rescan_step(s_)
                self.stats.add(min(K, end_step - start_step) * p.block_u * self.stride)
                if found and stop_on_first:
                    return self._dedupe_found(found)
                start_step += K
                if start_step >= end_step:
                    return self._dedupe_found(found)
        px, py = base

        pending: deque = deque()
        disp = start_step
        n_done = 0
        while pending or disp < end_step:
            while (disp < end_step and len(pending) < p.pipeline_depth
                   and not dl.expired()):
                px, py, outs = self._chunk_fn(px, py)
                pending.append((disp, summary_to_host(outs)))
                disp += K
            if not pending:
                break  # deadline cut dispatch with nothing in flight
            step, (host, ev) = pending.popleft()
            if ev is not None:
                ev.synchronize()
            k = min(K, end_step - step)
            new_found, rebase, _ = self._consume_summary(step, k, host.numpy())
            if new_found:
                found = self._dedupe_found(found + new_found)
                if stop_on_first:
                    self.stats.add(k * p.block_u * self.stride)
                    return found
            self.stats.add(k * p.block_u * self.stride)
            n_done += 1
            if rebase and step + K < end_step:
                # an advance lane degenerated mid-chunk: the walk state past
                # it is invalid — drop later chunks and restart exactly
                pending.clear()
                disp = step + K
                try:
                    px, py = self._initial_base(disp)
                except _ImmediateHit as hit:
                    found += self._try_candidates_all([hit.scalar])
                    if found and stop_on_first:
                        return self._dedupe_found(found)
                    while disp < end_step:
                        for s_ in range(disp, min(disp + K, end_step)):
                            found += self._host_rescan_step(s_)
                        self.stats.add(min(K, end_step - disp) * p.block_u * self.stride)
                        if found and stop_on_first:
                            return self._dedupe_found(found)
                        disp += K
                        try:
                            px, py = self._initial_base(disp)
                            break
                        except _ImmediateHit as hit2:
                            found += self._try_candidates_all([hit2.scalar])
            if progress_every and n_done % progress_every == 0:
                print(f"[bsgs] step {step + K}/{end_step} {self.stats.human()}")
        return self._dedupe_found(found)

    @staticmethod
    def _dedupe_found(found: List[FoundKey]) -> List[FoundKey]:
        seen: Dict[Tuple[int, str], FoundKey] = {}
        for f in found:
            seen[(f.private_key, f.target)] = f
        return list(seen.values())

    def _host_rescan_step(self, step: int) -> List[FoundKey]:
        """Exact host scan of one device step (the cascade-overflow and
        invalid-walk fallback): python-int walk of U points per target,
        then one vectorised searchsorted."""
        keys, payload = self.host_table.keys, self.host_table.idx
        found: List[FoundKey] = []
        U = self.p.block_u
        neg_stride = ecref.point_neg(ecref.scalar_mult(self.stride))
        mask64 = (1 << 64) - 1
        for t, q in enumerate(self.targets):
            c0 = self._center(step, 1)
            c = c0
            pt = ecref.point_add(q, ecref.scalar_mult((-c) % ecref.N))
            xs = np.zeros(U, dtype=np.uint64)
            for u in range(U):
                if pt is None:  # Q == c*G exactly
                    found += self._try_candidates([c], t)
                    pt = neg_stride
                else:
                    xs[u] = pt[0] & mask64
                    pt = ecref.point_add(pt, neg_stride)
                c += self.stride
            left = np.searchsorted(keys, xs, side="left")
            right = np.searchsorted(keys, xs, side="right")
            for u in np.nonzero(right > left)[0]:
                cu = c0 + int(u) * self.stride
                for p_ in range(int(left[u]), int(right[u])):
                    j = int(payload[p_]) + 1
                    found += self._try_candidates([cu - j, cu + j], t)
        return found

    def _try_candidates_all(self, cands: Sequence[int]) -> List[FoundKey]:
        """Verify candidates against EVERY target (base-center collisions
        carry no target id)."""
        out: List[FoundKey] = []
        for t in range(len(self.targets)):
            out += self._try_candidates(cands, t)
        return out

    def _try_candidates(self, cands: Sequence[int], t: int = 0) -> List[FoundKey]:
        """Exact verification; keys outside [a, b] are dropped (the last
        block's centers tile past range_end)."""
        seen: Dict[int, FoundKey] = {}
        for cand in cands:
            k = verify_candidate_scalar(cand, self.targets[t])
            if k is not None and self.a <= k <= self.b:
                seen[k] = FoundKey(private_key=k, pubkey=self.targets[t],
                                   target=f"{self.targets[t][0]:064x}")
        return list(seen.values())
