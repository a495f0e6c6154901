"""Multi-device BSGS: the range, or the baby table itself, sharded over a
list of devices.

Port of keyhuntm1cpu_tpu/parallel/mesh.py. The JAX engines are one
process over its local devices (shard_map over jax.devices(), psum and
all_gather over ICI); these are one process over a list of torch devices,
every visible card by default (``resolve_devices``). A device may repeat:
``[cuda:0] * 4`` runs the same code as four cards and holds one copy of
each resident structure a distinct device.

- ``ShardedBSGSEngine``: each shard owns one window-aligned RangeSlice and
  walks it from its own state; a sharded chunk is each shard's
  single-device ``chunk_impl`` on its device (K1 + K2 + cascade + exact
  search, one summary), their interest scalars (live survivors, degenerate
  lanes, overflow: the JAX psum) summed on the first device and copied to
  the host with the summaries in one asynchronous copy. Only interesting
  chunks are decoded, each shard's summary by the single-device decoder at
  its slice's global step.
- ``ShardedTableBSGSEngine``: the sorted baby table is cut into D
  contiguous row shards (its bitmap and bloom2 built per shard, on the
  shard's device), so m scales with the device count. Every shard walks;
  with ``table_comm="all_gather"`` each prober probes the D shards'
  concatenated queries against its own table shard; with ``"ring"`` it
  probes one source's block a hop for D hops, the next hop's copy (between
  distinct cards) on a side stream. Hits are disjoint across table shards,
  and positions live in the source-major global query space, so both
  schedules give one summary layout and one decoder.

A documented difference: the JAX mesh scans its XLA walk K times with one
(3C + 3T + 1) summary a step; a shard here runs the single-device chunk
with one (3*C2 + 3*T*K + 1) summary a chunk. The keys found, the keys
covered and the checkpoint positions are the same.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.checkpoint import fingerprint
from ..core.metrics import current_call, spanned
from ..engine import pipeline
from ..engine.bsgs import (BSGSEngine, BSGSParams, _BSGSPlan, _chunk_walk, chunk_impl,
                           chunk_summary, device_budgets, write_table)
from ..engine.common import FoundKey, summary_to_host
from ..filter import bitmap as bmp
from ..filter import sorted_table as st
from .partition import RangePartitioner, RangeSlice

_PAD_KEY = (1 << 63) - 1  # the flipped key of trunc64 = 2^64 - 1: sorts last
# BSGSEngine's set-up without its own span: a sharded engine's one
# engine_init span covers it and the shards' copies
_bsgs_init = BSGSEngine.__init__.__wrapped__


def resolve_devices(devices=None) -> List[torch.device]:
    """The shards' devices: `devices` (names or torch.device, repeats
    allowed) or, when None, every visible card. A CUDA device without an
    index means the current one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass devices=[cpu, ...] "
                               "to shard on the CPU)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {d} requested but no CUDA device is available")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}")
        out.append(d)
    if not out:
        raise ValueError("no devices to shard over")
    return out


def default_devices(kind: str = "cuda", n: Optional[int] = None) -> List[torch.device]:
    """n shards over the visible devices of a kind, round robin (every
    visible card, or one CPU shard, when n is None)."""
    n_vis = torch.cuda.device_count() if kind == "cuda" else 1
    if kind == "cuda" and n_vis == 0:
        raise RuntimeError("no CUDA device is available")
    n = n_vis if n is None else n
    if n < 1:
        raise ValueError("the number of devices must be >= 1")
    return resolve_devices([f"cuda:{i % n_vis}" if kind == "cuda" else "cpu"
                            for i in range(n)])


class _Filters(NamedTuple):
    """A range shard's bitmap, table and bloom2 on its device."""
    bitmap: bmp.DeviceBitmap
    table: st.SortedXTable
    bloom2: Optional[bmp.DeviceBloom2]


def gather_to_host(outs: List[torch.Tensor], B: int, C: int, *rows: slice):
    """The D summaries stacked on the first one's device, their interest
    summed over the shards as one more word (live survivors: positions < B
    among the first C words; the words of `rows`; overflows: a last word
    > C), in one asynchronous host copy -> (host tensor, event)."""
    packed = torch.stack([o.to(outs[0].device, non_blocking=True) for o in outs])
    interest = ((packed[:, :C] < B).sum(dtype=torch.int32)
                + (packed[:, -1] > C).sum(dtype=torch.int32)
                + sum(packed[:, r].sum(dtype=torch.int32) for r in rows))
    return summary_to_host(torch.cat([packed.reshape(-1), interest.reshape(1)]))


class ShardedBSGSEngine(BSGSEngine):
    """BSGS with the range sharded over a list of devices (device resolve)."""

    @spanned("engine_init")
    def __init__(self, pubkeys: Sequence[Tuple[int, int]], range_start: int,
                 range_end: int, params: BSGSParams = BSGSParams(),
                 table: "st.SortedXTable | None" = None, devices=None,
                 bitmap: "bmp.DeviceBitmap | None" = None):
        """devices: see resolve_devices. table and bitmap, when given, are
        shared (copied only to the other distinct devices)."""
        if params.resolve != "device":
            raise ValueError("the sharded engines resolve on the device: each device "
                             "holds its own table (resolve='host' is single-device)")
        devs = resolve_devices(devices)
        _bsgs_init(self, pubkeys, range_start, range_end, params, device=devs[0], table=table,
                   bitmap=bitmap)
        # the shards' constants and filters on their cards
        self._set_shards(devs, range_start, range_end)
        b2 = self.bloom2
        self._filters = {d: _Filters(
            bmp.DeviceBitmap(self.bitmap.words.to(d), self.bitmap.bits_log2),
            st.SortedXTable(self.table.key.to(d), self.table.idx.to(d)),
            None if b2 is None else bmp.DeviceBloom2(b2.words.to(d), b2.bits_log2))
            for d in dict.fromkeys(devs)}

    def _set_shards(self, devs: List[torch.device], a: int, b: int) -> None:
        self.devices = devs
        self.n_shards = len(devs)
        window = self.p.block_u * self.stride
        self.slices: List[RangeSlice] = RangePartitioner.split_equal(a, b, self.n_shards, window)
        self.local_steps = max(1, math.ceil(max(1, math.ceil((b - a) / window))
                                            / self.n_shards))
        # the walk constants, once a distinct device (.to: no copy where they are)
        self._walk = {d: self.walk.to(d) for d in dict.fromkeys(devs)}

    def _bases_at(self, step: int):
        """[(px, py)] of each shard at local step `step`, on its device;
        raises _ImmediateHit where a shard's base center is a key."""
        return [tuple(t.to(d) for t in self._initial_base(sl.step0 + step))
                for sl, d in zip(self.slices, self.devices)]

    def _sharded_chunk(self, bases):
        """One chunk of every shard -> (next bases, (host tensor, event)):
        the D summaries and their summed interest, copied to the host in
        one asynchronous copy from the first device. Spans: a dispatch a
        card (its index), the copy."""
        p = self.p
        T, K, U = len(self.targets), p.steps_per_chunk, p.block_u
        tr = current_call()
        nxt, outs = [], []
        for card, ((px, py), d) in enumerate(zip(bases, self.devices)):
            w, f = self._walk[d], self._filters[d]
            with tr.span("dispatch", card):
                tr.device_start(d, card)
                nx, ny, out = chunk_impl(px, py, w.tab_x, w.tab_y, w.adv_x, w.adv_y, f.bitmap,
                                         f.table, f.bloom2, U=U, K=K, T=T, C1=self.C1,
                                         C2=self.C2, adv_tab=w.adv_tab,
                                         pair_tab=w.pair_tab)
                tr.device_end(d, card)
            nxt.append((nx, ny))
            outs.append(out)
        with tr.span("copy"):
            return nxt, self._to_host(outs, T * K * U)

    def _to_host(self, outs: List[torch.Tensor], B: int):
        C2, TK = self.C2, len(self.targets) * self.p.steps_per_chunk
        return gather_to_host(outs, B, C2, slice(3 * C2, 3 * C2 + TK))  # rows: degenerate lanes

    def _decode_sharded(self, arr: np.ndarray, step: int, k: int):
        """(found, rebase) from the (D, summary) array of one chunk: each
        shard's summary through the single-device decoder at its slice's
        global step (it rescans the steps after an advance degeneracy)."""
        found: List[FoundKey] = []
        rebase = False
        for d, sl in enumerate(self.slices):
            f, adv, _ = self._consume_summary(sl.step0 + step, k, arr[d])
            found += f
            rebase |= adv
        return found, rebase


    def search_sharded(self, max_steps: Optional[int] = None, stop_on_first: bool = True,
                       progress_every: int = 0, max_seconds: Optional[float] = None,
                       checkpoint=None) -> List[FoundKey]:
        """The pipelined sharded search (the JAX engine's search_sharded)
        in engine/pipeline.py's loop; only chunks of non-zero interest are
        decoded. The shards advance in lock step, so a checkpoint counts
        decoded chunks of K local steps."""
        p = self.p
        K = p.steps_per_chunk
        plan = _MeshPlan(self, self.local_steps if max_steps is None
                         else min(self.local_steps, max_steps))
        if checkpoint is not None:
            # n_shards is part of the run's identity: the step -> key map
            # goes through the slices
            ck = pipeline.open_checkpoint(
                plan, checkpoint, self.stats,
                dict(mode="bsgs-sharded", range_start=self.a, range_end=self.b,
                     policy="sequential", seed=0,
                     params_fp=fingerprint(p.m, p.block_u, K, self.n_shards, type(self).__name__),
                     targets_fp=fingerprint(sorted(self.targets))), n_chunks=plan.n_chunks)
            if ck is not None:
                plan.step = ck.chunks_done * K
                # the keys the interrupted run saved: resume skips their chunks
                plan.found0 = self._try_candidates_all([int(h, 16) for h in ck.found])
        return pipeline.run("search_sharded", plan, stop_on_first, max_seconds, progress_every)


class _MeshPlan(pipeline.ShardedPlan):
    label = "bsgs-sharded"
    found_key = staticmethod(_BSGSPlan.found_key)

    def keys(self, step: int) -> int:
        eng = self.eng
        return min(self.K, self.total - step) * eng.n_shards * eng.p.block_u * eng.stride

    def on_host(self, step: int, scalar: int):
        """A shard's base center is a key: the chunk of every shard,
        rescanned on the host."""
        eng, k = self.eng, min(self.K, self.total - step)
        rescan = [f for sl in eng.slices for s_ in range(sl.step0 + step, sl.step0 + step + k)
                  for f in eng._host_rescan_step(s_)]
        return eng._try_candidates_all([scalar]) + rescan, self.keys(step)

    def mark(self, ck, step: int, n_done: int) -> None:
        ck.chunks_done = step // self.K + 1


class ShardedTableBSGSEngine(ShardedBSGSEngine):
    """BSGS with the baby table, its bitmap and its bloom2 sharded over the
    devices: shard d holds rows [d*rows, (d+1)*rows) of the sorted table
    (rows = ceil(m / D), the last shard padded with the max key and payload
    0, which the decoder ignores) and filters sized for its rows. No device
    holds the whole table: the exact host rescan and -S read a host copy
    assembled from the shards."""

    @spanned("engine_init")
    def __init__(self, pubkeys: Sequence[Tuple[int, int]], range_start: int,
                 range_end: int, params: BSGSParams = BSGSParams(),
                 table: "st.SortedXTable | None" = None, devices=None):
        if params.table_comm not in ("all_gather", "ring"):
            raise ValueError(f"table_comm must be all_gather or ring, got {params.table_comm!r}")
        if params.resolve != "device":
            raise ValueError("the sharded engines resolve on the device: each device "
                             "holds its own table (resolve='host' is single-device)")
        devs = resolve_devices(devices)
        # no global bitmap: the parent gets a stand-in (_size_cascade builds
        # nothing from it)
        dummy = bmp.DeviceBitmap(torch.zeros(1, dtype=torch.int32, device=devs[0]), 5)
        _bsgs_init(self, pubkeys, range_start, range_end, params, device=devs[0],
                   table=table, bitmap=dummy)
        self._set_shards(devs, range_start, range_end)
        self._shard_structures(self.table)
        self.table = None  # the shards hold it now

    def _size_cascade(self, n_queries: int) -> None:
        """Sized per shard in _shard_structures, not over the whole table."""
        self.C1 = self.C2 = None
        self.bloom2 = None

    def search(self, *a, **kw):
        raise NotImplementedError("ShardedTableBSGSEngine has no single-device search (the "
                                  "table lives sharded across the devices): use "
                                  "search_sharded()")

    search_scheduled = search

    def _shard_structures(self, table: st.SortedXTable) -> None:
        """Cut the sorted table into D contiguous row shards (sorted order:
        contiguous key ranges), each on its device, and build each shard's
        bitmap (and bloom2 where the cascade needs it) there, sized for its
        rows as the JAX engine sizes them. A shard is a view of the table
        when every shard lives on the table's device, else a copy."""
        D, p = self.n_shards, self.p
        m = table.key.shape[0]
        rows = -(-m // D)
        views = all(d == table.key.device for d in self.devices)
        self.shards: List[st.SortedXTable] = []
        for s, d in enumerate(self.devices):
            key, idx = table.key[s * rows: (s + 1) * rows], table.idx[s * rows: (s + 1) * rows]
            if key.shape[0] < rows:  # the padded last shard (or an empty one)
                pad = rows - key.shape[0]
                key = torch.cat([key.to(d), torch.full((pad,), _PAD_KEY, dtype=torch.int64,
                                                       device=d)])
                idx = torch.cat([idx.to(d), torch.zeros(pad, dtype=torch.int32, device=d)])
            elif not views:
                key, idx = key.to(d, copy=True), idx.to(d, copy=True)
            self.shards.append(st.SortedXTable(key, idx))
        self.rows, self.m_table = rows, m
        self.shard_bits = p.bits_log2 if p.bits_log2 is not None else bmp.default_bits_log2(rows)
        self.shard_bitmaps = [bmp.build_bitmap_device(t, self.shard_bits) for t in self.shards]
        T, K, U = len(self.targets), p.steps_per_chunk, p.block_u
        # every prober probes all D sources' queries against its rows
        C1_all, self.C2, use2 = device_budgets(D * T * K * U, rows, self.shard_bits, p)
        self.shard_expected = D * T * K * U * rows // (1 << self.shard_bits)
        self._use_bloom2 = use2
        if use2:
            self.shard_b2_bits = bmp.bloom2_bits_log2(rows)
            self.shard_blooms = [bmp.build_bloom2_device(t, self.shard_b2_bits)
                                 for t in self.shards]
            # the JAX engine's stage-1 width; the ring probes a 1/D block a hop
            exp = self.shard_expected
            exp = max(1, exp // D) if p.table_comm == "ring" else exp
            self.C1 = max(self.C2, ((exp + 8 * int(exp ** 0.5) + 511) // 512) * 512)
        else:
            self.shard_blooms = [None] * D
            self.C1 = C1_all
        self._side = {}  # the ring's copy stream of each distinct card, made on first use

    def _host_table(self) -> st.SortedXTable:
        """The whole table on the host, assembled from the shards."""
        m = self.m_table
        return st.SortedXTable(torch.cat([t.key.cpu() for t in self.shards])[:m],
                               torch.cat([t.idx.cpu() for t in self.shards])[:m])

    def _rescan_table(self):
        if self._host_keys is None:
            tab = self._host_table()
            self._host_keys = (tab.key.numpy().view(np.uint64) ^ np.uint64(1 << 63),
                               tab.idx.numpy().view(np.uint32), 0)
        return self._host_keys

    def save_table(self, path: str) -> None:
        """Write the table (from its shards) as the JAX package's table file."""
        write_table(path, self._host_table())

    def _probe(self, e: int, qhi, qlo, deg, adv, C1: int, rows=None):
        """Prober e's cascade over flat queries (their (n, U) degenerate and
        (n,) advance flags beside them) and the summary of its live
        candidates (engine/bsgs.py chunk_summary): positions (B = n*U where
        none), j, j2, then with rows = (deg, adv) of the prober's own walk
        its row words, then the count. On the card: the level-1 probe, the
        bloom2 stage and the summary kernel."""
        fs = bmp.filtered_survivors(self.shard_bitmaps[e], qhi, qlo, self.C2,
                                    bm2=self.shard_blooms[e], stage1_max=C1)
        return chunk_summary(self.shards[e], *fs, deg, adv, rows)

    def _sharded_chunk(self, bases):
        """Spans: a dispatch a card (its walk), one for the probers (no
        card), the copy."""
        p = self.p
        T, K, U, D = len(self.targets), p.steps_per_chunk, p.block_u, self.n_shards
        B = T * K * U
        tr = current_call()
        nxt, blocks = [], []
        for card, ((px, py), d) in enumerate(zip(bases, self.devices)):
            w = self._walk[d]
            with tr.span("dispatch", card):
                res, deg, adv_flat = _chunk_walk(px, py, w.tab_x, w.tab_y, w.adv_x, w.adv_y,
                                                 U, K, T, w.adv_tab, pair_tab=w.pair_tab)
            nxt.append((res.next_x, res.next_y))
            blocks.append((res.qhi.reshape(-1), res.qlo.reshape(-1), deg, adv_flat))
        probe = self._ring if p.table_comm == "ring" else self._all_gather
        with tr.span("dispatch"):
            summaries = probe(blocks, B)
        with tr.span("copy"):
            return nxt, self._to_host(summaries, D * B)

    def _all_gather(self, blocks, B: int):
        """Every prober probes the D sources' queries, concatenated in
        source order on its device (once a distinct device); one summary
        launch a prober writes its candidates and its own walk's rows."""
        gathered = {}
        out = []
        for e, d in enumerate(self.devices):
            if d not in gathered:
                gathered[d] = [torch.cat([blk[i].to(d, non_blocking=True) for blk in blocks])
                               for i in range(4)]
            out.append(self._probe(e, *gathered[d], self.C1, rows=blocks[e][2:]))
        return out

    def _fetch(self, blocks, r: int):
        """The blocks the probers take in hop r, block (e - r) mod D for
        prober e: the source's own tensors on the same device; else copies
        on the prober card's side stream, with an event to wait on."""
        D, out = self.n_shards, []
        for e, d in enumerate(self.devices):
            blk = blocks[(e - r) % D]
            if blk[0].device == d:
                out.append((blk, None))
                continue
            side = self._side.setdefault(d, torch.cuda.Stream(d))
            with torch.cuda.stream(side):
                cp = tuple(t.to(d, non_blocking=True) for t in blk)
                ev = torch.cuda.Event()
                ev.record(side)
            out.append((cp, ev))
        return out

    def _ring(self, blocks, B: int):
        """D hops; in hop r prober e probes the block that originated at
        shard (e - r) mod D, while the next hop's copies run on the side
        streams. Each prober's (D, C2) hits are compacted at the end; its
        count is the larger of its hops' counts and its hits; a summary
        launch without candidates writes its own walk's rows and the count."""
        D, C2 = self.n_shards, self.C2
        C1 = self.C1
        acc = [[] for _ in range(D)]
        nxt = self._fetch(blocks, 0)
        for r in range(D):
            cur, nxt = nxt, (self._fetch(blocks, r + 1) if r + 1 < D else None)
            for e, (blk, ev) in enumerate(cur):
                if ev is not None:
                    main = torch.cuda.current_stream(self.devices[e])
                    main.wait_event(ev)
                    for t in blk:
                        t.record_stream(main)
                hop = self._probe(e, *blk, C1)
                gpos, j, j2 = hop[:3 * C2].view(3, C2)
                origin = (e - r) % D
                acc[e].append((torch.where(gpos < B, origin * B + gpos, D * B), j, j2,
                               hop[3 * C2]))
        out = []
        for e in range(D):
            gpos, j, j2, n = (torch.stack(x) for x in zip(*acc[e]))
            flat = gpos.reshape(-1)
            hit = flat < D * B
            sel = bmp.compact_positions(hit, C2, D * C2)
            ok = sel < D * C2
            safe = sel.clamp(max=D * C2 - 1).long()
            deg, adv = blocks[e][2:]
            row = torch.empty((3 * C2 + 3 * deg.shape[0] + 1,), dtype=torch.int32,
                              device=deg.device)
            torch.stack([torch.where(ok, flat[safe], D * B),
                         torch.where(ok, j.reshape(-1)[safe], 0),
                         torch.where(ok, j2.reshape(-1)[safe], 0)], out=row[:3 * C2].view(3, C2))
            none = torch.empty((0,), dtype=torch.int32, device=deg.device)
            chunk_summary(self.shards[e], none, none, none,
                          torch.maximum(n.max(), hit.sum(dtype=torch.int32)), deg, adv,
                          (deg, adv), row[3 * C2:])
            out.append(row)
        return out

    def _decode_sharded(self, arr: np.ndarray, step: int, k: int):
        """(found, rebase) from the (D prober, summary) array of one chunk.
        Candidate positions are in the global source-major query space, and
        the degenerate rows are the prober's own walk's (prober = source):
        each prober's row goes through the single-device decoder once a
        source, with that source's candidates, at its slice's global step
        (an overflow rescans every source's steps)."""
        B = len(self.targets) * self.p.steps_per_chunk * self.p.block_u
        C2, found, rebase = self.C2, [], False
        for prober, row in enumerate(arr):
            pos = row[:C2]
            for d, sl in enumerate(self.slices):
                part = row.copy()
                part[:C2] = np.where((pos >= d * B) & (pos < (d + 1) * B), pos - d * B, B)
                if d != prober:
                    part[3 * C2:-1] = 0
                f, adv, _ = self._consume_summary(sl.step0 + step, k, part)
                found += f
                rebase |= adv
        return found, rebase
