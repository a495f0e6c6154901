"""Multi-device brute force: the range sharded over a list of devices.

Port of keyhuntm1cpu_tpu/parallel/brute_mesh.py. The range is cut into
window-aligned slices, one a device (resolve_devices: every visible card
by default, repeats allowed); each slice belongs to a child BruteEngine on
its device that runs the fused chunk (K1 advance chain, K4 walk + hash +
membership, kh_compact_hits) from its own base. Children on one device
share its target words, bucket table and step tables
(BruteEngine.for_range). A sharded chunk is every child's chunk; their
interest scalars (hits, degenerate lanes, advance flags, overflow: the JAX
psum) are summed on the first device and copied to the host with the
summaries in one asynchronous copy, and only interesting chunks are
decoded, each child's summary by its own decoder.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import fingerprint
from ..core.metrics import current_call
from ..engine import pipeline
from ..engine.brute import BruteEngine, BruteParams
from ..engine.common import FoundKey, SearchStats
from ..utils.targets import TargetSet
from .mesh import gather_to_host, resolve_devices
from .partition import RangePartitioner


class ShardedBruteEngine:
    """Brute modes with the range sharded over a list of devices. The
    children take the fused path (at most compare_max + bucket_max targets,
    block_u a multiple of 128)."""

    def __init__(self, targets: TargetSet, range_start: int, range_end: int,
                 mode: str = "rmd160", params: BruteParams = BruteParams(),
                 devices=None, intervals=None, prefixes=None):
        if params.random_mode:
            raise ValueError(
                "random mode (-R) is not available on the sharded brute "
                "mesh: shards scan their slices sequentially (use "
                "unsharded -R, or dist/ workers for randomized fleets)")
        self.devices = resolve_devices(devices)
        self.n_shards = len(self.devices)
        self.p = params
        window = params.block_u * params.stride
        self.slices = RangePartitioner.split_equal(range_start, range_end, self.n_shards, window)
        # one child a slice (split_equal never yields an empty slice; a
        # shard past the last window repeats it and its hits dedupe)
        first = {}
        self.children: List[BruteEngine] = []
        for sl, d in zip(self.slices, self.devices):
            if d in first:
                self.children.append(first[d].for_range(sl.start, sl.end))
                continue
            c = BruteEngine(targets, sl.start, sl.end, mode=mode, params=params, device=d,
                            intervals=intervals, prefixes=prefixes)
            if c._walker:
                raise ValueError("the sharded brute engine needs the fused path (at most "
                                 f"{params.compare_max} + {params.bucket_max} targets, "
                                 "block_u a multiple of 128)")
            first[d] = c
            self.children.append(c)
        self.stats = SearchStats()
        self.stats.multiplier = self.children[0].stats.multiplier
        self.local_steps = max(c._fast_total_steps for c in self.children)

    def _bases_at(self, step: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each child's chunk base at local step `step` (never at infinity:
        that needs a slice boundary on a multiple of the group order)."""
        return [c._fast_base(step) for c in self.children]

    def _sharded_chunk(self, bases):
        """One fused chunk of every child -> (next bases, (host tensor,
        event)): the D summaries and their summed interest. Spans: a
        dispatch a card (its index), the copy."""
        p = self.p
        K, U, C = p.steps_per_chunk, p.block_u, p.chunk_cand
        tr = current_call()
        nxt, outs = [], []
        for card, ((px, py), c) in enumerate(zip(bases, self.children)):
            with tr.span("dispatch", card):
                tr.device_start(c.device, card)
                nx, ny, out = c._fused_chunk(px, py)
                tr.device_end(c.device, card)
            nxt.append((nx, ny))
            outs.append(out)
        with tr.span("copy"):  # rows: degenerate lanes, advance flags
            return nxt, gather_to_host(outs, K * U, C, slice(2 * C, 2 * C + K),
                                       slice(2 * C + 2 * K, 2 * C + 3 * K))

    def _decode_sharded(self, arr: np.ndarray, step: int, k: int):
        """(found, rebase) from the (D, summary) array of one chunk, each
        child's summary by its own decoder. A child whose advance chain
        degenerated walked invalid state for the rest of its chunk: that is
        rescanned on the host, and every child rebases at the next chunk."""
        found: List[FoundKey] = []
        rebase = False
        for d, c in enumerate(self.children):
            k_eff, f = c._decode_fast(step, arr[d])
            found += f
            if k_eff < k:
                found += c._host_rescan_fast(step + k_eff, k - k_eff)
                rebase = True
        return found, rebase

    def search_sharded(self, max_steps: Optional[int] = None, stop_on_first: bool = False,
                       progress_every: int = 0, max_seconds: Optional[float] = None,
                       checkpoint=None) -> List[FoundKey]:
        """The pipelined sharded search (the JAX engine's) in
        engine/pipeline.py's loop; only chunks of non-zero interest are
        decoded. A checkpoint counts local device steps decoded in order,
        an exact coverage mark across every shard."""
        p, c0 = self.p, self.children[0]
        plan = _BruteMeshPlan(self, self.local_steps if max_steps is None
                              else min(self.local_steps, max_steps))
        ck = None
        if checkpoint is not None:
            ck = pipeline.open_checkpoint(plan, checkpoint, self.stats, dict(
                mode=f"brute-sharded:{c0.mode}", range_start=self.slices[0].start,
                range_end=self.slices[-1].end, policy="sequential", seed=p.seed,
                params_fp=fingerprint(c0.mode, p.block_u, p.steps_per_chunk, p.stride, p.endo,
                                      self.n_shards),
                targets_fp=fingerprint(sorted(c0.targets.raw), sorted(c0.intervals),
                                       sorted(c0.prefixes))))
        if ck is not None and ck.chunks_done:
            # the keys the interrupted run saved: resume skips their chunks
            plan.found0 = c0._reverify_saved(ck)
            plan.step = min(ck.chunks_done, plan.total)
        else:  # keys of the lattice-shift edge come before local step 0
            plan.found0 = [f for c in self.children for f in map(c._verify, c._fast_prefix) if f]
        return pipeline.run("search_sharded", plan, stop_on_first, max_seconds, progress_every)


class _BruteMeshPlan(pipeline.ShardedPlan):
    label = "brute-sharded"

    def keys(self, step: int) -> int:
        k = min(self.K, self.total - step)
        return sum(max(0, min(k, c._fast_total_steps - step))
                   for c in self.eng.children) * self.eng.p.block_u

    def mark(self, ck, step: int, n_done: int) -> None:
        ck.chunks_done = step + min(self.K, self.total - step)
