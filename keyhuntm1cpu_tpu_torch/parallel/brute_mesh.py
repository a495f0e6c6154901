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

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import Checkpoint, fingerprint
from ..engine.brute import BruteEngine, BruteParams
from ..engine.common import Deadline, FoundKey, SearchStats, summary_to_host
from ..utils.targets import TargetSet
from .mesh import resolve_devices
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
        """Each child's chunk base at local step `step`. A base at infinity
        needs a slice boundary on a multiple of the group order: impossible
        inside [1, n)."""
        out = []
        for c in self.children:
            px, py = c._fast_base(step)
            if px is None:  # pragma: no cover - see docstring
                raise ValueError("chunk base at infinity (range touches n)")
            out.append((px, py))
        return out

    def _sharded_chunk(self, bases):
        """One fused chunk of every child -> (next bases, (host tensor,
        event)): the D summaries and their summed interest."""
        p = self.p
        K, U, C = p.steps_per_chunk, p.block_u, p.chunk_cand
        nxt, outs = [], []
        for (px, py), c in zip(bases, self.children):
            nx, ny, out = c._fused_chunk(px, py)
            nxt.append((nx, ny))
            outs.append(out)
        d0 = self.devices[0]
        packed = torch.stack([o.to(d0, non_blocking=True) for o in outs])
        interest = ((packed[:, :C] < K * U).sum(dtype=torch.int32)
                    + packed[:, 2 * C: 2 * C + K].sum(dtype=torch.int32)
                    + packed[:, 2 * C + 2 * K: 2 * C + 3 * K].sum(dtype=torch.int32)
                    + (packed[:, 2 * C + 3 * K] > C).sum(dtype=torch.int32))
        return nxt, summary_to_host(torch.cat([packed.reshape(-1), interest.reshape(1)]))

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

    def _ckpt_load(self, checkpoint):
        """Load or create the position checkpoint -> (ck, local steps done):
        local device steps decoded in dispatch order, an exact coverage
        mark across every shard."""
        p = self.p
        c0 = self.children[0]
        params_fp = fingerprint(c0.mode, p.block_u, p.steps_per_chunk, p.stride, p.endo,
                                self.n_shards)
        targets_fp = fingerprint(sorted(c0.targets.raw), sorted(c0.intervals),
                                 sorted(c0.prefixes))
        a, b = self.slices[0].start, self.slices[-1].end
        ck = checkpoint.load()
        if ck is not None:
            checkpoint.matches(ck, mode=f"brute-sharded:{c0.mode}", range_start=a,
                               range_end=b, policy="sequential", seed=p.seed,
                               params_fp=params_fp, targets_fp=targets_fp)
            self.stats.resume(ck.keys_covered)
            return ck, ck.chunks_done
        return Checkpoint(mode=f"brute-sharded:{c0.mode}", range_start=a, range_end=b,
                          policy="sequential", seed=p.seed, params_fp=params_fp,
                          targets_fp=targets_fp), 0

    def search_sharded(self, max_steps: Optional[int] = None, stop_on_first: bool = False,
                       progress_every: int = 0, max_seconds: Optional[float] = None,
                       checkpoint=None) -> List[FoundKey]:
        """The pipelined sharded search (the JAX engine's): up to
        pipeline_depth sharded chunks in flight; only chunks with a
        non-zero interest are decoded. A child whose advance chain
        degenerated has the rest of its chunk rescanned on the host, and
        every child is rebased at the next chunk."""
        p = self.p
        self.stats.begin()
        dl = Deadline(max_seconds)
        K, U, D = p.steps_per_chunk, p.block_u, self.n_shards
        total = self.local_steps if max_steps is None else min(self.local_steps, max_steps)
        found: List[FoundKey] = []
        seen = set()
        ck, resumed = (None, 0) if checkpoint is None else self._ckpt_load(checkpoint)

        def take(fks) -> bool:
            new = False
            for fk in fks:
                if fk and fk.private_key not in seen:
                    seen.add(fk.private_key)
                    found.append(fk)
                    new = True
            return new

        if resumed == 0:  # keys of the lattice-shift edge come before local step 0
            for c in self.children:
                for k0 in c._fast_prefix:
                    take([c._verify(k0, 0)])
            if found and stop_on_first:
                return found
        else:  # the keys the interrupted run saved: resume skips their chunks
            take(self.children[0]._reverify_saved(ck, found))

        disp = min(resumed, total)
        bases = self._bases_at(disp) if disp < total else None
        pending: deque = deque()
        n_done = 0
        last_units = disp
        while pending or disp < total:
            while disp < total and len(pending) < p.pipeline_depth and not dl.expired():
                bases, out = self._sharded_chunk(bases)
                pending.append((disp, out))
                disp += K
            if not pending:
                break  # the deadline cut dispatch with nothing in flight
            step, (host, ev) = pending.popleft()
            if ev is not None:
                ev.synchronize()
            k = min(K, total - step)
            rebase = new_any = False
            arr = host.numpy()
            if int(arr[-1]) > 0:
                new_found, rebase = self._decode_sharded(arr[:-1].reshape(D, -1), step, k)
                new_any = take(new_found)
            self.stats.add(sum(max(0, min(k, c._fast_total_steps - step))
                               for c in self.children) * U)
            n_done += 1
            done_all = not pending and disp >= total
            BruteEngine._ckpt_save(checkpoint, ck, step + k, self.stats, found, new_any,
                                   force=done_all or bool(found and stop_on_first))
            if found and stop_on_first:
                return found
            last_units = step + k
            if rebase and step + K < total:
                pending.clear()
                disp = step + K
                bases = self._bases_at(disp)
            if progress_every and n_done % progress_every == 0:
                print(f"[brute-sharded] local step {step + K}/{total} {self.stats.human()}")
        if ck is not None and n_done:
            # a deadline or stop-flag cut: save the exactly covered position
            BruteEngine._ckpt_save(checkpoint, ck, last_units, self.stats, found, False,
                                   force=True)
        return found
