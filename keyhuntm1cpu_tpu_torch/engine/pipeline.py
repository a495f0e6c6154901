"""The one pipelined chunk loop behind every search entry: an entry
describes its chunks as a ChunkPlan, and ``run`` does the rest once for
all (chunks in flight, the deadline and the drain, spans and counters,
found keys, SearchStats, stop_on_first, restarts, a base at a key, the
checkpoint's cadence, the progress line)."""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from ..core.checkpoint import Checkpoint
from ..core.metrics import SearchCall, get_metrics
from .common import Deadline, FoundKey, summary_to_host


class BaseIsKey(Exception):
    """A chunk the card does not walk: its base center is a target's key
    (scalar), or its base is the point at infinity (None)."""

    def __init__(self, scalar: Optional[int] = None):
        self.scalar = scalar


def base_or_hit(fn, *args):
    """fn(*args), or the BaseIsKey it raised."""
    try:
        return fn(*args)
    except BaseIsKey as hit:
        return hit


class ChunkPlan:
    """What an entry tells the loop: ``eng`` (its stats and devices);
    ``next()`` -> (the next chunk's id, its position), None when done;
    ``exact(pos)``, its exact base or a BaseIsKey; ``dispatch(pos, base)``
    -> the device summary (``device`` None: its host copy and event, spans
    inside); ``decode(pos, arr)`` -> (found, keys covered, a position to
    restart from or None), or ``keys(pos)`` where the ``quiet_word`` of
    the summary is 0; ``on_host(pos, scalar)`` -> (found, keys);
    ``restart(pos)``; ``mark``, the checkpoint's position."""

    label = "search"  # the progress line's tag
    device = None  # the card of a one-card plan
    depth = 1  # chunks in flight
    n_chunks: Optional[int] = None  # chunks this call may decode
    quiet_word: Optional[int] = None  # a summary word 0 where nothing is to decode
    found0: List[FoundKey] = []  # keys known before the first chunk
    ck = mgr = None  # the Checkpoint this call keeps and its manager
    chain = None  # (chunk id, state) the last chunk dispatched leaves on the card

    @staticmethod
    def found_key(f: FoundKey):  # what makes two found keys one
        return f.private_key

    def base(self, cid, pos):
        """The card's state where the chunk follows the last one, else exact."""
        chain, self.chain = self.chain, None
        if chain is not None and chain[0] == cid:
            return chain[1]
        return self.exact(pos)

    def restart(self, step: int) -> None:  # go on from `step`, an exact base
        self.step, self.chain = step, (step, self.exact(step))

    def mark(self, ck, pos, n_done: int) -> None:
        ck.chunks_done = n_done


def run(loop: str, plan: ChunkPlan, stop_on_first: bool, max_seconds: Optional[float] = None,
        progress_every: int = 0) -> List[FoundKey]:
    """Drive `plan` to its end, the deadline (each chunk dispatched is
    decoded and counted) or, stop_on_first, a chunk with a new key, in a
    core.metrics SearchCall named `loop`; returns the found keys."""
    eng = plan.eng
    with SearchCall(get_metrics(), loop, eng.stats,
                    getattr(eng, "devices", None) or [eng.device]) as tr:
        return _drive(tr, plan, stop_on_first, max_seconds, progress_every)


def _drive(tr: SearchCall, plan: ChunkPlan, stop_on_first: bool, max_seconds,
           progress_every: int) -> List[FoundKey]:
    # a chunk's host work paces the card in BSGS: few calls a chunk here
    dispatch, copy, wait, decode = (tr.span(n) for n in ("dispatch", "copy", "wait", "decode"))
    stats, key_of, quiet = tr.stats, plan.found_key, plan.quiet_word
    dl = Deadline(max_seconds)
    found: Dict[object, FoundKey] = {}
    for f in plan.found0:
        found.setdefault(key_of(f), f)
    if found and stop_on_first:
        return list(found.values())
    ck, pending, n_done, cut = plan.ck, deque(), 0, False
    while True:
        while len(pending) < plan.depth:
            cut = dl.expired()
            nxt = None if cut else plan.next()
            if nxt is None:
                break
            tr.chunk, pos = nxt
            state = plan.base(*nxt)
            if isinstance(state, BaseIsKey):
                pending.append((tr.chunk, pos, state))
            elif plan.device is None:
                pending.append((tr.chunk, pos, plan.dispatch(pos, state)))
            else:
                with dispatch:
                    tr.device_start(plan.device)
                    out = plan.dispatch(pos, state)
                with copy:
                    pending.append((tr.chunk, pos, summary_to_host(out)))
        if not pending:
            break
        tr.chunk, pos, out = pending.popleft()
        restart = None
        if isinstance(out, BaseIsKey):
            # the base center is a key: recorded, the chunk rescanned on the host
            new, keys = plan.on_host(pos, out.scalar)
        else:
            host, ev = out
            with wait:
                if ev is not None:
                    ev.synchronize()
            tr.device_done(ev)
            arr = host.numpy()
            if quiet is not None and not arr[quiet]:
                new, keys = (), plan.keys(pos)
            else:
                with decode:
                    new, keys, restart = plan.decode(pos, arr)
            tr.count("chunks_decoded")
        fresh = False
        for f in new:
            if key_of(f) not in found:
                found[key_of(f)] = f
                fresh = True
        stats.add(keys)
        n_done += 1
        if ck is not None:
            plan.mark(ck, pos, n_done)
            ck.keys_covered = stats.keys_covered
            if fresh:  # saved at once: a resumed run skips this chunk
                ck.found = sorted(set(ck.found) | {f"{f.private_key:x}" for f in found.values()})
            plan.mgr.save(ck, force=fresh)
        if fresh and stop_on_first:
            break
        if restart is not None:
            # the walk state past this chunk is invalid: drop the chunks
            # dispatched after it, restart exactly
            pending.clear()
            tr.count("rebases")
            with tr.span("rebase"):
                plan.restart(restart)
        if progress_every and n_done % progress_every == 0:
            of = "" if plan.n_chunks is None else f"/{plan.n_chunks}"
            print(f"[{plan.label}] chunk {n_done}{of} {stats.human()}")
    if ck is not None and (n_done or cut):
        plan.mgr.save(ck, force=True)  # the exactly covered position
    return list(found.values())


def open_checkpoint(plan: ChunkPlan, mgr, stats, match: dict, **new) -> Optional[Checkpoint]:
    """plan.ck: mgr's saved checkpoint, which must match `match` (its keys
    count as covered; returned), or a new one of match and `new`."""
    plan.mgr, plan.ck = mgr, mgr.load()
    if plan.ck is None:
        plan.ck = Checkpoint(**match, **new)
        return None
    mgr.matches(plan.ck, **match)
    stats.resume(plan.ck.keys_covered)
    return plan.ck


class ShardedPlan(ChunkPlan):
    """A sharded search's chunks: K local steps of every shard in lock step
    to `total`, by the engine's _bases_at, _sharded_chunk and
    _decode_sharded (a chunk of non-zero interest, its last word, only)."""

    def __init__(self, eng, total: int):
        self.eng, self.total, self.step = eng, total, 0
        self.K, self.depth = eng.p.steps_per_chunk, eng.p.pipeline_depth
        self.n_chunks = -(-total // self.K)

    quiet_word = -1  # the interest summed over the shards

    def next(self):
        if self.step >= self.total:
            return None
        self.step += self.K
        return self.step - self.K, self.step - self.K

    def exact(self, step: int):
        return base_or_hit(self.eng._bases_at, step)

    def dispatch(self, step: int, bases):
        nxt, out = self.eng._sharded_chunk(bases)
        self.chain = (step + self.K, nxt)
        return out

    def decode(self, step: int, arr):
        k = min(self.K, self.total - step)
        found, rebase = self.eng._decode_sharded(arr[:-1].reshape(self.eng.n_shards, -1), step, k)
        nxt = step + self.K
        return found, self.keys(step), nxt if rebase and nxt < self.total else None
