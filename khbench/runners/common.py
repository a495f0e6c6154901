"""What every runner shares: the run's context, the window around an
engine's search, and the outcome handed back to khbench.run."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..card_clock import CardClock
from ..trace import Recorder
from ..generator import Inputs

STATE_SAMPLES = 8  # chunks whose handed-on walk state the reference checks
CANDIDATE_SAMPLES = 128  # brute candidates the reference recomputes
TABLE_SAMPLES = 64  # baby-table rows the reference recomputes
STATE_CHUNKS = 256  # sampled states come from the window's first chunks


class Refused(Exception):
    """A layout the run cannot measure, refused in set-up: run.py prints
    why and no result, and exits non-zero."""


@dataclass
class Ctx:
    cfg: dict  # the configuration file
    inputs: Inputs  # what the traffic mix and the seed made
    seed: int
    seconds: float
    trace: bool
    devices: List  # torch devices, one a chip
    fault: Optional[str] = None  # a broken timed path (khbench.faults), for controls
    card_clock: bool = False  # time the card by the profiler around the window
    marks: Dict[str, float] = field(default_factory=dict)  # perf_counter marks
    undo: List = field(default_factory=list)  # what puts a fault's patches back
    card: Optional[CardClock] = None  # the window's card clock, once it ran

    def mark(self, name: str) -> None:
        """Note the end of a set-up stage (host seconds since the run began
        go to the run's readings)."""
        self.marks[name] = time.perf_counter()

    def rng(self, salt: str) -> random.Random:
        """A generator for the checks' samples, drawn from the seed."""
        return random.Random(f"{self.seed}:{salt}")


@dataclass
class Outcome:
    keys: int  # keys covered in the window, times the mode's multiplier
    wall_s: float  # the window: the search call until it returned
    checks: Dict[str, float]  # the numbers compared, by name
    attempted: int  # chunks decoded in the window
    failed: int  # items found wrong by the checks
    memory_peak_bytes: int
    readings: dict  # what the per-layer readers read (trace, shapes, clocks)


def sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def memory_peak(devices) -> int:
    import torch

    return max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)


def window(ctx: Ctx, rec: Recorder, search) -> tuple:
    """The measured window: search() from its call until it returns
    (its in-flight chunks drained). Returns (result, wall seconds). With
    ctx.card_clock the profiler runs around it (started in set-up)."""
    sync(ctx.devices)
    ctx.card = CardClock(ctx.card_clock, ctx.devices)
    ctx.card.start()
    rec.start()
    ctx.marks["window"] = rec.t0
    out = search()
    rec.stop()
    ctx.card.stop()
    return out, rec.t1 - rec.t0


def limbs(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint32)


def state_sample(ctx: Ctx) -> set:
    """The window's first two chunks and more drawn from its first
    STATE_CHUNKS."""
    r = ctx.rng("states")
    return {0, 1} | {r.randrange(STATE_CHUNKS) for _ in range(STATE_SAMPLES)}


def timed_s(fn, devices):
    """(fn(), host seconds until the devices finished it)."""
    t = time.perf_counter()
    out = fn()
    sync(devices)
    return out, time.perf_counter() - t


def hook_chunks(ctx: Ctx, eng, rec: Recorder, device) -> Dict[int, tuple]:
    """Set a span, with a device interval, on the instance's chunk
    dispatch; returns {chunk: (next x, next y)}, the walk state each
    sampled chunk of the window hands on."""
    keep, states, fn, n = state_sample(ctx), {}, eng._chunk_fn, [0]

    def chunk(px, py):
        i = n[0]
        n[0] += 1
        nx, ny, out = rec.dispatch_call(fn, (px, py), pair_device=device)
        if i in keep:
            states[i] = (nx, ny)
        return nx, ny, out

    eng._chunk_fn = chunk
    return states


def hook_decode(eng, name: str, rec: Recorder, seen) -> None:
    """Set a span on the instance's summary decode `name`, and hand each
    summary's arguments to seen() after it."""
    fn = getattr(eng, name)

    def decode(*args):
        res = rec.decode_call(fn, args)
        seen(*args)
        return res

    setattr(eng, name, decode)


def failed(checks: Dict[str, float]) -> int:
    """Items the exact checks found wrong."""
    return sum(int(v) for k, v in checks.items() if k != "survivor_rate_gap")
