"""Per-mode gated benches: bench_modes.py's sections on the port's engines.

Each section first passes a bit-exact recovery gate (planted keys must be
found), then measures its rate at the production shapes, which are the
defaults. Shapes, ranges and seconds are keyword arguments, so a CPU run
can take each section small with the same planted keys. A section
returns {"keys_per_sec": float, "gate": "ok"}; a gate that fails raises
GateError and the section reports no rate.

Differences from the JAX sections, each deliberate:
- the TPU knobs pallas_sb and pallas="on" are gone (BruteParams has
  neither), and so is gate_only, which no caller passes;
- a rate window runs for `seconds` (the engine's max_seconds) instead of
  a chunk count sized from the TPU's chunk time (bench_modes.py:74, :183);
  the rate is computed from the keys covered, as there;
- a window that covers no keys raises instead of reporting 0.

Effective keys/s = keys covered x stats.multiplier / wall seconds
(bench_modes.py:80); the BSGS sections count the range covered,
chunks x K x U x stride / wall seconds (bench.py:174-175).
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import time
from collections import deque
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .engine.brute import BruteEngine, BruteParams
from .engine.bsgs import BSGSEngine, BSGSParams
from .engine.common import summary_to_host
from .engine.minikeys import LOW_SPAN, MinikeyEngine, _b58_digits, tuned_params
from .engine.vanity import vanity_intervals
from .ref import ecref, hashref
from .utils.targets import TargetSet, targets_from_ints

BRUTE_RANGE = (1 << 40, (1 << 40) + (1 << 50))  # every brute rate window's range
GATE_KEYS = tuple(range(1, 33))  # planted in every brute gate
GATE_RANGE = (1, 4097)  # the brute gates' range
GATE_SHAPE = (256, 4)  # (U, K) of the brute and vanity gates
BUCKET_GATE_SHAPE = (1024, 4)  # (U, K) of the T = 4096 gate
RATE_SHAPE = (16384, 256)  # (U, K) of every brute rate window
GATE_CAND = 64  # chunk_cand of the gates
N_BUCKETED = 4096  # targets of the bucketed section: GATE_KEYS and decoys
MINIKEY_PREFIX = "Sbenchmark1x"
MINIKEY_COUNTER = 1 << 31  # where the minikeys rate window starts
VANITY_KEY = 777  # whose 5-character address prefix the vanity section seeks
VANITY_GATE_RANGE = (1, 2049)
T16_SEED = 16  # default_rng seed of the 16 planted BSGS keys
T16_STEPS = (8, 32)  # K of the bsgs_t16 gate and rate window
PIPELINE_DEPTH = 8  # chunks in flight in a BSGS window (bench.py:165)
MODE_KIND = {"rmd160": "hash160", "xpoint": "xpoint", "eth": "eth", "address_u": "hash160"}


class GateError(RuntimeError):
    """A planted key was not recovered: the section reports no rate."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def effective_keys_per_sec(keys_covered: int, multiplier: int, seconds: float) -> float:
    """bench_modes.py:80."""
    return keys_covered * multiplier / seconds


def range_keys_per_sec(chunks: int, steps: int, block_u: int, stride: int,
                       seconds: float) -> float:
    """bench.py:174-175: every giant step covers `stride` keys."""
    return chunks * steps * block_u * stride / seconds


# ----------------------------------------------------------------------
# the gates' inputs
# ----------------------------------------------------------------------

def artifact(mode: str, pt) -> bytes:
    """The target bytes a brute mode compares for point pt (bench_modes._mk)."""
    if mode == "xpoint":
        return pt[0].to_bytes(32, "big")
    if mode == "eth":
        return hashref.pubkey_to_eth_address(pt)
    return hashref.pubkey_to_hash160(pt, compressed=mode == "rmd160")


def gate_targets(mode: str, n_total: int = len(GATE_KEYS)) -> TargetSet:
    """GATE_KEYS' artifacts, padded to n_total targets with the bench's
    decoys (sha256 of "bench-decoy<i>", 20 bytes)."""
    raw = [artifact(mode, ecref.scalar_mult(k)) for k in GATE_KEYS]
    labels = [str(k) for k in GATE_KEYS]
    n_dec = n_total - len(GATE_KEYS)
    raw += [hashlib.sha256(f"bench-decoy{i}".encode()).digest()[:20] for i in range(n_dec)]
    labels += [f"d{i}" for i in range(n_dec)]
    return TargetSet(kind=MODE_KIND[mode], raw=raw, labels=labels)


def t16_planted(params: BSGSParams, a: int = 1 << 63) -> Tuple[List[int], int]:
    """(the 16 planted keys, window): default_rng(16) draws inside one
    gate chunk's window of T16_STEPS[0] * U * 2m keys from a."""
    window = T16_STEPS[0] * params.block_u * 2 * params.m
    rng = np.random.default_rng(T16_SEED)
    # int(v) first: np.int64 + a overflows at a = 2^63
    return sorted(a + int(v) for v in rng.integers(0, min(window, 1 << 63), size=16)), window


def first_minikey(prefix: str = MINIKEY_PREFIX) -> Tuple[int, str, int]:
    """(counter, minikey, private key) of the first valid minikey of the
    prefix's counter scan."""
    for c in range(1 << 18):
        s = prefix + _b58_digits(c // LOW_SPAN, 5) + _b58_digits(c % LOW_SPAN, 5)
        if hashref.sha256((s + "?").encode())[0] == 0:
            return c, s, int.from_bytes(hashref.sha256(s.encode()), "big")
    raise GateError(f"no valid minikey in the first 2^18 of {prefix!r}")


def vanity_prefix(key: int = VANITY_KEY) -> str:
    """The first 5 characters of key's compressed P2PKH address."""
    return hashref.pubkey_to_address(ecref.scalar_mult(key), compressed=True)[:5]


# ----------------------------------------------------------------------
# windows
# ----------------------------------------------------------------------

def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wait(copy) -> None:
    host, ev = copy
    if ev is not None:
        ev.synchronize()


def warm_chunk(eng: BSGSEngine):
    """One chunk from the range's base, waited for; returns the walk state
    after it."""
    px, py = eng._initial_base(0)
    px, py, outs = eng._chunk_fn(px, py)
    _wait(summary_to_host(outs))
    return px, py


def chunk_window(eng: BSGSEngine, px, py, seconds: float,
                 depth: int = PIPELINE_DEPTH) -> Tuple[int, float, Optional[float]]:
    """bench.py's throughput loop (:156-170) from walk state (px, py):
    chunks dispatched for `seconds`, each summary copied to the host
    (summary_to_host: pinned memory and an event) with at most `depth`
    copies waited behind, and no decode. Returns (chunks, wall seconds,
    device idle share): on CUDA a timing event pair around each chunk's
    work on the stream, idle = 1 - busy / (first start to last end);
    None on the CPU."""
    cuda = eng.device.type == "cuda"
    marks = []
    inflight: deque = deque()
    chunks = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        px, py, outs = eng._chunk_fn(px, py)
        if cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            marks.append((e0, e1))
        inflight.append(summary_to_host(outs))
        if len(inflight) > depth:
            _wait(inflight.popleft())
        chunks += 1
    while inflight:
        _wait(inflight.popleft())
    elapsed = time.time() - t0
    if not chunks:
        raise RuntimeError(f"the {seconds} s window ran no chunk")
    idle = None
    if marks:
        sync(eng.device)
        busy = sum(a.elapsed_time(b) for a, b in marks)
        span = marks[0][0].elapsed_time(marks[-1][1])
        idle = 1 - busy / span if span > 0 else 0.0
    return chunks, elapsed, idle


def _search_rate(eng, seconds: float, warm, window) -> float:
    """Effective keys/s of window() after warm(): keys covered times the
    engine's multiplier over the wall seconds."""
    warm()
    k0 = eng.stats.keys_covered
    sync(eng.device)
    t0 = time.time()
    window()
    sync(eng.device)
    dt = time.time() - t0
    keys = eng.stats.keys_covered - k0
    if keys <= 0:
        raise RuntimeError(f"the {seconds} s rate window covered no keys")
    return effective_keys_per_sec(keys, eng.stats.multiplier, dt)


def _brute_rate(eng: BruteEngine, seconds: float) -> float:
    return _search_rate(eng, seconds, lambda: eng.search(max_steps=eng.p.steps_per_chunk),
                        lambda: eng.search(max_seconds=seconds))


def _check_found(name: str, planted, got) -> None:
    missing = [k for k in planted if k not in set(got)]
    if missing:
        raise GateError(f"{name} gate FAILED: missing {missing}")


# ----------------------------------------------------------------------
# sections
# ----------------------------------------------------------------------

def iter_brute_modes(seconds: float = 5.0, device="cuda", *,
                     gate_shape=GATE_SHAPE, rate_shape=RATE_SHAPE,
                     rate_range=BRUTE_RANGE) -> Iterator[Tuple[str, dict]]:
    """rmd160, xpoint, eth, address_u on the fused path (bench_modes.py:39-83):
    keys 1..32 over [1, 4097), then the rate at rate_shape over
    rate_range. Yields (mode, result) after each section."""
    for mode in MODE_KIND:
        ts = gate_targets(mode)
        gate = BruteParams(block_u=gate_shape[0], steps_per_chunk=gate_shape[1],
                           chunk_cand=GATE_CAND)
        eng = BruteEngine(ts, *GATE_RANGE, mode=mode, params=gate, device=device)
        _check_found(mode, GATE_KEYS, [f.private_key for f in eng.search(stop_on_first=False)])
        log(f"[gate] {mode}: keys 1..32 recovered bit-exact")
        params = BruteParams(block_u=rate_shape[0], steps_per_chunk=rate_shape[1])
        eng = BruteEngine(ts, *rate_range, mode=mode, params=params, device=device)
        eff = _brute_rate(eng, seconds)
        log(f"[bench] {mode}: {eff / 1e6:.1f}M keys/s effective (mult {eng.stats.multiplier})")
        yield mode, {"keys_per_sec": eff, "gate": "ok"}


def iter_brute_variants(seconds: float = 5.0, device="cuda", *,
                        bucket_gate_shape=BUCKET_GATE_SHAPE, rate_shape=RATE_SHAPE,
                        rate_range=BRUTE_RANGE) -> Iterator[Tuple[str, dict]]:
    """rmd160 -e (its rate under the rmd160 gate) and rmd160 at T = 4096,
    whose gate asserts the bucketed path (bench_modes.py:86-151)."""
    ts = gate_targets("rmd160")
    params = BruteParams(block_u=rate_shape[0], steps_per_chunk=rate_shape[1], endo=True)
    eng = BruteEngine(ts, *rate_range, mode="rmd160", params=params, device=device)
    eff = _brute_rate(eng, seconds)
    log(f"[bench] rmd160 -e: {eff / 1e6:.1f}M keys/s effective (mult {eng.stats.multiplier})")
    yield "rmd160_endo", {"keys_per_sec": eff, "gate": "ok (rmd160 gate)"}

    ts = gate_targets("rmd160", N_BUCKETED)
    gate = BruteParams(block_u=bucket_gate_shape[0], steps_per_chunk=bucket_gate_shape[1],
                       chunk_cand=GATE_CAND)
    eng = BruteEngine(ts, *GATE_RANGE, mode="rmd160", params=gate, device=device)
    if not eng._bucketed:
        raise GateError("rmd160_T4096 gate FAILED: T=4096 did not take the bucketed path")
    _check_found("rmd160_T4096", GATE_KEYS,
                 [f.private_key for f in eng.search(stop_on_first=False)])
    log(f"[gate] rmd160 T=4096 bucketed ({eng._n_bucket_rows} rows): keys 1..32 recovered "
        "bit-exact")
    params = BruteParams(block_u=rate_shape[0], steps_per_chunk=rate_shape[1])
    eng = BruteEngine(ts, *rate_range, mode="rmd160", params=params, device=device)
    eff = _brute_rate(eng, seconds)
    log(f"[bench] rmd160 T=4096: {eff / 1e6:.1f}M keys/s effective")
    yield "rmd160_T4096", {"keys_per_sec": eff, "gate": "ok"}


def bench_minikeys(seconds: float = 5.0, device="cuda", *,
                   batch: Optional[int] = None) -> dict:
    """The first valid minikey of "Sbenchmark1x" found in one chunk, then
    minikeys/s from counter 2^31 (bench_modes.py:154-191). batch: the
    chunk's minikeys (None: tuned_params' for the device)."""
    _, mk, k = first_minikey()
    ts = targets_from_ints(
        "hash160", [hashref.pubkey_to_hash160(ecref.scalar_mult(k), compressed=False)])
    eng = MinikeyEngine(ts, prefix=MINIKEY_PREFIX, params=tuned_params(batch, device),
                        device=device)
    found = eng.search(max_chunks=1)
    if not found or found[0].private_key != k:
        raise GateError("minikeys gate FAILED")
    log(f"[gate] minikeys: planted minikey {mk} recovered bit-exact")
    eng.counter = MINIKEY_COUNTER

    def window():
        eng.search(stop_on_first=False, max_seconds=seconds)

    rate = _search_rate(eng, seconds, lambda: None, window)  # multiplier 1
    log(f"[bench] minikeys: {rate / 1e6:.2f}M minikeys/s")
    return {"keys_per_sec": rate, "gate": "ok"}


def bench_vanity(seconds: float = 5.0, device="cuda", *,
                 gate_shape=GATE_SHAPE, rate_shape=RATE_SHAPE, rate_range=BRUTE_RANGE) -> dict:
    """Key 777 found by its 5-character address prefix over [1, 2049),
    then the rate with that prefix's intervals (bench_modes.py:194-226)."""
    pref = vanity_prefix()
    ivs = vanity_intervals(pref)
    empty = TargetSet(kind="hash160", raw=[], labels=[])
    gate = BruteParams(block_u=gate_shape[0], steps_per_chunk=gate_shape[1],
                       chunk_cand=GATE_CAND)
    eng = BruteEngine(empty, *VANITY_GATE_RANGE, mode="rmd160", params=gate, device=device,
                      intervals=ivs, prefixes=[pref])
    if not any(f.private_key == VANITY_KEY for f in eng.search()):
        raise GateError("vanity gate FAILED")
    log(f"[gate] vanity: prefix {pref} -> key {VANITY_KEY} recovered")
    params = BruteParams(block_u=rate_shape[0], steps_per_chunk=rate_shape[1])
    eng = BruteEngine(empty, *rate_range, mode="rmd160", params=params, device=device,
                      intervals=ivs, prefixes=[pref])
    eff = _brute_rate(eng, seconds)
    log(f"[bench] vanity: {eff / 1e6:.1f}M keys/s effective (both parities)")
    return {"keys_per_sec": eff, "gate": "ok"}


def bench_bsgs_multitarget(params: BSGSParams, seconds: float = 5.0, device="cuda", *,
                           table=None, bitmap=None, host_table=None, bloom2=None) -> dict:
    """T = 16 beside the headline, on its table and filters
    (bench_modes.py:229-285): 16 keys planted by default_rng(16) in one
    chunk's window from 2^63 must all be found in one scan (K =
    T16_STEPS[0]); then the range keys/s at K = T16_STEPS[1] over
    [2^63, 2^64) from bench.py's loop (coverage splits across the 16
    pubkeys, as the reference's per-target loop)."""
    kw = dict(device=device, table=table, bitmap=bitmap, host_table=host_table, bloom2=bloom2)
    gate = dataclasses.replace(params, steps_per_chunk=T16_STEPS[0])
    planted, window = t16_planted(params)
    a = 1 << 63
    eng = BSGSEngine([ecref.scalar_mult(k) for k in planted], a, a + window, gate, **kw)
    _check_found("bsgs_t16", planted, [f.private_key for f in
                                       eng.search(stop_on_first=False, max_steps=T16_STEPS[0])])
    log("[gate] bsgs T=16: 16 planted keys recovered bit-exact")

    rate_params = dataclasses.replace(params, steps_per_chunk=T16_STEPS[1])
    pubs = [ecref.scalar_mult(0x1000 + 7 * i) for i in range(16)]
    eng = BSGSEngine(pubs, 1 << 63, 1 << 64, rate_params, **kw)
    px, py = warm_chunk(eng)
    chunks, dt, _ = chunk_window(eng, px, py, seconds)
    rate = range_keys_per_sec(chunks, eng.p.steps_per_chunk, eng.p.block_u, eng.stride, dt)
    log(f"[bench] bsgs T=16: {rate:.3e} range-keys/s")
    return {"keys_per_sec": rate, "gate": "ok"}


def iter_all(seconds: float = 5.0, device="cuda", *, gate_shape=GATE_SHAPE,
             bucket_gate_shape=BUCKET_GATE_SHAPE, rate_shape=RATE_SHAPE,
             rate_range=BRUTE_RANGE, minikey_batch: Optional[int] = None
             ) -> Iterator[Tuple[str, dict]]:
    """(name, result) after each section, in bench_modes.iter_all's order:
    the four brute modes, minikeys, vanity, then the -e and T = 4096
    variants."""
    shapes = dict(rate_shape=rate_shape, rate_range=rate_range)
    yield from iter_brute_modes(seconds, device=device, gate_shape=gate_shape, **shapes)
    yield "minikeys", bench_minikeys(seconds, device=device, batch=minikey_batch)
    yield "vanity", bench_vanity(seconds, device=device, gate_shape=gate_shape, **shapes)
    yield from iter_brute_variants(seconds, device=device, bucket_gate_shape=bucket_gate_shape,
                                   **shapes)


def run_all(seconds: float = 5.0, device="cuda", **kw) -> dict:
    return dict(iter_all(seconds, device, **kw))
