"""The one traffic generator: a mix file's parameters and a seed -> inputs.

A mix (khbench/traffic/<name>.json) says how many targets a run scans
for, of which kind, in which order, and where the planted key lies:

- ``targets``: the size of the target set; ``target_kind``: "pubkey"
  (BSGS: the planted key's public key) or "hash160" (the planted key's
  compressed hash160, the rest random 20-byte digests drawn once from
  ``filler_seed``: one fixed list, as a user scans one list, so that every
  seed packs the same table and does the same work);
- ``order``: the range order ("sequential");
- ``plant_span_log2``: the planted key lies in the first 2^span keys of
  its slice; ``plant_slice``: "seeded" draws that slice among the
  configuration's (one on one chip, four in a range cut in four);
- ``planted`` (1 if absent): how many of the hash160 targets are planted
  keys. More than one are spread over a chunk of the brute scan (key
  a + chunk*K*U + step*U + lane): key i takes the lane parity, the lane
  half and the step half of SPREAD[i % 4], so that each half of a chunk's
  lanes, by parity or by halves, and each half of its steps holds one,
  and a run that leaves out half of every batch misses one whatever the
  seed.

The configuration gives the range ([2^lo, 2^hi) from ``range_log2``) and
how it is sliced. The window starts at a seeded key of the range's first
half, so every seed sees the same sizes and the same work, at another
place.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .reference import hashes
from .reference import secp256k1 as ec

# (lane parity, lane half, step half) of planted keys 0..3
SPREAD = ((0, 0, 0), (1, 1, 0), (0, 1, 1), (1, 0, 1))


@dataclass
class Inputs:
    a: int  # the searched range [a, b)
    b: int
    planted: List[int]  # private keys the run must report
    pubkeys: List[tuple] = field(default_factory=list)  # "pubkey" targets
    digests: List[bytes] = field(default_factory=list)  # "hash160" targets
    slice_starts: List[int] = field(default_factory=list)


def slice_starts(a: int, b: int, n: int, window: int) -> List[int]:
    """Starts of n window-aligned slices cutting [a, b) equally."""
    per = math.ceil(max(1, math.ceil((b - a) / window)) / n)
    return [a + d * per * window for d in range(n)]


def spread_offsets(rng: random.Random, n: int, span_log2: int, K: int, U: int) -> List[int]:
    """n distinct offsets below 2^span_log2 in the brute scan's layout,
    placed as SPREAD says (K and U even)."""
    chunks = max(1, (1 << span_log2) // (K * U))
    out: List[int] = []
    while len(out) < n:
        parity, lane_half, step_half = SPREAD[len(out) % len(SPREAD)]
        step = step_half * (K // 2) + rng.randrange(max(1, K // 2))
        lane = lane_half * (U // 2) + 2 * rng.randrange(max(1, U // 4)) + parity
        off = rng.randrange(chunks) * K * U + step * U + lane
        if off not in out:
            out.append(off)
    return out


def generate(mix: dict, config: dict, seed: int) -> Inputs:
    rng = random.Random(seed)
    lo, hi = (1 << config["range_log2"][0]), (1 << config["range_log2"][1])
    a = lo + rng.randrange((hi - lo) // 2)
    if mix["order"] != "sequential":
        raise ValueError(f"unknown order {mix['order']!r}")
    window = config["block_u"] * (2 * config["m_babies"] if "m_babies" in config else 1)
    starts = slice_starts(a, hi, config.get("devices", 1), window)
    d = rng.randrange(len(starts)) if mix["plant_slice"] == "seeded" else 0
    n, n_planted = mix["targets"], mix.get("planted", 1)
    if n_planted == 1:
        ks = [starts[d] + rng.randrange(1 << mix["plant_span_log2"])]
    elif mix["target_kind"] == "hash160" and n_planted <= n:
        ks = [starts[d] + off for off in spread_offsets(
            rng, n_planted, mix["plant_span_log2"], config["steps_per_chunk"],
            config["block_u"])]
    else:
        raise ValueError("several planted keys need as many hash160 targets")
    inp = Inputs(a=a, b=hi, planted=ks, slice_starts=starts)
    if mix["target_kind"] == "pubkey":
        if n != 1:
            raise ValueError("pubkey mixes plant one target")
        inp.pubkeys = [ec.mul(ks[0])]
    elif mix["target_kind"] == "hash160":
        m = n - n_planted
        fill = np.random.default_rng(mix["filler_seed"]).bytes(20 * m) if m else b""
        digests = [fill[20 * i:20 * i + 20] for i in range(m)]
        for k in ks:
            h = hashes.hash160(ec.compressed(ec.mul(k)))
            digests.insert(rng.randrange(len(digests) + 1), h)
        inp.digests = digests
    else:
        raise ValueError(f"unknown target kind {mix['target_kind']!r}")
    return inp
