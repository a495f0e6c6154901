"""Carry state over from the JAX package (keyhuntm1cpu_tpu) to the port.

Inputs are numpy arrays or plain attributes, never jax objects, so this
module imports no jax: pass ``np.asarray(jax_bitmap.words)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.brute import BruteParams
from .engine.bsgs import BSGSParams
from .engine.minikeys import MinikeyParams
from .filter.bitmap import DeviceBitmap, DeviceBloom2
from .filter.sorted_table import SortedXTable, table_from_planes
from .utils.targets import TargetSet


def _words(words: np.ndarray, bits_log2: int, device) -> torch.Tensor:
    arr = np.array(words, dtype=np.uint32)  # a writable copy
    if arr.shape != (1 << (bits_log2 - 5),):
        raise ValueError(f"filter words {arr.shape} do not match bits_log2={bits_log2}")
    return torch.from_numpy(arr.view(np.int32)).to(device)


def filters_from_jax(words1: np.ndarray, bits: int, words2: np.ndarray,
                     b2bits: int, device):
    """JAX DeviceBitmap/DeviceBloom2 words (as numpy uint32) -> the port's
    (DeviceBitmap, DeviceBloom2) on `device`."""
    return (DeviceBitmap(_words(words1, bits, device), bits),
            DeviceBloom2(_words(words2, b2bits, device), b2bits))


def table_from_jax(hi: np.ndarray, lo: np.ndarray, idx: np.ndarray, device) -> SortedXTable:
    """A JAX SortedXTable's planes (numpy uint32: np.asarray(table.hi), ...)
    -> the port's SortedXTable on `device`."""
    return table_from_planes(hi, lo, idx, device)


def params_from_jax(p) -> BSGSParams:
    """A keyhuntm1cpu_tpu BSGSParams -> the port's BSGSParams. The TPU knobs
    (pallas, pallas_sb, chain_len, probe_mode, table_comm) have no
    counterpart, nor has cand_max, the per-step budget of the JAX XLA
    chunk: the port's chunk is the JAX kernel path's, budgeted per chunk."""
    return BSGSParams(
        m=p.m, block_u=p.block_u, steps_per_chunk=p.steps_per_chunk,
        build_block=p.build_block, chunk_cand_max=p.chunk_cand_max,
        bits_log2=p.bits_log2, cascade2=p.cascade2, pipeline_depth=p.pipeline_depth,
        resolve=p.resolve, bloom2_bits=p.bloom2_bits, table_cache=p.table_cache,
    )


def brute_params_from_jax(p) -> BruteParams:
    """A keyhuntm1cpu_tpu BruteParams -> the port's. The TPU knobs
    (pallas_sb, hash_rows) have no counterpart. pallas='off' (the JAX XLA
    fallback) maps to compare_max = bucket_max = 0, which sends any
    non-empty target set down the port's walker path."""
    off = getattr(p, "pallas", "auto") == "off"
    return BruteParams(
        walkers=p.walkers, block_u=p.block_u, steps_per_chunk=p.steps_per_chunk,
        chain_len=p.chain_len, endo=p.endo, stride=p.stride, cand_max=p.cand_max,
        random_mode=p.random_mode, seed=p.seed, seq_per_base=p.seq_per_base,
        chunk_cand=p.chunk_cand, compare_max=0 if off else p.compare_max,
        bucket_max=0 if off else p.bucket_max, pipeline_depth=p.pipeline_depth,
    )


def minikey_params_from_jax(p) -> MinikeyParams:
    """A keyhuntm1cpu_tpu MinikeyParams -> the port's. pallas (the TPU
    kernel switch) and chain_len (the XLA ladder's inversion chain) have no
    counterpart; neither changes what a chunk finds."""
    return MinikeyParams(batch=p.batch, valid_max=p.valid_max, hit_max=p.hit_max,
                         pipeline_depth=p.pipeline_depth)


def targets_from_jax(ts) -> TargetSet:
    """A keyhuntm1cpu_tpu TargetSet -> the port's (its host-side fields)."""
    return TargetSet(kind=ts.kind, raw=list(ts.raw), labels=list(ts.labels),
                     pubkeys=list(ts.pubkeys))
