"""rmd160 brute force on one card: ``BruteEngine.search`` on the fused path.

Set-up packs the target set (the engine's own packing: intervals, or the
lane table past the compare's budget), makes the engine over the seeded
range and warms every shape with a short search. The window is one
``search(max_seconds=...)``: every chunk's summary is decoded and every
candidate checked on the host (``_decode_fast``, ``_verify_all``). Hooks on
the engine instance see each chunk's handed-on walk state and each
summary's candidates for the checks.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from .. import faults
from ..reference import brute as ref
from ..reference import filters, hashes
from ..trace import Recorder
from . import common


class Summaries:
    """What the checks keep of the chunk summaries (layout of
    curve/pbrute.py compact_hits: C positions, C hit words, 3*K step
    words, the hit count last)."""

    def __init__(self, C: int, B: int):
        self.C, self.B = C, B
        self.n_sum = self.n_chunks = self.overflows = 0
        self.cands: List[tuple] = []  # (chunk, pos, bits)

    def add(self, chunk: int, arr: np.ndarray) -> None:
        n = int(arr[-1])
        self.n_chunks += 1
        if n > self.C:
            self.overflows += 1
        else:
            self.n_sum += n
        pos = arr[:self.C]
        for c in np.nonzero(pos < self.B)[0]:
            self.cands.append((chunk, int(pos[c]), int(arr[self.C + c]) & 0xFFFFFFFF))


def run(ctx: common.Ctx) -> common.Outcome:
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    cfg, inp, dev = ctx.cfg, ctx.inputs, ctx.devices[0]
    p = BruteParams(block_u=cfg["block_u"], steps_per_chunk=cfg["steps_per_chunk"],
                    chunk_cand=cfg["chunk_cand"], pipeline_depth=cfg["pipeline_depth"],
                    compare_max=cfg["compare_max"], bucket_max=cfg["bucket_max"],
                    endo=cfg["endo"])
    targets = TargetSet(kind="hash160", raw=list(inp.digests),
                        labels=[d.hex() for d in inp.digests])
    eng = BruteEngine(targets, inp.a, inp.b, mode=cfg["mode"], params=p, device=dev)
    ctx.mark("engine")
    K, U = p.steps_per_chunk, p.block_u
    ctx.undo.append(faults.apply(ctx.fault, eng, "brute"))
    eng.search(max_steps=2 * p.pipeline_depth * K)
    common.sync(ctx.devices)
    ctx.mark("warm-up")

    rec = Recorder(ctx.trace, ctx.devices)
    summ = Summaries(p.chunk_cand, K * U)
    states = common.hook_chunks(ctx, eng, rec, dev)
    common.hook_decode(eng, "_decode_fast", rec, lambda step0, arr: summ.add(step0 // K, arr))
    k0 = eng.stats.keys_covered
    found, wall = common.window(ctx, rec, lambda: eng.search(max_seconds=ctx.seconds))
    keys_delta = eng.stats.keys_covered - k0
    peak = common.memory_peak(ctx.devices)
    values = [hashes.cmp64(d) for d in inp.digests]
    n_rows = eng._n_bucket_rows
    readings = dict(trace=rec.reduce(), shape=dict(
        K=K, U=U, mode=eng.mode, n_endo=eng._n_endo, T=int(eng._tgt.shape[1]),
        TB=filters.bucket_rows(values) if n_rows else 0))

    t = time.perf_counter()
    lay = ref.Layout(inp.a, U, K)
    lanes = filters.bucket_lanes(values) if n_rows else None
    r = ctx.rng("candidates")
    planted = set(inp.planted)
    hit_chunks = {lay.expected_hit(k)[0] for k in planted}
    cands = [c for c in summ.cands if c[0] in hit_chunks]
    rest = [c for c in summ.cands if c[0] not in hit_chunks]
    cands += r.sample(rest, min(len(rest), common.CANDIDATE_SAMPLES))
    hit_err = ref.candidate_errors(lay, cands, set(values), lanes)
    for k in planted:  # the planted key's hit, where its chunk was decoded
        chunk, pos, bit = lay.expected_hit(k)
        hit_err += chunk < summ.n_chunks and not any(
            c == chunk and p2 == pos and b & bit for c, p2, b in summ.cands)
    st_err = sum(ref.state_errors(lay, i + 1, *(common.limbs(v) for v in s))
                 for i, s in states.items())
    setup_err = int(eng._walker) + int(bool(n_rows) != (len(values) > cfg["compare_max"]))
    setup_err += ref.target_table_errors(
        values, eng._tgt.cpu().numpy().view(np.uint32), eng._btab.cpu().numpy().view(np.uint32),
        n_rows)
    got = {f.private_key for f in found}
    res = {
        "found_missing": len(planted - got),
        "found_extra": len(got - planted),
        "hit_errors": hit_err,
        "state_errors": st_err,
        "keys_gap": abs(keys_delta - summ.n_chunks * K * U),
        "setup_errors": setup_err,
    }
    if lanes is not None:
        expected = filters.brute_hit_words_per_chunk(K * U, 2, lanes)
        counted = summ.n_chunks - summ.overflows
        true_hits = sum(lay.expected_hit(k)[0] < summ.n_chunks for k in planted)
        mean = (summ.n_sum - true_hits) / counted if counted else 0.0
        res["survivor_rate_gap"] = abs(mean / expected - 1)
        readings.update(survivors_mean=mean, survivors_expected=expected, chunks_counted=counted,
                        overflows=summ.overflows)
    readings["reference_s"] = time.perf_counter() - t
    return common.Outcome(keys=keys_delta * eng.stats.multiplier, wall_s=wall, checks=res,
                          attempted=summ.n_chunks, failed=common.failed(res),
                          memory_peak_bytes=peak, readings=readings)
