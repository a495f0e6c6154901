"""BSGS on one card: ``BSGSEngine.search`` in device resolve.

Set-up builds the baby table, its bitmap and bloom2 on the card (the
engine's own build functions), makes the engine over the seeded range, refuses
a layout whose every chunk would overflow the filter cascade, and warms
every shape with a short search. The window is one
``search(stop_on_first=False, max_seconds=...)``: every chunk's summary is
decoded and every candidate checked on the host. Hooks set on the engine
instance see each chunk's dispatch (its handed-on walk state) and each
summary (its survivor count and table matches) for the checks.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .. import faults
from ..reference import bsgs as ref
from ..reference import filters
from ..trace import Recorder
from . import common


def params(cfg: dict):
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams

    return BSGSParams(m=cfg["m_babies"], block_u=cfg["block_u"],
                      steps_per_chunk=cfg["steps_per_chunk"],
                      chunk_cand_max=cfg["chunk_cand_max"], bits_log2=cfg["bits_log2"],
                      cascade2=cfg["cascade2"], pipeline_depth=cfg["pipeline_depth"],
                      resolve="device")


def build_table(cfg: dict, dev):
    """The baby table, its bitmap and its bloom2 on `dev`, as the engine
    builds them; (table, bitmap, seconds until the card finished)."""
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    def build():
        table = bsgs.build_baby_table(cfg["m_babies"], bsgs.BSGSParams().build_block, dev)
        bitmap = bmp.build_bitmap_device(table, cfg["bits_log2"])
        bsgs._bloom2_for_table(table)  # the engine's shared bloom2, built once
        return table, bitmap

    (table, bitmap), s = common.timed_s(build, [dev])
    return table, bitmap, s


class Summaries:
    """What the checks keep of the window's chunk summaries (layout of
    engine/bsgs.py chunk_impl: C2 positions, the j at each position's lower
    bound and successor, 3*T*K row words, the survivor count last)."""

    def __init__(self, C2: int, B: int):
        self.C2, self.B = C2, B
        self.n_sum = self.n_chunks = self.overflows = 0
        self.live: Dict[tuple, List[tuple]] = {}  # (slice, chunk) -> [(pos, j1, j2)]

    def add(self, key: tuple, arr: np.ndarray) -> None:
        n = int(arr[-1])
        self.n_chunks += 1
        if n > self.C2:
            self.overflows += 1
        else:
            self.n_sum += n
        pos = arr[:self.C2]
        live = np.nonzero(pos < self.B)[0]
        if len(live):
            js = arr[self.C2:3 * self.C2].view(np.uint32).reshape(2, self.C2)[:, live]
            self.live[key] = [(int(pos[c]), int(j1), int(j2)) for c, j1, j2 in zip(live, *js)]


def checks(ctx, lay: ref.Layout, targets, found, keys_delta: int, keys_per_chunk: int,
           summ: Summaries, states: Dict[tuple, list], slice_steps: List[int],
           setup_errors: int, filter_bits: tuple, diag: dict) -> Dict[str, float]:
    """The numbers compared of a BSGS run (slice_steps: each slice's first
    step; one slice on one card; filter_bits: the sizes of the bitmap and
    the bloom2 the chunks probe, 0 for no bloom2)."""
    planted = set(ctx.inputs.planted)
    got = {f.private_key for f in found}
    hit_err = 0
    for (d, chunk), entries in summ.live.items():
        hit_err += ref.live_errors(lay, targets, chunk, slice_steps[d], entries)
    for k in planted:  # the planted key's match, where its chunk was decoded
        d = max(i for i, s in enumerate(ctx.inputs.slice_starts) if s <= k)
        want = lay.expected_hits(k, 0, slice_steps[d])
        seen = [(c, p, j) for c, p, j in want
                if any(p == p2 and j in (j1, j2) for p2, j1, j2 in summ.live.get((d, c), []))]
        hit_err += bool(want) and not seen and all(c < summ.n_chunks // len(slice_steps)
                                                   for c, _, _ in want)
    st_err = 0
    for (d, chunk), (xs, ys) in states.items():
        st_err += ref.state_errors(lay, targets, slice_steps[d] + (chunk + 1) * lay.K, xs, ys)
    expected = filters.bsgs_survivors_per_chunk(lay.B, lay.m, *filter_bits)
    # the table matches pass the filters whatever their rate: left out
    counted = summ.n_chunks - summ.overflows
    n_live = sum(len(v) for v in summ.live.values())
    mean = (summ.n_sum - n_live) / counted if counted else 0.0
    diag.update(survivors_mean=mean, survivors_expected=expected, chunks_counted=counted,
                overflows=summ.overflows, table_matches=n_live)
    return {
        "found_missing": len(planted - got),
        "found_extra": len(got - planted),
        "hit_errors": hit_err,
        "state_errors": st_err,
        "keys_gap": abs(keys_delta - summ.n_chunks * keys_per_chunk),
        "setup_errors": setup_errors,
        "survivor_rate_gap": abs(mean / expected - 1.0),
    }


def setup_errors(ctx, table, bitmap, bloom2) -> int:
    """The derived set-up against the reference: the table's order, its
    payloads and sampled rows, their bits in both filters, and the bitmap
    size and cascade the configuration states."""
    cfg = ctx.cfg
    r = ctx.rng("table")
    samples = sorted({r.randrange(1, cfg["m_babies"] + 1) for _ in range(common.TABLE_SAMPLES)})
    bad = int(bitmap.bits_log2 != cfg["bits_log2"])
    bad += int((bloom2 is not None) != (cfg["cascade2"] == "on"))
    return bad + ref.table_errors(table.key, table.idx, cfg["m_babies"], bitmap.words,
                                  bitmap.bits_log2, None if bloom2 is None else bloom2.words,
                                  0 if bloom2 is None else bloom2.bits_log2, samples)


def filter_bits(eng) -> tuple:
    return eng.bitmap.bits_log2, 0 if eng.bloom2 is None else eng.bloom2.bits_log2


def refuse_overflowing_cascade(eng) -> None:
    """Refuse a layout whose chunks would pass more cascade survivors, on
    average, than the program's budget C2 holds: each such chunk falls
    back to the program's exact host rescan (K steps of T*U point
    additions in Python), so the warm-up alone would take tens of minutes.
    The expectation is the reference's, over the sizes of the bitmap and
    the bloom2 the engine built (per card's chunk on many cards); C2 is
    the program's own (engine/bsgs.py device_budgets)."""
    from keyhuntm1cpu_tpu_torch.engine.bsgs import device_budgets

    p = eng.p
    n = len(eng.targets) * p.steps_per_chunk * p.block_u
    bits, b2 = filter_bits(eng)
    C2 = device_budgets(n, p.m, bits, p)[1]
    expected = filters.bsgs_survivors_per_chunk(n, p.m, bits, b2)
    if expected > C2:
        raise common.Refused(
            f"every chunk would overflow its cascade: {expected:.1f} survivors expected a "
            f"chunk against the budget C2 = {C2} ({n} queries, m = {p.m}, a 2^{bits}-bit "
            f"bitmap, " + (f"a 2^{b2}-bit bloom2" if b2 else "no bloom2") + ")")


def run(ctx: common.Ctx) -> common.Outcome:
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine

    cfg, inp, dev = ctx.cfg, ctx.inputs, ctx.devices[0]
    table, bitmap, build_s = build_table(cfg, dev)
    eng = BSGSEngine(inp.pubkeys, inp.a, inp.b, params(cfg), device=dev, table=table,
                     bitmap=bitmap)
    ctx.mark("engine")
    refuse_overflowing_cascade(eng)
    K, U = eng.p.steps_per_chunk, eng.p.block_u
    T = len(inp.pubkeys)
    ctx.undo.append(faults.apply(ctx.fault, eng, "bsgs"))
    # every shape of the window, and the decode of a full pipeline
    eng.search(max_steps=2 * eng.p.pipeline_depth * K, stop_on_first=False)
    common.sync(ctx.devices)
    ctx.mark("warm-up")

    rec = Recorder(ctx.trace, ctx.devices)
    summ = Summaries(eng.C2, T * K * U)
    states = common.hook_chunks(ctx, eng, rec, dev)
    common.hook_decode(eng, "_consume_summary", rec,
                       lambda step0, k, arr: summ.add((0, step0 // K), arr))
    k0 = eng.stats.keys_covered
    found, wall = common.window(ctx, rec, lambda: eng.search(
        stop_on_first=False, max_seconds=ctx.seconds))
    keys_delta = eng.stats.keys_covered - k0
    peak = common.memory_peak(ctx.devices)
    readings = dict(trace=rec.reduce(), table_build_s=build_s,
                    shape=dict(T=T, K=K, U=U, m=cfg["m_babies"]))

    t = time.perf_counter()
    states = {(0, i): (common.limbs(x), common.limbs(y)) for i, (x, y) in states.items()}
    lay = ref.Layout(inp.a, cfg["m_babies"], U, K, T)
    res = checks(ctx, lay, inp.pubkeys, found, keys_delta, K * U * eng.stride, summ, states,
                 [0], setup_errors(ctx, table, bitmap, eng.bloom2), filter_bits(eng), readings)
    readings["reference_s"] = time.perf_counter() - t
    return common.Outcome(keys=keys_delta, wall_s=wall, checks=res, attempted=summ.n_chunks,
                          failed=common.failed(res), memory_peak_bytes=peak, readings=readings)
