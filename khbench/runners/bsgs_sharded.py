"""BSGS with the range cut over the cards: ``ShardedBSGSEngine.search_sharded``.

Set-up builds the baby table and its filters on the first card (as on one
card), and the engine copies them to the others. One host thread then
dispatches every card's chunk in turn; a sharded chunk's summaries come to
the first card and the host in one copy, and only chunks that report
something are decoded. Hooks on the engine instance see each sharded
dispatch (every card's handed-on walk state) and each sharded summary
(every card's survivor count and matches), which the harness reads once
the engine has waited on it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

from .. import faults
from ..reference import bsgs as ref
from ..trace import Recorder
from . import bsgs as single
from . import common


def run(ctx: common.Ctx) -> common.Outcome:
    from keyhuntm1cpu_tpu_torch.parallel import mesh

    cfg, inp = ctx.cfg, ctx.inputs
    devs = ctx.devices
    table, bitmap, build_s = single.build_table(cfg, devs[0])
    eng = mesh.ShardedBSGSEngine(inp.pubkeys, inp.a, inp.b, single.params(cfg), table=table,
                                 devices=devs, bitmap=bitmap)
    ctx.mark("engine")
    single.refuse_overflowing_cascade(eng)
    K, U, D = eng.p.steps_per_chunk, eng.p.block_u, eng.n_shards
    T = len(inp.pubkeys)
    ctx.undo.append(faults.apply(ctx.fault, eng, "bsgs_sharded"))
    eng.search_sharded(max_steps=2 * eng.p.pipeline_depth * K, stop_on_first=False)
    common.sync(devs)
    ctx.mark("warm-up")

    rec = Recorder(ctx.trace, devs)
    summ = single.Summaries(eng.C2, T * K * U)
    width = 3 * eng.C2 + 3 * T * K + 1
    keep = common.state_sample(ctx)
    states: Dict[tuple, tuple] = {}
    sharded, shard_chunk = eng._sharded_chunk, mesh.chunk_impl
    held: deque = deque()  # (chunk, host, event) not yet read
    n_disp = [0]

    def read(chunk, host, ev):
        if ev is not None:
            ev.synchronize()
        arr = host.numpy()
        for d in range(D):
            summ.add((d, chunk), arr[d * width:(d + 1) * width])

    def hooked_sharded(bases):
        i = n_disp[0]
        n_disp[0] += 1
        nxt, out = rec.dispatch_call(sharded, (bases,))
        if i in keep:
            for d, (nx, ny) in enumerate(nxt):
                states[(d, i)] = (nx, ny)
        held.append((i,) + tuple(out))
        while len(held) > eng.p.pipeline_depth + 1:  # waited on by the engine
            read(*held.popleft())
        return nxt, out

    def hooked_shard(*args, **kw):
        return rec.pair_call(args[0].device, lambda: shard_chunk(*args, **kw), ())

    eng._sharded_chunk = hooked_sharded
    common.hook_decode(eng, "_decode_sharded", rec, lambda *args: None)
    mesh.chunk_impl = hooked_shard
    k0 = eng.stats.keys_covered
    try:
        found, wall = common.window(ctx, rec, lambda: eng.search_sharded(
            stop_on_first=False, max_seconds=ctx.seconds))
    finally:
        mesh.chunk_impl = shard_chunk
    keys_delta = eng.stats.keys_covered - k0
    peak = common.memory_peak(devs)
    readings = dict(trace=rec.reduce(), table_build_s=build_s,
                    shape=dict(T=T, K=K, U=U, m=cfg["m_babies"], D=D))

    t = time.perf_counter()
    while held:
        read(*held.popleft())
    states = {k: (common.limbs(x), common.limbs(y)) for k, (x, y) in states.items()}
    lay = ref.Layout(inp.a, cfg["m_babies"], U, K, T)
    steps = [(s - inp.a) // (U * eng.stride) for s in inp.slice_starts]
    bad = int(steps != [sl.step0 for sl in eng.slices])
    for d in dict.fromkeys(devs):
        f = eng._filters[d]
        bad += single.setup_errors(ctx, f.table, f.bitmap, f.bloom2)
    res = single.checks(ctx, lay, inp.pubkeys, found, keys_delta,
                        D * K * U * eng.stride, summ, states, steps, bad,
                        single.filter_bits(eng), readings)
    res["keys_gap"] = abs(keys_delta - summ.n_chunks // D * D * K * U * eng.stride)
    readings["reference_s"] = time.perf_counter() - t
    return common.Outcome(keys=keys_delta, wall_s=wall, checks=res,
                          attempted=summ.n_chunks // D, failed=common.failed(res),
                          memory_peak_bytes=peak, readings=readings)
