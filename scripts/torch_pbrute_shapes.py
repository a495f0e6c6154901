#!/usr/bin/env python3
"""Time the fused brute chunk's kernels on an NVIDIA GPU: K4 in its shapes,
with and without the block's shared inversion, the compaction kernel
against the torch ops it replaced, and whole fused chunks.

    python3 scripts/torch_pbrute_shapes.py [--parent DIR] [--chunk]

At the fused path's main shape (K = 256, U = 16384, T = 32 intervals;
chip_smoke.py's phase 4):
1. K4 (csrc/pbrute.cu): copies with other kBruteGroup (G, base rows a
   thread) and kThreads (columns a block), each with the block's shared
   inversion (the shipped design: one fe_inv_var a block through
   batch_inv.cuh) and with a thread's own fe_inv_var of its chain (the
   design before), and, with --parent DIR (an earlier commit unpacked with
   git archive into a gitignored directory), DIR's csrc/pbrute.cu; each
   built by its own nvcc (all in parallel), held to the shipped kernel's
   hit words (brute_walk_blocks, itself equal to brute_walk_blocks_ref in
   chip_smoke.py's phase 1) in xpoint, rmd160 and eth, and timed
   (chip_smoke.device_ms) beside ptxas's registers and spills.
2. The compaction and summary: pbrute.compact_hits (kh_compact_hits)
   against compact_hits_ref (the torch ops the chunk ran before) on K4's
   rmd160 hit words at C = 1024, held equal: card time and the host's time
   to enqueue a call.
3. The SASS instructions of one fe_mul and one fe_sqr of csrc/fe.cuh
   (torch_pwalk_shapes.sass_counts).
4. With --chunk: the fused chunk (K1 + K4 + compaction) of this tree and,
   with --parent, of DIR, each in a process of its own run from its tree,
   in the order parent, this, this, parent (this, this without --parent),
   in rmd160 and xpoint with keys 1..32 as targets: the device operations
   of a chunk (torch.profiler), the host's enqueue and the card's time a
   chunk, and the effective keys/s and wall time a chunk over 3 s of
   BruteEngine.search.
Prints one line per measurement and a JSON line of all times.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

# (G, threads, least resident blocks an SM): shared inversion and own
SHAPES = [(16, 128, 1), (32, 128, 1), (64, 128, 1), (32, 64, 1), (64, 64, 1), (16, 256, 1),
          (32, 256, 1)]
# shared inversion only
SHARED_SHAPES = [(64, 256, 1), (32, 128, 5), (64, 128, 5), (32, 256, 3), (64, 256, 3),
                 (16, 512, 1), (32, 512, 1), (64, 512, 1), (64, 512, 2)]
MODES = ("xpoint", "rmd160", "eth")
C = 1024  # BruteParams.chunk_cand
SHARED_INV = """  tree[kThreads + i] = acc;
  block_batch_inv<kh::fe_inv_var>(tree);  // its first barrier also covers smem
  Fe inv = tree[kThreads + i];  // 1 / (this thread's chain total)
"""
OWN_INV = """  __syncthreads();  // the targets in shared memory
  Fe inv = kh::fe_inv_var(acc);  // this thread's own inversion
"""
TREE = "  __shared__ Fe tree[2 * kThreads];\n"

# the fused chunk of a tree, run from the tree's root (its own package and
# chip_smoke.py); prints a JSON line
CHUNK = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from keyhuntm1cpu_tpu_torch import _build
from keyhuntm1cpu_tpu_torch.curve import pbrute
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
from keyhuntm1cpu_tpu_torch.ref import ecref
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

_build.kernels()
out = {}
for mode in ("rmd160", "xpoint"):
    keys = list(range(1, 33))
    ts = TargetSet(kind="xpoint" if mode == "xpoint" else "hash160", labels=[str(k) for k in keys],
                   raw=[cs.brute_artifact(mode, ecref.scalar_mult(k)) for k in keys])
    params = BruteParams(block_u=cs.U, steps_per_chunk=cs.K)
    eng = BruteEngine(ts, *cs.BRUTE_RANGE, mode=mode, params=params, device="cuda")
    px, py = eng._fast_base(0)
    chunk = lambda: pbrute.brute_chunk(
        px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, eng._tgt, eng._btab, K=cs.K,
        U=cs.U, C=params.chunk_cand, mode=mode, n_endo=eng._n_endo,
        n_bucket_rows=eng._n_bucket_rows, adv_tab=eng.adv_tab)
    chunk()
    ops = cs.device_launches(chunk)
    card_ms, _ = cs.device_ms(chunk, 10)
    enqueue = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        chunk()
        enqueue.append(1000 * (time.perf_counter() - t))
    eng.search(max_steps=cs.K)  # warm-up chunk
    torch.cuda.synchronize()
    k0 = eng.stats.keys_covered
    t0 = time.time()
    eng.search(max_seconds=3.0)
    torch.cuda.synchronize()
    dt = time.time() - t0
    keys_walked = eng.stats.keys_covered - k0
    out[mode] = dict(ops=ops, enqueue_ms=float(np.median(enqueue)), card_ms=card_ms,
                     wall_ms=1000 * dt / (keys_walked // (cs.K * cs.U)),
                     keys_per_s=keys_walked * eng.stats.multiplier / dt)
print(json.dumps(out))
"""


LAUNCH_BOUNDS = "__launch_bounds__(kThreads)\nbrute_walk_kernel("


def variant_source(src, G, threads, min_blocks, shared):
    """pbrute.cu with G rows a thread, `threads` a block, ptxas asked for
    min_blocks resident blocks an SM, and the shared or a thread's own
    inversion."""
    out = src
    for name, v in (("kBruteGroup", G), ("kThreads", threads)):
        out, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", out)
        assert n == 1, name
    if min_blocks > 1:
        assert LAUNCH_BOUNDS in out
        out = out.replace(LAUNCH_BOUNDS, LAUNCH_BOUNDS.replace(
            "(kThreads)", f"(kThreads, {min_blocks})"))
    if not shared:
        assert SHARED_INV in out and TREE in out
        out = out.replace(SHARED_INV, OWN_INV).replace(TREE, "")
    return out


def chunk_runs(trees, log):
    """{label: [result, ...]} of the CHUNK program in each tree, in order."""
    out = {}
    for label, root in trees:
        res = subprocess.run([sys.executable, "-c", CHUNK], cwd=root, capture_output=True,
                             text=True, timeout=900)
        if res.returncode:
            raise RuntimeError(f"fused chunk in {root} failed:\n{res.stdout}\n{res.stderr}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        for mode, v in r.items():
            log(f"fused chunk {mode} ({label}, {root}): {v['ops']} device operations, host "
                f"enqueue {v['enqueue_ms']:.3f} ms, card {v['card_ms']:.3f} ms, wall "
                f"{v['wall_ms']:.3f} ms a chunk, {v['keys_per_s']:.4e} effective keys/s")
        out.setdefault(label, []).append(r)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--chunk", action="store_true", help="also time whole fused chunks")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pbrute, pwalk, tables
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from torch_pwalk_shapes import build, sass_counts
    from torch_walker_shapes import host_ms

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    out = {"card": card}
    K, U = cs.K, cs.U

    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    with open(os.path.join(csrc, "pbrute.cu")) as f:
        src = f.read()
    ship = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kBruteGroup", "kThreads"))
    variants = ([(*shape, sh) for shape in SHAPES for sh in (True, False)]
                + [(*shape, True) for shape in SHARED_SHAPES])
    jobs = [(f"G{g}_T{t}_B{b}_{'shared' if sh else 'own'}", variant_source(src, g, t, b, sh),
             csrc) for g, t, b, sh in variants]
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
        with open(os.path.join(pdir, "pbrute.cu")) as f:
            jobs.append(("parent", f.read(), pdir))
    t0 = time.time()
    libs = build(jobs, os.path.join(_build.build_dir(), "pbrute_shapes"))
    cs.log(f"built {len(jobs)} K4 variants in {time.time() - t0:.1f} s")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib, _ in libs.values():
        lib.kh_brute_walk_blocks.argtypes = [vp] * 7 + [i64, i, i, i, i, i, vp]
    st = torch.cuda.current_stream().cuda_stream

    # chip_smoke.py's phase-1 inputs: K walk bases from 2^40 - 1, keys 1..3
    # planted as hits, two dx == 0 lanes
    limbs = lambda v: torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)
    tab_x, tab_y = tables.step_table(ecref.G, U)
    tx, ty = pwalk.table_to_limb_major(tab_x, dev), pwalk.table_to_limb_major(tab_y, dev)
    adv = ecref.scalar_mult(U)
    b0 = cs.BRUTE_RANGE[0] - 1
    base = ecref.scalar_mult(b0)
    bx, by, _, _, adeg = pwalk.advance_chain(limbs(base[0])[:, None], limbs(base[1])[:, None],
                                             limbs(adv[0]), limbs(adv[1]), K)
    for row, u in ((3, U // 7), (9, U - 2)):
        bx[:, row] = limbs(fe.limbs_to_int(tab_x[u]))
        by[:, row] = limbs(fe.limbs_to_int(tab_y[u]))
    rng = np.random.default_rng(11)
    hits_at = [(0, 5), (K - 1, U - 1), (K // 2, U // 3 + 1)]
    empty = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    cases = {}
    for mode in MODES:
        vals = [cs.cmp64(mode, cs.brute_artifact(mode, ecref.scalar_mult(b0 + s * U + u + 1)))
                for s, u in hits_at]
        vals += [int(v) for v in rng.integers(0, 2**63, 32 - len(vals))]
        tgt = torch.from_numpy(pbrute.pack_intervals(vals, vals).view(np.int32)).to(dev)
        cases[mode] = (bx, by, tx, ty, tgt, empty)

    # 1. K4 designs
    want = {m: pbrute.brute_walk_blocks(*a, m, 1, 0) for m, a in cases.items()}
    torch.cuda.synchronize()
    for m, w in want.items():
        if sum(int(w[s, u] != 0) for s, u in hits_at) != 3:
            cs.fail(f"K4 {m}: planted hits missing")
    k4 = {}
    for name, (lib, blog) in libs.items():
        row = {}
        for m, a in cases.items():
            got = torch.empty((K, U), dtype=torch.int32, device=dev)
            ptrs = [t.data_ptr() for t in a] + [got.data_ptr()]

            def run():
                rc = lib.kh_brute_walk_blocks(*ptrs, K, U, a[4].shape[1], 0,
                                              pbrute.MODES.index(m), 1, st)
                if rc:
                    raise RuntimeError(f"{name}: K4 launch failed ({rc})")
                return got
            ms, g = cs.device_ms(run, 10)
            if not torch.equal(g, want[m]):
                cs.fail(f"K4 {name} {m} differs from the shipped kernel")
            row[m] = ms
        regs = "; ".join(ln.split(";")[0] for ln in cs.ptxas_summary(blog)
                         if ln.startswith(("brute_walk_kernel<0, 1>", "brute_walk_kernel<1, 1>",
                                           "brute_walk_kernel<2, 1>")))
        cs.log(f"K4 {name}: " + ", ".join(f"{m} {v:.4f} ms" for m, v in row.items())
               + f" | {regs}")
        k4[name] = row
    shipped = {m: cs.device_ms(lambda: pbrute.brute_walk_blocks(*a, m, 1, 0), 10)[0]
               for m, a in cases.items()}
    cs.log(f"K4 shipped (G={ship[0]}, threads={ship[1]}): "
           + ", ".join(f"{m} {v:.4f} ms" for m, v in shipped.items()))
    out["k4"] = k4 | {"shipped": shipped}

    # 2. the compaction and summary against the torch ops it replaced
    hits = want["rmd160"]
    a0 = adeg[0]
    got = pbrute.compact_hits(hits, a0, C)
    ref = pbrute.compact_hits_ref(hits, a0, C)
    if not torch.equal(got, ref) or int(ref[-1]) != 3:
        cs.fail("compact_hits differs from compact_hits_ref, or misses the planted hits")
    comp = {}
    for name, fn in (("kernel", lambda: pbrute.compact_hits(hits, a0, C)),
                     ("torch ops (compact_hits_ref)", lambda: pbrute.compact_hits_ref(
                         hits, a0, C))):
        comp[name] = {"card_ms": cs.device_ms(fn, 20)[0], "host_ms": host_ms(fn, 20),
                      "ops": cs.device_launches(fn)}
    bms, _ = cs.bound_ms(0, 4 * K * U + K + 4 * (2 * C + 3 * K + 1), cs.sm_clock_mhz())
    cs.log(f"compaction K={K} U={U} C={C} (bound {bms:.4f} ms by bytes): "
           + ", ".join(f"{k} {v['card_ms']:.4f} ms on the card in {v['ops']} device "
                       f"operations, {v['host_ms']:.4f} ms to enqueue"
                       for k, v in comp.items()) + " (equal summaries)")
    out["compaction"] = comp

    # 3. SASS of the field product and squaring
    sass = sass_counts(csrc, os.path.join(_build.build_dir(), "pbrute_shapes"))
    for fn, (n, ops) in sorted(sass.items()):
        cs.log(f"SASS {fn}: {n} instructions ({n - sass['probe_copy'][0]} more than "
               f"probe_copy), most used {ops}")
    out["sass"] = sass

    # 4. whole chunks, each tree in its own process
    if args.chunk:
        this = ("this tree", HERE)
        trees = ([("parent", os.path.abspath(args.parent)), this, this,
                  ("parent", os.path.abspath(args.parent))] if args.parent else [this, this])
        del cases, want, hits, libs
        torch.cuda.empty_cache()
        out["chunk"] = chunk_runs(trees, cs.log)
    cs.log(f"card {card}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
