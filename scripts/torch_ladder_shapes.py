#!/usr/bin/env python3
"""Time the port's scalar-mult ladder K6 (csrc/ladder.cu) over its shapes on
an NVIDIA GPU, and, with --parent, an earlier tree's K6 and walk_emit
(csrc/walk.cu) beside this tree's.

    python3 scripts/torch_ladder_shapes.py [--parent DIR]

K6's shape is compile-time: lanes per scalar (kLadderSplit: 1, 2, 4, 8),
the ladder launch's block (kLadderThreads), the blocks an SM must hold
(kLadderMinBlocks, a register cap), whether the adds inline the field
product and square or call them (KH_LADDER_FE), and scalars per inversion
of the to-affine launch (kAffineGroup). Each shape is a copy of
csrc/ladder.cu with those lines rewritten, built by nvcc into the build
directory (all in parallel) and called through ctypes. At the minikeys
path's V = 34,816 random 256-bit scalars, every shape's outputs are held
to scalar_mult_split_ref of its split (torch.equal on x, y, inf, irr),
then timed by chip_smoke.device_ms: the ladder launch alone, the
to-affine launch alone and the pair, beside ptxas's registers and stack.
With --parent DIR (an earlier commit unpacked with git archive into a
gitignored directory), DIR's csrc/ladder.cu and csrc/walk.cu with its
fe.cuh are built the same way and its K6 and walk_emit are held to this
tree's outputs (K6 on the lanes neither flags) and timed at the main-path
shapes in the same run: K6 at V = 34,816, walk_emit at W = 8, U = 4096,
L = 32 with and without y. Prints one line per shape and a JSON line of
all times.
"""

import argparse
import ctypes
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

# (kLadderThreads, kLadderMinBlocks, field products as calls): the shipped
# shape first
LADDER_SHAPES = [(128, 5, True), (128, 4, True), (128, 3, True), (64, 9, True),
                 (32, 17, True), (256, 2, True), (128, 4, False), (128, 5, False),
                 (256, 2, False)]
SPLITS = (1, 2, 4, 8)
GROUPS = (32, 64, 128, 256, 512)
V = 34816  # the minikeys path's valid budget at B = 2^23


def shipped(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def variant_source(src, split, threads, min_blocks, calls, group):
    for name, v in (("kLadderSplit", split), ("kLadderThreads", threads),
                    ("kLadderMinBlocks", min_blocks), ("kAffineGroup", group)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", src)
        assert n == 1, name
    src, n = re.subn(r"#define KH_LADDER_FE \w+",
                     f"#define KH_LADDER_FE {'__noinline__' if calls else '__forceinline__'}",
                     src)
    assert n == 1
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pladder, pwalk, tables, walk
    from keyhuntm1cpu_tpu_torch.curve.points import point_batch_from_ints
    from keyhuntm1cpu_tpu_torch.field import fe, pinv
    from keyhuntm1cpu_tpu_torch.ref import ecref

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    _build.kernels()
    for ln in cs.ptxas_summary(_build.kernels_build_log()):
        if ln.startswith(("ladder_", "walk_emit_kernel")):
            cs.log(f"ptxas {ln}")

    rng = np.random.default_rng(6)
    k = torch.from_numpy(rng.integers(0, 2**32, (8, V), dtype=np.uint64).astype(np.uint32)
                         .view(np.int32)).to(dev)
    gx, gy = pladder.gtable_tensors(dev)
    want = {s: pladder.scalar_mult_split_ref(k, gx, gy, s) for s in SPLITS}
    times = {"ladder": {}, "affine": {}, "pair": {}}
    jac = torch.empty((3, 8, V), dtype=torch.int32, device=dev)
    inf = torch.empty(V, dtype=torch.bool, device=dev)
    irr = torch.empty_like(inf)
    x = torch.empty((8, V), dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    st = _build.stream(k)

    from torch_pwalk_shapes import build

    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    with open(os.path.join(csrc, "ladder.cu")) as f:
        src = f.read()
    split, group = shipped(src, "kLadderSplit"), shipped(src, "kAffineGroup")
    if split != pladder.SPLIT:
        cs.fail(f"csrc/ladder.cu kLadderSplit {split} != pladder.SPLIT {pladder.SPLIT}")
    t0, b0, c0 = LADDER_SHAPES[0]
    shapes = [(s_, t, b, c, group) for t, b, c in LADDER_SHAPES for s_ in SPLITS]
    shapes += [(split, t0, b0, c0, g) for g in GROUPS if g != group]

    def name(s_, t, b, c, g):
        return f"T{t}_B{b}_{'calls' if c else 'inline'}_S{s_}_G{g}"

    ship = name(split, t0, b0, c0, group)
    libs = build([(name(*sh), variant_source(src, *sh), csrc) for sh in shapes],
                 os.path.join(_build.build_dir(), "ladder_shapes"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for sh in shapes:
        v = name(*sh)
        lib, log = libs[v]
        lib.kh_ladder_jac.argtypes = [vp] * 6 + [i, vp]
        lib.kh_ladder_affine.argtypes = [vp] * 4 + [i, vp]
        regs = "; ".join(ln for ln in cs.ptxas_summary(log) if ln.startswith("ladder_jac"))
        cs.log(f"ptxas {v}: {regs}")

        def run(ladder=True, affine=True):
            rc = 0
            if ladder:
                rc = rc or lib.kh_ladder_jac(k.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                                             jac.data_ptr(), inf.data_ptr(), irr.data_ptr(), V, st)
            if affine:
                rc = rc or lib.kh_ladder_affine(jac.data_ptr(), inf.data_ptr(), x.data_ptr(),
                                                y.data_ptr(), V, st)
            if rc:
                cs.fail(f"{v}: launch failed (cudaError {rc})")
            return x, y, inf, irr

        for t in (jac, x, y, inf, irr):  # no earlier shape's outputs left to match
            t.fill_(-1)
        ms, got = cs.device_ms(run, 20)
        if not all(torch.equal(a, b) for a, b in zip(got, want[sh[0]])):
            cs.fail(f"{v} differs from scalar_mult_split_ref")
        l_ms, _ = cs.device_ms(lambda: run(affine=False), 20)
        a_ms, _ = cs.device_ms(lambda: run(ladder=False), 20)
        times["pair"][v], times["ladder"][v], times["affine"][v] = ms, l_ms, a_ms
        cs.log(f"K6 {v}: {ms:.4f} ms = ladder {l_ms:.4f} + to-affine {a_ms:.4f} "
               f"(V={V}; equal to scalar_mult_split_ref)")
    cs.log(f"shipped: {ship}; card {card}")

    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
        jobs = []
        for name in ("ladder", "walk"):
            with open(os.path.join(pdir, f"{name}.cu")) as f:
                jobs.append((f"parent_{name}", f.read(), pdir))
        libs = build(jobs, os.path.join(_build.build_dir(), "ladder_shapes"))
        for name, (_, log) in libs.items():
            for ln in cs.ptxas_summary(log):
                if ln.startswith(("scalar_mult_kernel", "walk_emit_kernel")):
                    cs.log(f"ptxas parent {ln}")
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        plad, pwk = libs["parent_ladder"][0], libs["parent_walk"][0]
        plad.kh_scalar_mult.argtypes = [vp] * 7 + [i, vp]
        pwk.kh_walk_emit.argtypes = [vp] * 14 + [i, i, i, i64, i, vp]
        outs = (torch.empty_like(x), torch.empty_like(y), torch.empty_like(inf),
                torch.empty_like(irr))

        def parent_k6():
            rc = plad.kh_scalar_mult(k.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                                     *[t.data_ptr() for t in outs], V, st)
            if rc:
                cs.fail(f"parent K6 launch failed ({rc})")
            return outs

        ms, got = cs.device_ms(parent_k6, 20)
        new_ms, new = cs.device_ms(lambda: pladder.scalar_mult_tiles(k, gx, gy), 20)
        both = ~got[3] & ~new[3]
        if not (torch.equal(got[2], new[2]) and torch.equal(got[0][:, both], new[0][:, both])
                and torch.equal(got[1][:, both], new[1][:, both])):
            cs.fail("the parent's K6 differs from this tree's on a lane neither flags")
        times["parent K6"], times["K6"] = ms, new_ms
        cs.log(f"K6 V={V}: parent {ms:.4f} ms, this tree {new_ms:.4f} ms")

        W, U, L = cs.WK_W, cs.WK_U, cs.WK_L
        tab_x, tab_y = tables.step_table(ecref.G, U)
        npts = 2 * U + 1
        adv = ecref.scalar_mult(npts)
        keys = [int(v) for v in rng.integers(2**40, 2**50, W)]
        c = point_batch_from_ints([ecref.scalar_mult(v) for v in keys], dev)
        limbs = lambda v: torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)
        wargs = (c.x, c.y, pwalk.table_to_limb_major(tab_x, dev),
                 pwalk.table_to_limb_major(tab_y, dev), limbs(adv[0]), limbs(adv[1]))
        pre, tot = walk.walk_prefix(*wargs, L)
        itot = pinv.inv_batch(tot)
        C = walk.n_chains(W, U, L)
        for need_y in (True, False):
            w_ms, new = cs.device_ms(lambda: walk.walk_emit(*wargs, pre, itot, L, 1, need_y), 20)
            px = torch.empty((1, 8, W, npts), dtype=torch.int32, device=dev)
            py = torch.empty((8, W, npts), dtype=torch.int32, device=dev) if need_y else None
            pdeg = torch.empty((W, U), dtype=torch.bool, device=dev)
            pnx, pny = torch.empty_like(c.x), torch.empty_like(c.y)
            padeg = torch.empty((W,), dtype=torch.bool, device=dev)
            ptrs = [t.data_ptr() for t in wargs + (pre, itot, px)]
            ptrs += [None if py is None else py.data_ptr()]
            ptrs += [t.data_ptr() for t in (pdeg, pnx, pny, padeg)]

            def parent_emit():
                rc = pwk.kh_walk_emit(*ptrs, W, U, L, C, 1, st)
                if rc:
                    cs.fail(f"parent walk_emit launch failed ({rc})")
                return px, py, pdeg, pnx, pny, padeg

            p_ms, got = cs.device_ms(parent_emit, 20)
            if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, new)):
                cs.fail("the parent's walk_emit differs from this tree's")
            label = f"walk_emit W={W} U={U} L={L} need_y={need_y}"
            times[f"parent {label}"], times[label] = p_ms, w_ms
            cs.log(f"{label}: parent {p_ms:.4f} ms, this tree {w_ms:.4f} ms (equal outputs)")
    print(json.dumps({"card": card, "V": V, "shipped": ship, "ms": times}), flush=True)


if __name__ == "__main__":
    main()
