#!/usr/bin/env python3
"""Time the port's BSGS walk kernels (csrc/pwalk.cu: K1 advance chain, K2
walk blocks) over their compile-time shapes on an NVIDIA GPU, and count
the SASS of the field arithmetic each runs.

    python3 scripts/torch_pwalk_shapes.py [--parent DIR]

Each variant is a copy of csrc/pwalk.cu with other values of kPairGroup
and kPairThreads (the paired K2's pair rows per thread G and threads per
block), kPairResident and kPairUnroll (its launch bounds and its backward
loop's unrolling) or kAdvTile (K1's lanes per block), built by nvcc into the
gitignored build directory and loaded with ctypes. Every variant's
outputs are held to the shipped kernels' (pwalk.advance_chain with the
centre lanes, walk_blocks with the pairs) on the same inputs, then timed
by chip_smoke.device_ms at the main path's shapes (K1 at T = 1, K = 256
and T = 16, K = 256, with the centre lanes; K2 at R = 256, U = 16384,
alone and with the BSGS chunk's level-1 probe of a 2^35-bit bitmap) and
the filter build's (K1 at K = 128, K2 at R = 128, U = 4096), beside
ptxas's registers and spills. The shipped library's K1 without the
centres and K2 a point a thread (walk_blocks_kernel, the U % 64 != 0
path) are timed at the same shapes. With --parent DIR, DIR is another
tree (an unpacked earlier commit, whose K1 may be the serial chain that
takes ADV and a scratch buffer, whose K2 may take no bitmap, and whose
K1 / K2 have no centres or pairs) whose csrc/pwalk.cu and fe.cuh are
timed the same way in the same run. Then it counts the SASS instructions
(cuobjdump -sass) of one fe_mul, fe_sqr and fe_sub of csrc/fe.cuh, one
fw_mul, fw_sqr, fw_sub and fw_canon_lo of csrc/fe_walk.cuh (K2's own),
and one iteration of K2's walk a point a thread (a point's forward and
backward work) and of the paired walk (a pair's), by opcode class
(IMAD.WIDE, IMAD, IADD3, LOP3, SHF, SEL, the rest). Prints one line per
variant and per function and a JSON line of all times and counts.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CONSTANTS = ("kPairGroup", "kPairThreads", "kPairResident", "kPairUnroll", "kAdvTile")
K2_SHAPES = [(8, 256), (16, 256), (32, 256), (64, 256), (16, 128), (32, 128), (64, 128),
             (16, 512), (32, 512), (32, 64), (64, 64)]
K1_TILES = [32, 64, 128, 256]
# the paired K2's launch bounds (threads an SM: 512 caps it at 128 registers,
# 256 leaves it uncapped) and its backward loop's unrolling
K2_BOUNDS = [(256, 1), (256, 2), (512, 1), (512, 2), (768, 1)]


def shipped_constants(src):
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in CONSTANTS}


def variant_source(src, consts):
    for k, v in consts.items():
        src, n = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};", src)
        assert n == 1, k
    return src


def build(jobs, out_dir):
    """jobs: [(name, source text, include dir)] -> {name: (CDLL, ptxas log)}."""
    from keyhuntm1cpu_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, text, inc in jobs:
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = ([_build._nvcc()] + _build.NVCC_FLAGS + ["-shared", "-I", inc, "-o", so, cu])
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (ctypes.CDLL(so), log)
    return libs


PROBE = r"""
#include "fe.cuh"
#include "fe_walk.cuh"
extern "C" __global__ void probe_copy(kh::Fe* p) { p[2] = p[0]; }
extern "C" __global__ void probe_fe_mul(kh::Fe* p) { p[2] = kh::fe_mul(p[0], p[1]); }
extern "C" __global__ void probe_fe_sqr(kh::Fe* p) { p[2] = kh::fe_sqr(p[0]); }
extern "C" __global__ void probe_fe_sub(kh::Fe* p) { p[2] = kh::fe_sub(p[0], p[1]); }
extern "C" __global__ void probe_fw_mul(kh::Fe* p) { p[2] = kh::fw_mul(p[0], p[1]); }
extern "C" __global__ void probe_fw_sqr(kh::Fe* p) { p[2] = kh::fw_sqr(p[0]); }
extern "C" __global__ void probe_fw_sub(kh::Fe* p) { p[2] = kh::fw_sub(p[0], p[1]); }
extern "C" __global__ void probe_fw_canon_lo(kh::Fe* p) {
  kh::fw_canon_lo(p[0], p[2].v[0], p[2].v[1]);
}
// walk_blocks_kernel's work for one point: its dx and chain product in the
// forward pass; dx again, the two chain products, lambda, its square and x3
// in the backward pass
extern "C" __global__ void probe_point_iter(kh::Fe* p) {
  const kh::Fe tX = p[0], tY = p[1], bX = p[2], bY = p[3];
  kh::Fe inv = p[5];
  p[7] = kh::fw_mul(p[4], kh::fw_sub(tX, bX));
  const kh::Fe inv_j = kh::fw_mul(inv, p[6]);
  inv = kh::fw_mul(inv, kh::fw_sub(tX, bX));
  const kh::Fe lam = kh::fw_mul(kh::fw_sub(tY, bY), inv_j);
  kh::fw_canon_lo(kh::fw_sub(kh::fw_sub(kh::fw_sqr(lam), bX), tX), p[9].v[0], p[9].v[1]);
  p[8] = inv;
}
// walk_pairs_kernel's work for one pair (two points): the pair's dx and
// chain product forward; dx again, two chain products, both lambdas, their
// squares and both x3 backward
extern "C" __global__ void probe_pair_iter(kh::Fe* p) {
  const kh::Fe hX = p[0], hY = p[1], cX = p[2], cY = p[3], nY = p[10];
  kh::Fe inv = p[5];
  p[7] = kh::fw_mul(p[4], kh::fw_sub(hX, cX));
  const kh::Fe inv_j = kh::fw_mul(inv, p[6]);
  inv = kh::fw_mul(inv, kh::fw_sub(hX, cX));
  const kh::Fe lp = kh::fw_mul(kh::fw_sub(hY, cY), inv_j);
  const kh::Fe lm = kh::fw_mul(kh::fw_sub(nY, cY), inv_j);
  kh::fw_canon_lo(kh::fw_sub(kh::fw_sub(kh::fw_sqr(lp), cX), hX), p[9].v[0], p[9].v[1]);
  kh::fw_canon_lo(kh::fw_sub(kh::fw_sub(kh::fw_sqr(lm), cX), hX), p[9].v[2], p[9].v[3]);
  p[8] = inv;
}
"""
CLASSES = ("IMAD.WIDE", "IMAD", "IADD3", "LOP3", "SHF", "SEL")


def opcode_class(op):
    """IMAD.WIDE (a 32x32->64 product), IMAD, or the ALU classes by name."""
    if op.startswith("IMAD"):
        return "IMAD.WIDE" if ".WIDE" in op else "IMAD"
    head = op.split(".")[0]
    return head if head in CLASSES else "other"


def sass_counts(csrc, out_dir):
    """SASS instructions of one fe_mul, fe_sqr, fe_sub (csrc/fe.cuh),
    fw_mul, fw_sqr, fw_sub, fw_canon_lo (csrc/fe_walk.cuh) and one iteration
    of K2 a point a thread and paired: small kernels built for sm_90a
    (loads, the work, stores; and a plain copy),
    counted from cuobjdump -sass. Returns {kernel: (count less the copy's,
    {class: count less the copy's})}, classes by opcode_class."""
    from collections import Counter

    from keyhuntm1cpu_tpu_torch import _build

    src, cubin = os.path.join(out_dir, "fe_probe.cu"), os.path.join(out_dir, "fe_probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run([_build._nvcc(), "-cubin", "-O3", "-arch=sm_90a", "-I", csrc, "-o", cubin,
                    src], check=True, capture_output=True, timeout=300)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if name and m and m.group(1) not in ("NOP", "BRA"):
            counts[name][opcode_class(m.group(1))] += 1
    copy = counts.pop("probe_copy")
    return {k: (sum(c.values()) - sum(copy.values()),
                {cl: c[cl] - copy[cl] for cl in CLASSES + ("other",) if c[cl] - copy[cl]})
            for k, c in counts.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pwalk, tables
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.ref import ecref

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    with open(os.path.join(csrc, "pwalk.cu")) as f:
        src = f.read()
    ship = shipped_constants(src)
    name = lambda c: (f"G{c['kPairGroup']}_T{c['kPairThreads']}_R{c['kPairResident']}"
                      f"_U{c['kPairUnroll']}_A{c['kAdvTile']}")
    variants = {}
    for g, t in K2_SHAPES:
        c = dict(ship, kPairGroup=g, kPairThreads=t)
        variants[name(c)] = c
    for res, unroll in K2_BOUNDS:
        c = dict(ship, kPairResident=res, kPairUnroll=unroll)
        variants[name(c)] = c
    for a in K1_TILES:
        c = dict(ship, kAdvTile=a)
        variants[name(c)] = c
    jobs = [(name, variant_source(src, c), csrc) for name, c in variants.items()]
    serial_k1 = False  # the parent's K1 takes ADV and a scratch buffer
    bare_k2 = False  # the parent's K2 takes no bitmap
    unpaired = False  # the parent's K1 has no centre lanes, its K2 no pairs
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
        with open(os.path.join(pdir, "pwalk.cu")) as f:
            psrc = f.read()
        serial_k1 = "scratch" in psrc
        bare_k2 = "const void* words" not in psrc
        unpaired = "const void* hx" not in psrc
        jobs.append(("parent", psrc, pdir))
    out_dir = os.path.join(_build.build_dir(), "pwalk_shapes")
    libs = build(jobs, out_dir)
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (lib, _) in libs.items():
        old = name == "parent" and unpaired
        bare = name == "parent" and bare_k2
        n_k1 = (10 if name == "parent" and serial_k1 else 9) if old else 14
        lib.kh_advance_chain.argtypes = [vp] * n_k1 + [i, i, vp]
        n_k2 = (7 if bare else 9) if old else 14
        lib.kh_walk_blocks.argtypes = [vp] * n_k2 + [i64, i] + ([] if bare else [i]) + [vp]

    def limbs(v):
        return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)

    stream = torch.cuda.current_stream().cuda_stream
    stride = 2 * (1 << 28)  # the main path's m = 2^28: ADV = U*S, S = -stride*G
    main_s = ecref.point_neg(ecref.scalar_mult(stride))
    shapes = {"main": (main_s, cs.U), "build": (ecref.G, cs.BUILD_BLOCK)}

    def k1_case(T, K, kind):
        S, U = shapes[kind]
        adv = ecref.scalar_mult(U, S)
        pts = [ecref.scalar_mult(0x1234567890ABCDEF + 99991 * t) for t in range(T)]
        px = torch.stack([limbs(p[0]) for p in pts], 1).contiguous()
        py = torch.stack([limbs(p[1]) for p in pts], 1).contiguous()
        return (px, py, limbs(adv[0]), limbs(adv[1]), pwalk.adv_multiples(adv, K, dev),
                pwalk.centre_offsets(S, U, adv, K, dev))

    def k1_fn(lib, name, case, K):
        px, py, ax, ay, tab, ctab = case
        T = px.shape[1]
        outs = (torch.empty((8, T * K), dtype=torch.int32, device=dev),
                torch.empty((8, T * K), dtype=torch.int32, device=dev),
                torch.empty((8, T), dtype=torch.int32, device=dev),
                torch.empty((8, T), dtype=torch.int32, device=dev),
                torch.empty((T, K), dtype=torch.bool, device=dev))
        if name == "parent" and unpaired:
            if serial_k1:
                scratch = torch.empty((4, T * K, 8), dtype=torch.int32, device=dev)
                ins, extra = (px, py, ax, ay), (scratch,)
            else:
                ins, extra = (px, py) + tuple(tab), ()
            ptrs = [t.data_ptr() for t in ins + outs + extra]
        else:
            outs += (torch.empty((8, T * K), dtype=torch.int32, device=dev),
                     torch.empty((8, T * K), dtype=torch.int32, device=dev),
                     torch.empty((T * K,), dtype=torch.bool, device=dev))
            ptrs = [t.data_ptr() for t in (px, py, *tab, *outs[:5], *ctab, *outs[5:])]

        def run():
            rc = lib.kh_advance_chain(*ptrs, T, K, stream)
            if rc:
                raise RuntimeError(f"{name}: K1 launch failed ({rc})")
            return outs
        return run

    def k2_fn(lib, name, case):
        bx, by, tx, ty, bm, pairs = case
        R, U = bx.shape[1], tx.shape[1]
        outs = (torch.empty((R, U), dtype=torch.int32, device=dev),
                torch.empty((R, U), dtype=torch.int32, device=dev),
                torch.empty((R, U), dtype=torch.bool, device=dev))
        ptrs = [t.data_ptr() for t in (bx, by, tx, ty) + outs]
        old = name == "parent" and unpaired
        if bm is not None:
            if name == "parent" and bare_k2:
                return None
            outs += (torch.empty((R, -(-U // 32)), dtype=torch.int32, device=dev),)
            ptrs += [bm.words.data_ptr(), outs[3].data_ptr()]
        elif not (name == "parent" and bare_k2):
            ptrs += [None, None]
        if not old:
            ptrs += [t.data_ptr() for t in pairs]
        tail = [R, U] + ([] if name == "parent" and bare_k2 else
                         [0 if bm is None else bm.bits_log2])

        def run():
            rc = lib.kh_walk_blocks(*ptrs, *tail, stream)
            if rc:
                raise RuntimeError(f"{name}: K2 launch failed ({rc})")
            return outs
        return run

    k1_cases = {"K1 T=1 K=256": (k1_case(1, 256, "main"), 256),
                "K1 T=16 K=256": (k1_case(16, 256, "main"), 256),
                "K1 T=1 K=128 (build)": (k1_case(1, 128, "build"), 128)}
    k2_cases = {}
    for label, (R, kind, bits) in {"K2 R=256 U=16384": (256, "main", 0),
                                   "K2 R=256 U=16384 probe": (256, "main", 35),
                                   "K2 R=128 U=4096 (build)": (128, "build", 0)}.items():
        S, U_ = shapes[kind]
        adv = ecref.scalar_mult(U_, S)
        tx_, ty_ = tables.step_table(S, U_)
        pt = pwalk.pair_tables(S, U_, adv, R, dev)
        case = k1_case(1, R, kind)
        bx, by, _, _, _, cx, cy, cflag = pwalk.advance_chain(*case[:4], R, case[4], pt[2:])
        bm = None
        if bits:  # m = 2^28's density, 2^-7
            g = torch.Generator(device=dev).manual_seed(bits)
            words = torch.randint(-2**31, 2**31, (1 << (bits - 5),), dtype=torch.int32,
                                  device=dev, generator=g)
            for _ in range(6):
                words &= torch.randint(-2**31, 2**31, (1 << (bits - 5),), dtype=torch.int32,
                                       device=dev, generator=g)
            bm = bmp.DeviceBitmap(words, bits)
        k2_cases[label] = (bx, by, pwalk.table_to_limb_major(tx_, dev),
                           pwalk.table_to_limb_major(ty_, dev), bm,
                           (pt.pair_x, pt.pair_y, cx, cy, cflag))

    want = {}
    for label, (case, K) in k1_cases.items():
        want[label] = pwalk.advance_chain(*case[:4], K, case[4], case[5])
    for label, (bx, by, tx, ty, bm, pairs) in k2_cases.items():
        want[label] = pwalk.walk_blocks(bx, by, tx, ty, bm, pairs)
    torch.cuda.synchronize()

    times = {}
    row = {}  # the shipped library's K1 without centres, K2 a point a thread
    for label, (case, K) in k1_cases.items():
        ms, got = cs.device_ms(lambda: pwalk.advance_chain(*case[:4], K, case[4]), 20)
        if not all(torch.equal(g, w) for g, w in zip(got, want[label][:5])):
            cs.fail(f"shipped: {label} without the centres differs from with them")
        row[label + " (bases alone)"] = ms
    for label, (bx, by, tx, ty, bm, _) in k2_cases.items():
        ms, got = cs.device_ms(lambda: pwalk.walk_blocks(bx, by, tx, ty, bm), 20)
        if not all(torch.equal(g, w) for g, w in zip(got, want[label])):
            cs.fail(f"shipped: {label} a point a thread differs from the paired walk")
        row[label + " (a point a thread)"] = ms
    cs.log("shipped: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))
    times["shipped"] = row
    for name, (lib, log) in libs.items():
        old = name == "parent" and unpaired
        row = {}
        for label, (case, K) in k1_cases.items():
            run = k1_fn(lib, name, case, K)
            ms, got = cs.device_ms(run, 20)
            if not all(torch.equal(g, w) for g, w in zip(got, want[label])):
                cs.fail(f"{name}: {label} differs from the shipped kernel")
            row[label] = ms
        for label, case in k2_cases.items():
            run = k2_fn(lib, name, case)
            if run is None:
                continue
            ms, got = cs.device_ms(run, 20)
            if not all(torch.equal(g, w) for g, w in zip(got, want[label])):
                cs.fail(f"{name}: {label} differs from the shipped kernel")
            row[label] = ms
        regs = "; ".join(ln for ln in cs.ptxas_summary(log)
                         if ln.startswith(("advance_chain_kernel", "walk_blocks_kernel",
                                           "walk_pairs_kernel", "lone_point")))
        cs.log(f"{name}{' (unpaired)' if old else ''}: "
               + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()) + f" | {regs}")
        times[name] = row
    cs.log(f"shipped: G={ship['kPairGroup']}, threads={ship['kPairThreads']}, resident "
           f"{ship['kPairResident']}, unroll {ship['kPairUnroll']}, K1 tile={ship['kAdvTile']}; "
           f"card {card}")
    sass = sass_counts(csrc, out_dir)
    for fn, (n, ops) in sorted(sass.items()):
        cs.log(f"SASS {fn[6:]}: {n} instructions beyond the loads and stores, by class {ops}")
    point, pair = sass["probe_point_iter"][0], sass["probe_pair_iter"][0]
    cs.log(f"SASS a point: {point} a point a thread, {pair / 2:.1f} paired ({pair} a pair)")
    print(json.dumps({"card": card, "shipped": ship, "ms": times, "sass": sass}), flush=True)


if __name__ == "__main__":
    main()
