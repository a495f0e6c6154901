#!/usr/bin/env python3
"""Time the port's BSGS walk kernels (csrc/pwalk.cu: K1 advance chain, K2
walk blocks) over their compile-time shapes on an NVIDIA GPU, and count
the SASS of the field arithmetic each runs.

    python3 scripts/torch_pwalk_shapes.py [--parent DIR]

Each variant is a copy of csrc/pwalk.cu with other values of kWalkGroup
(K2's rows per thread G), kWalkThreads (K2's threads per block) and
kAdvTile (K1's lanes per block), built by nvcc into the gitignored build
directory and loaded with ctypes. Every variant's outputs are held to the
shipped kernels' (pwalk.advance_chain / walk_blocks) on the same inputs,
then timed by chip_smoke.device_ms at the main path's shapes (K1 at T = 1,
K = 256 and T = 16, K = 256; K2 at R = 256, U = 16384, alone and with
the BSGS chunk's level-1 probe of a 2^35-bit bitmap) and the filter
build's (K1 at K = 128, K2 at R = 128, U = 4096), beside ptxas's
registers and spills. With --parent DIR, DIR is another tree (an
unpacked earlier commit, whose K1 may be the serial chain that takes ADV
and a scratch buffer, and whose K2 may take no bitmap) whose
csrc/pwalk.cu and fe.cuh are timed the same way in the same run. Then it
counts the SASS instructions (cuobjdump -sass) of one fe_mul, fe_sqr and
fe_sub of csrc/fe.cuh and one fw_mul, fw_sqr, fw_sub and fw_canon_lo of
csrc/fe_walk.cuh (K2's own), by opcode class (IMAD.WIDE, IMAD, IADD3,
LOP3, SHF, SEL, the rest). Prints one line per variant and per function
and a JSON line of all times and counts.
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

CONSTANTS = ("kWalkGroup", "kWalkThreads", "kAdvTile")
K2_SHAPES = [(8, 128), (16, 128), (32, 128), (64, 128), (16, 256), (32, 256),
             (32, 64), (64, 64), (128, 64), (64, 256), (64, 512), (32, 512)]
K1_TILES = [32, 64, 128, 256]


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
"""
CLASSES = ("IMAD.WIDE", "IMAD", "IADD3", "LOP3", "SHF", "SEL")


def opcode_class(op):
    """IMAD.WIDE (a 32x32->64 product), IMAD, or the ALU classes by name."""
    if op.startswith("IMAD"):
        return "IMAD.WIDE" if ".WIDE" in op else "IMAD"
    head = op.split(".")[0]
    return head if head in CLASSES else "other"


def sass_counts(csrc, out_dir):
    """SASS instructions of one fe_mul, fe_sqr, fe_sub (csrc/fe.cuh) and
    fw_mul, fw_sqr, fw_sub, fw_canon_lo (csrc/fe_walk.cuh): one-line
    kernels built for sm_90a (load, the function, store; and a plain copy),
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
    variants = {}
    for g, t in K2_SHAPES:
        variants[f"G{g}_T{t}_A{ship['kAdvTile']}"] = dict(ship, kWalkGroup=g, kWalkThreads=t)
    for a in K1_TILES:
        variants[f"G{ship['kWalkGroup']}_T{ship['kWalkThreads']}_A{a}"] = dict(ship, kAdvTile=a)
    jobs = [(name, variant_source(src, c), csrc) for name, c in variants.items()]
    serial_k1 = False  # the parent's K1 takes ADV and a scratch buffer
    bare_k2 = False  # the parent's K2 takes no bitmap
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
        with open(os.path.join(pdir, "pwalk.cu")) as f:
            psrc = f.read()
        serial_k1 = "scratch" in psrc
        bare_k2 = "const void* words" not in psrc
        jobs.append(("parent", psrc, pdir))
    out_dir = os.path.join(_build.build_dir(), "pwalk_shapes")
    libs = build(jobs, out_dir)
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (lib, _) in libs.items():
        n_k1 = 10 if name == "parent" and serial_k1 else 9
        lib.kh_advance_chain.argtypes = [vp] * n_k1 + [i, i, vp]
        bare = name == "parent" and bare_k2
        lib.kh_walk_blocks.argtypes = [vp] * (7 if bare else 9) + [i64, i] + ([] if bare else [i]) + [vp]

    def limbs(v):
        return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)

    stream = torch.cuda.current_stream().cuda_stream

    def k1_case(T, K, adv):
        pts = [ecref.scalar_mult(0x1234567890ABCDEF + 99991 * t) for t in range(T)]
        px = torch.stack([limbs(p[0]) for p in pts], 1).contiguous()
        py = torch.stack([limbs(p[1]) for p in pts], 1).contiguous()
        ax, ay = limbs(adv[0]), limbs(adv[1])
        tab = pwalk.adv_multiples(adv, K, dev)
        return px, py, ax, ay, tab

    def k1_fn(lib, name, case, K):
        px, py, ax, ay, tab = case
        T = px.shape[1]
        outs = (torch.empty((8, T * K), dtype=torch.int32, device=dev),
                torch.empty((8, T * K), dtype=torch.int32, device=dev),
                torch.empty((8, T), dtype=torch.int32, device=dev),
                torch.empty((8, T), dtype=torch.int32, device=dev),
                torch.empty((T, K), dtype=torch.bool, device=dev))
        if name == "parent" and serial_k1:
            scratch = torch.empty((4, T * K, 8), dtype=torch.int32, device=dev)
            ins, extra = (px, py, ax, ay), (scratch,)
        else:
            ins, extra = (px, py) + tuple(tab), ()
        ptrs = [t.data_ptr() for t in ins + outs + extra]

        def run():
            rc = lib.kh_advance_chain(*ptrs, T, K, stream)
            if rc:
                raise RuntimeError(f"{name}: K1 launch failed ({rc})")
            return outs
        return run

    def k2_fn(lib, name, case):
        bx, by, tx, ty, bm = case
        R, U = bx.shape[1], tx.shape[1]
        outs = (torch.empty((R, U), dtype=torch.int32, device=dev),
                torch.empty((R, U), dtype=torch.int32, device=dev),
                torch.empty((R, U), dtype=torch.bool, device=dev))
        ptrs = [t.data_ptr() for t in (bx, by, tx, ty) + outs]
        if bm is not None:
            if name == "parent" and bare_k2:
                return None
            outs += (torch.empty((R, -(-U // 32)), dtype=torch.int32, device=dev),)
            args = ptrs + [bm.words.data_ptr(), outs[3].data_ptr(), R, U, bm.bits_log2]
        elif name == "parent" and bare_k2:
            args = ptrs + [R, U]
        else:
            args = ptrs + [None, None, R, U, 0]

        def run():
            rc = lib.kh_walk_blocks(*args, stream)
            if rc:
                raise RuntimeError(f"{name}: K2 launch failed ({rc})")
            return outs
        return run

    stride = 2 * (1 << 28)  # the main path's m = 2^28: ADV = U*S, S = -stride*G
    adv = ecref.point_neg(ecref.scalar_mult(cs.U * stride))
    build_adv = ecref.scalar_mult(cs.BUILD_BLOCK)  # the filter build's ADV = Ub*G
    k1_cases = {"K1 T=1 K=256": (k1_case(1, 256, adv), 256),
                "K1 T=16 K=256": (k1_case(16, 256, adv), 256),
                "K1 T=1 K=128 (build)": (k1_case(1, 128, build_adv), 128)}
    k2_cases = {}
    for label, (R, U_, s_pt, bits) in {
            "K2 R=256 U=16384": (256, cs.U, ecref.point_neg(ecref.scalar_mult(stride)), 0),
            "K2 R=256 U=16384 probe": (256, cs.U, ecref.point_neg(ecref.scalar_mult(stride)),
                                       35),
            "K2 R=128 U=4096 (build)": (128, cs.BUILD_BLOCK, ecref.G, 0)}.items():
        tx_, ty_ = tables.step_table(s_pt, U_)
        (px, py, ax, ay, tab), _ = k1_cases["K1 T=1 K=256"]
        bx, by, _, _, _ = pwalk.advance_chain(px[:, :1].contiguous(), py[:, :1].contiguous(),
                                              ax, ay, R)
        # dx == 0 at the first and last thread of a block and in the last row
        for row, u in ((0, 0), (R // 2, 127), (R - 1, U_ - 1)):
            bx[:, row] = limbs(fe.limbs_to_int(tx_[u]))
            by[:, row] = limbs(fe.limbs_to_int(ty_[u]))
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
                           pwalk.table_to_limb_major(ty_, dev), bm)

    want = {}
    for label, (case, K) in k1_cases.items():
        want[label] = pwalk.advance_chain(*case[:4], K, case[4])
    for label, (bx, by, tx, ty, bm) in k2_cases.items():
        want[label] = pwalk.walk_blocks(bx, by, tx, ty, bm)
    torch.cuda.synchronize()

    times = {}
    for name, (lib, log) in libs.items():
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
                         if ln.startswith(("advance_chain_kernel", "walk_blocks_kernel")))
        cs.log(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
               + f" | {regs}")
        times[name] = row
    cs.log(f"shipped: G={ship['kWalkGroup']}, threads={ship['kWalkThreads']}, "
           f"K1 tile={ship['kAdvTile']}; card {card}")
    sass = sass_counts(csrc, out_dir)
    for fn, (n, ops) in sorted(sass.items()):
        cs.log(f"SASS {fn[6:]}: {n} instructions beyond a load and store, by class {ops}")
    print(json.dumps({"card": card, "shipped": ship, "ms": times, "sass": sass}), flush=True)


if __name__ == "__main__":
    main()
