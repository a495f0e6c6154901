#!/usr/bin/env python3
"""Time the BSGS chunk's level-1 stage with its probe inside K2 on an
NVIDIA GPU: K2 with the probe (csrc/pwalk.cu kh_walk_blocks given a
bitmap) and the compaction of its survivor mask (csrc/probe.cu
kh_mask_compact), against the pair it replaced in the chunk (K2 alone and
kh_probe_compact), at the BSGS cell's shape.

    python3 scripts/torch_fused_probe_shapes.py [--parent DIR]

1. The shipped kernels at R = 256 rows (K1's bases at K = 256), U = 16,384
   columns and a 2^35-bit bitmap of m = 2^28's density (2^-7): K2 alone,
   K2 with the probe, kh_probe_compact and kh_mask_compact into C1 =
   34,816, held equal word for word; then the five launches of a host
   chunk each way (K1, K2, the level-1 stage, the bloom2 stage against a
   2^35-bit bloom2 into C2 = 1,536, kh_bsgs_summary without a table).
2. kh_mask_compact's shapes: copies of csrc/probe.cu with other
   kMaskCompactQ (mask words a thread: 1, 2, 4, 8) and kMaskCompactWindow
   (status words a lane a step of the look-back: 1, 4), built by nvcc
   (all in parallel) and called through ctypes, each held to the shipped
   kernel's output on K2's mask and timed.
3. K2's shapes: a copy of csrc/pwalk.cu whose probing K2 is held to 4
   blocks an SM (__launch_bounds__ with a minimum, at most 128 registers)
   and one that tests each word in the iteration that read it (no
   deferral), each held to the shipped K2 and timed, with ptxas's
   registers and spills.
With --parent DIR (an earlier commit unpacked with git archive into a
gitignored directory), DIR's csrc/pwalk.cu and csrc/probe.cu time K2 and
kh_probe_compact in the same run. Every time is chip_smoke.device_ms (the
card's time of back-to-back launches). Prints one line per measurement
and a JSON line of all times.
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

R, U, BITS, C1, C2 = 256, 16384, 35, 34816, 1536
MASK_SHAPES = [(2, 1), (1, 1), (4, 1), (8, 1), (2, 4), (4, 4), (8, 4)]  # shipped first
REPS = 20


def mask_variant(src, q, window):
    for name, v in (("kMaskCompactQ", q), ("kMaskCompactWindow", window)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", src)
        assert n == 1, name
    return src


def k2_variant(src, kind):
    """pwalk.cu with its probing K2 held to 4 blocks an SM ("min4") or
    testing each word where it is read ("nodefer")."""
    head = "template <bool PROBE>\n__global__ void __launch_bounds__(kWalkThreads"
    if kind == "min4":
        assert head + ")" in src, kind
        return src.replace(head + ")", head + ", 4)")
    old = re.search(r"      if \(j < n - 1\) \{  // row j \+ 1's word.*?\n      \}\n", src, re.S)
    assert old, kind
    src = src.replace(old.group(0), "")
    now = ("      {\n"
           "        const unsigned hit = __ballot_sync(live, (word >> bit) & 1u);\n"
           "        if ((i & 31) == 0) mask[(r0 + j) * W + (u >> 5)] = hit;\n"
           "      }\n")
    src, n = re.subn(r"(      bit = x3\.v\[0\] & 31u;\n)", lambda m: m.group(1) + now, src)
    assert n == 1, kind
    src, n = re.subn(r"  if constexpr \(PROBE\) \{\n    if \(n\) \{  // row 0's.*?\n    \}\n"
                     r"  \}\n", "", src, flags=re.S)
    assert n == 1, kind
    return src


class Scratch:
    """Two zeroed scratches a compact kernel takes turns on (ScratchPairs'
    discipline for a library the package does not load)."""

    def __init__(self, words, dev):
        import torch

        self.buf = torch.zeros((2, words), dtype=torch.int64, device=dev)
        self.turn = 0

    def args(self):
        a = (self.buf[self.turn].data_ptr(), self.buf[1 - self.turn].data_ptr(),
             self.buf.shape[1])
        self.turn = 1 - self.turn
        return a


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pwalk, tables
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from torch_probe_shapes import random_filter
    from torch_pwalk_shapes import build

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    out = {"card": card}
    lim = lambda v: torch.from_numpy(fe.int_to_limbs(v).view("int32").copy()).to(dev)

    # 1. the shipped kernels at the cell's shape
    s_pt = ecref.point_neg(ecref.scalar_mult(1 << 29))
    tab_x, tab_y = tables.step_table(s_pt, U)
    tx, ty = pwalk.table_to_limb_major(tab_x, dev), pwalk.table_to_limb_major(tab_y, dev)
    adv = ecref.point_neg(ecref.scalar_mult(U << 29))
    ax, ay = lim(adv[0]), lim(adv[1])
    adv_tab = pwalk.adv_multiples(adv, R, dev)
    p0 = ecref.scalar_mult(0x7CCE5EFDACCF6808)
    px, py = lim(p0[0])[None], lim(p0[1])[None]
    bx, by, _, _, _ = pwalk.advance_chain(px.t().contiguous(), py.t().contiguous(), ax, ay, R,
                                          adv_tab)
    bm = bmp.DeviceBitmap(random_filter(BITS, 7, dev, 1), BITS)
    b2 = bmp.DeviceBloom2(random_filter(BITS, 6, dev, 2), BITS)
    ms = {}
    ms["K2 alone"], (qlo, qhi, deg) = cs.device_ms(lambda: pwalk.walk_blocks(bx, by, tx, ty),
                                                   REPS)
    ms["K2 with the probe"], fused = cs.device_ms(
        lambda: pwalk.walk_blocks(bx, by, tx, ty, bm), REPS)
    mask = fused[3]
    fq = (qhi.reshape(-1), qlo.reshape(-1))
    ms["kh_probe_compact"], want = cs.device_ms(lambda: bmp.probe_compact(bm, *fq, C1), REPS)
    ms["kh_mask_compact"], got = cs.device_ms(lambda: bmp.mask_compact(mask, *fq, C1), REPS)
    err = cs.max_abs_err(fused[:3], (qlo, qhi, deg)) + cs.max_abs_err(got, want)
    if err:
        cs.fail(f"K2 with the probe or kh_mask_compact differs from the unfused pair ({err})")

    def chunk(fused_form):
        kx, ky, _, _, ad = pwalk.advance_chain(px.t().contiguous(), py.t().contiguous(), ax, ay,
                                               R, adv_tab)
        walk = pwalk.walk_blocks(kx, ky, tx, ty, bm if fused_form else None)
        q = (walk[1].reshape(-1), walk[0].reshape(-1))
        s1 = (bmp.mask_compact(walk[3], *q, C1) if fused_form
              else bmp.probe_compact(bm, *q, C1))
        fs = bmp.bloom2_compact(b2, s1, R * U, C2)
        ad = ad.reshape(-1)
        return bsgs.chunk_summary_host(*fs, walk[2], ad, (walk[2], ad))

    ms["chunk, probe in K2"], c_new = cs.device_ms(lambda: chunk(True), REPS)
    ms["chunk, K2 + kh_probe_compact"], c_old = cs.device_ms(lambda: chunk(False), REPS)
    if cs.max_abs_err([c_new], [c_old]):
        cs.fail("the chunk through K2's probe differs from the unfused chunk's summary")
    n1 = int(want.n)
    cs.log(f"R={R} U={U} 2^{BITS} bits, {n1} level-1 survivors (C1={C1}): "
           + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    out["shipped"] = ms | {"survivors": n1}

    # 2. kh_mask_compact's shapes; 3. K2's
    with open(os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc", "probe.cu")) as f:
        probe_src = f.read()
    with open(os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc", "pwalk.cu")) as f:
        pwalk_src = f.read()
    inc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    jobs = [(f"mask_q{q}_w{w}", mask_variant(probe_src, q, w), inc) for q, w in MASK_SHAPES]
    jobs += [(f"k2_{kind}", k2_variant(pwalk_src, kind), inc) for kind in ("min4", "nodefer")]
    if args.parent:
        pinc = os.path.join(args.parent, "keyhuntm1cpu_tpu_torch", "csrc")
        for name in ("pwalk", "probe"):
            with open(os.path.join(pinc, f"{name}.cu")) as f:
                jobs.append((f"parent_{name}", f.read(), pinc))
    libs = build(jobs, os.path.join(_build.build_dir(), "fused_probe_shapes"))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = torch.cuda.current_stream().cuda_stream
    res = {}
    for (q, w) in MASK_SHAPES:
        lib, log = libs[f"mask_q{q}_w{w}"]
        lib.kh_mask_compact.argtypes = [vp] * 9 + [i64, i64, i, i, vp]
        lib.kh_probe_tile.argtypes = [i]
        tile = lib.kh_probe_tile(2)
        sc = Scratch(1 + -(-mask.numel() // tile), dev)
        pos, ohi, olo = (torch.empty(C1, dtype=torch.int32, device=dev) for _ in range(3))
        n = torch.empty((), dtype=torch.int32, device=dev)

        def run(lib=lib, sc=sc, pos=pos, ohi=ohi, olo=olo, n=n):
            rc = lib.kh_mask_compact(mask.data_ptr(), fq[0].data_ptr(), fq[1].data_ptr(),
                                     pos.data_ptr(), ohi.data_ptr(), olo.data_ptr(),
                                     n.data_ptr(), *sc.args(), R, U, C1, st)
            if rc:
                cs.fail(f"kh_mask_compact q={q} w={w}: cudaError {rc}")
            return pos, ohi, olo, n

        t, vout = cs.device_ms(run, REPS)
        if cs.max_abs_err(vout, want):
            cs.fail(f"kh_mask_compact q={q} w={w} differs from the shipped kernel")
        res[f"q{q}_w{w}"] = t
        cs.log(f"kh_mask_compact kMaskCompactQ={q} kMaskCompactWindow={w} ({tile} words a "
               f"tile, {-(-mask.numel() // tile)} tiles): {t:.4f} ms, equal to the shipped")
    out["mask_compact"] = res

    def ptxas(log):
        """[(K2's mangled name, spill store bytes, registers)] from ptxas -v."""
        return re.findall(r"Compiling entry function '(\w*walk_blocks_kernel\w*)'.*?"
                          r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)

    k2 = {}
    for kind in ("min4", "nodefer"):
        lib, log = libs[f"k2_{kind}"]
        lib.kh_walk_blocks.argtypes = [vp] * 14 + [i64, i, i, vp]  # no pairs: a point a thread
        q_lo, q_hi = torch.empty_like(qlo), torch.empty_like(qhi)
        d, m_ = torch.empty_like(deg), torch.empty_like(mask)

        def run(lib=lib, q_lo=q_lo, q_hi=q_hi, d=d, m_=m_):
            rc = lib.kh_walk_blocks(bx.data_ptr(), by.data_ptr(), tx.data_ptr(), ty.data_ptr(),
                                    q_lo.data_ptr(), q_hi.data_ptr(), d.data_ptr(),
                                    bm.words.data_ptr(), m_.data_ptr(), *[None] * 5, R, U,
                                    BITS, st)
            if rc:
                cs.fail(f"K2 {kind}: cudaError {rc}")
            return q_lo, q_hi, d, m_

        t, vout = cs.device_ms(run, REPS)
        if cs.max_abs_err(vout, fused):
            cs.fail(f"K2 {kind} differs from the shipped K2 with the probe")
        k2[kind] = t
        cs.log(f"K2 with the probe, {kind}: {t:.4f} ms, equal to the shipped (ptxas: "
               f"{ptxas(log)})")
    regs = ptxas(_build.kernels_build_log())
    cs.log(f"shipped K2 (ptxas: name, spill store bytes, registers): {regs}")
    out["k2"] = k2 | {"shipped_ptxas": regs}
    if args.parent:
        plib = libs["parent_pwalk"][0]
        plib.kh_walk_blocks.argtypes = [vp] * 7 + [i64, i, vp]
        q_lo, q_hi, d = torch.empty_like(qlo), torch.empty_like(qhi), torch.empty_like(deg)

        def parent_k2():
            rc = plib.kh_walk_blocks(bx.data_ptr(), by.data_ptr(), tx.data_ptr(), ty.data_ptr(),
                                     q_lo.data_ptr(), q_hi.data_ptr(), d.data_ptr(), R, U, st)
            if rc:
                cs.fail(f"the parent's K2: cudaError {rc}")
            return q_lo, q_hi, d

        t_k2, pout = cs.device_ms(parent_k2, REPS)
        if cs.max_abs_err(pout, (qlo, qhi, deg)):
            cs.fail("the parent's K2 differs from K2 alone")
        qlib = libs["parent_probe"][0]
        qlib.kh_probe_compact.argtypes = [vp] * 9 + [i64, i64, i, i, vp]
        qlib.kh_probe_tile.argtypes = [i]
        sc = Scratch(1 + -(-fq[0].numel() // qlib.kh_probe_tile(0)), dev)
        pos, ohi, olo = (torch.empty(C1, dtype=torch.int32, device=dev) for _ in range(3))
        n = torch.empty((), dtype=torch.int32, device=dev)

        def parent_probe():
            rc = qlib.kh_probe_compact(bm.words.data_ptr(), fq[0].data_ptr(), fq[1].data_ptr(),
                                       pos.data_ptr(), ohi.data_ptr(), olo.data_ptr(),
                                       n.data_ptr(), *sc.args(), fq[0].numel(), BITS, C1, st)
            if rc:
                cs.fail(f"the parent's kh_probe_compact: cudaError {rc}")
            return pos, ohi, olo, n

        t_pr, pout = cs.device_ms(parent_probe, REPS)
        if cs.max_abs_err(pout, want):
            cs.fail("the parent's kh_probe_compact differs from the shipped one")
        out["parent"] = {"K2": t_k2, "kh_probe_compact": t_pr}
        cs.log(f"parent ({args.parent}): K2 {t_k2:.4f} ms, kh_probe_compact {t_pr:.4f} ms")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
