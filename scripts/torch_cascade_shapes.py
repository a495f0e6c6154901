#!/usr/bin/env python3
"""Time the BSGS chunk's cascade tail (csrc/probe.cu kh_bloom2_compact,
csrc/lookup.cu kh_bsgs_summary) on an NVIDIA GPU in other designs, each
held to the shipped kernels' outputs:

    python3 scripts/torch_cascade_shapes.py [--parent DIR]

1. The bloom2 stage with other keys a thread (kStage2Q = 1, 2, 4, 8; 8
   is the level-1 tile PR 16 used) and, at the shipped kStage2Q, a
   look-back of four status words a lane (kStage2Window = 4), at
   the main path's C1 = 34,816 stage-1 survivors (32,768 live) against a
   2^35-bit bloom2 of density 1/64 into C2 = 1,536, and at m = 2^30's C1 =
   134,656 (131,072 live, density 1/16).
2. The summary with the warp search at kSearchP = 1, 2, 4 keys a lane
   a level (32-, 64-, 128-ary) and with a binary search in its place
   (the same warp a survivor, each lane searching alone), in device
   resolve (C2 = 1,536, 512 survivors, 256 rows of U = 16,384, a 2^28-key
   table) and host resolve, with a warm L2 and after a 64 MB fill (a cold
   one, as a chunk's probe leaves it).
With --parent DIR (an earlier commit unpacked with git archive into a
gitignored directory), DIR's probe.cu and lookup.cu run the same inputs
in the same run, in turns with this tree's (parent, this, this, parent).
First, the time of a launch that does nothing much (the mask probe of one
key), the floor under every kernel timed here. Prints one line per
measurement and a JSON line of all times.
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

STAGE2_Q = (1, 2, 4, 8)
SEARCH_P = (1, 2, 4)
B, R, U = 1 << 22, 256, 16384  # the BSGS chunk's queries, rows and lanes (T = 1, K = 256)
SHAPES = {"main": (34816, 1536, 1 << 28), "m30": (134656, 1536, 1 << 30)}  # C1, C2, m
M_TABLE, N_SURV = 1 << 28, 512
# csrc/lookup.cu's search call, and a binary search in its place (each lane
# searching alone, the same answer on every lane)
SEARCH_CALL = r"warp_lower_bound\(key, m, q, lane\)"
BINARY = ("[&] { long long lo = 0, hi = m; while (lo < hi) { const long long mid = "
          "(lo + hi) >> 1; if (__ldg(key + mid) < q) lo = mid + 1; else hi = mid; } "
          "return lo; }()")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.filter import sorted_table as st
    from torch_pwalk_shapes import build

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    out = {"card": card}

    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    src = {n: open(os.path.join(csrc, n)).read() for n in ("probe.cu", "lookup.cu")}
    const = lambda name, text: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    shipped_q, shipped_p = const("kStage2Q", src["probe.cu"]), const("kSearchP", src["lookup.cu"])

    def variant(name, text, **consts):
        for k, v in consts.items():
            text, n = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};", text)
            assert n == 1, k
        return (name, text, csrc)

    jobs = [variant(f"stage2_Q{q}", src["probe.cu"], kStage2Q=q) for q in STAGE2_Q]
    jobs.append(variant(f"stage2_Q{shipped_q}_W4", src["probe.cu"], kStage2Window=4))
    jobs += [variant(f"summary_P{p}", src["lookup.cu"], kSearchP=p) for p in SEARCH_P]
    text, n = re.subn(SEARCH_CALL, lambda _: BINARY, src["lookup.cu"])
    assert n == 1, "the summary's search call"
    jobs.append(("summary_binary", text, csrc))
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
        for name in ("probe.cu", "lookup.cu"):
            jobs.append((f"parent_{name[:-3]}", open(os.path.join(pdir, name)).read(), pdir))
    # a parent from before the scratch pairs takes one scratch and memsets it
    one_scratch = any(name == "parent_probe" and "next_words" not in text
                      for name, text, _ in jobs)
    libs = {k: v[0] for k, v in build(jobs, os.path.join(_build.build_dir(),
                                                         "cascade_shapes")).items()}
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in libs.items():
        if name == "parent_probe" and one_scratch:
            lib.kh_bloom2_compact.argtypes = [vp] * 10 + [i64, i, i, i, vp]
            lib.kh_bloom2_compact.restype = i
        elif "stage2" in name or name == "parent_probe":
            lib.kh_bloom2_compact.argtypes = [vp] * 11 + [i64, i64, i, i, i, vp]
            lib.kh_bloom2_compact.restype = i
        else:
            lib.kh_bsgs_summary.argtypes = [vp] * 11 + [i64, i64, i, i, i, vp]
            lib.kh_bsgs_summary.restype = i
    st_ = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(30)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    flush = torch.empty((1 << 24,), dtype=torch.int32, device=dev)  # 64 MB, past the L2

    # 0. a launch alone: the mask probe of one key (one block of one thread)
    one = rnd(2)
    floor_ms, _ = cs.device_ms(lambda: bmp.probe(bmp.DeviceBitmap(one[:1], 5), one[1:], one[1:]),
                               50)
    cs.log(f"a launch alone (kh_probe, one key): {floor_ms:.4f} ms")
    out["launch_ms"] = floor_ms

    # 1. the bloom2 stage
    def stage_fn(name, b2, s1, c2):
        lib, c1 = libs[name], s1.pos.shape[0]
        outs = tuple(torch.empty((c2,), dtype=torch.int32, device=dev) for _ in range(3))
        cnt = torch.empty((), dtype=torch.int32, device=dev)
        pair = torch.zeros((2, 1 + -(-c1 // 128)), dtype=torch.int64, device=dev)
        turn = [0]

        def run():
            this, other = pair[turn[0]], pair[1 - turn[0]]
            scratch = ((this.data_ptr(),) if name == "parent_probe" and one_scratch
                       else (this.data_ptr(), other.data_ptr(), other.numel()))
            rc = lib.kh_bloom2_compact(b2.words.data_ptr(), s1.qhi.data_ptr(), s1.qlo.data_ptr(),
                                       s1.pos.data_ptr(), s1.n.data_ptr(),
                                       *[t.data_ptr() for t in outs], cnt.data_ptr(), *scratch,
                                       c1, b2.bits_log2, c2, B, st_)
            if rc:
                cs.fail(f"kh_bloom2_compact launch failed (cudaError {rc})")
            turn[0] ^= 1
            return outs + (cnt,)
        return run

    stage_names = [f"stage2_Q{q}" for q in STAGE2_Q] + [f"stage2_Q{shipped_q}_W4"]
    if args.parent:  # in turns with this tree's shipped form
        stage_names = ["parent_probe", f"stage2_Q{shipped_q}"] + stage_names + ["parent_probe"]
    out["bloom2_stage"] = {}
    for shape, (c1, c2, m) in SHAPES.items():
        live = B * m >> 35
        w = rnd(1 << 30)
        for _ in range(6 if shape == "main" else 3):  # density 1/64 (m = 2^28), 1/16 (2^30)
            w &= rnd(1 << 30)
        b2 = bmp.DeviceBloom2(w, 35)
        pos = torch.full((c1,), B, dtype=torch.int32, device=dev)
        pos[:live] = torch.sort(torch.randperm(B, device=dev, generator=g)[:live]).values.int()
        s1 = bmp.ProbeCompact(pos, rnd(c1), rnd(c1),
                              torch.tensor(live, dtype=torch.int32, device=dev))
        want = bmp.bloom2_compact(b2, s1, B, c2)
        row = {}
        for name in stage_names:
            ms, got = cs.device_ms(stage_fn(name, b2, s1, c2), 50)
            if cs.max_abs_err(got, want):
                cs.fail(f"bloom2 stage {name} differs from the shipped kernel ({shape})")
            row.setdefault(name, []).append(ms)
        cs.log(f"bloom2 stage, C1={c1} ({live} live) -> C2={c2}, 2^35 bits: "
               + ", ".join(f"{k} " + "/".join(f"{v:.4f}" for v in vs) for k, vs in row.items())
               + f" ms (shipped kStage2Q = {shipped_q}; equal outputs)")
        out["bloom2_stage"][shape] = row
        del b2, w, s1, pos, want
        torch.cuda.empty_cache()

    # 2. the summary
    key = torch.sort((rnd(M_TABLE).to(torch.int64) << 32)
                     | (rnd(M_TABLE).to(torch.int64) & 0xFFFFFFFF)).values
    table = st.SortedXTable(key, torch.arange(1, M_TABLE + 1, dtype=torch.int32, device=dev))
    c2 = SHAPES["main"][1]
    pos = torch.full((c2,), B, dtype=torch.int32, device=dev)
    pos[:N_SURV] = torch.sort(torch.randperm(B, device=dev, generator=g)[:N_SURV]).values.int()
    hh, hl = st.key_words(key[torch.randint(0, M_TABLE, (c2,), device=dev, generator=g)])
    hit = torch.arange(c2, device=dev) % 2 == 1
    qh = torch.where(hit, hh, rnd(c2)).contiguous()
    ql = torch.where(hit, hl, rnd(c2)).contiguous()
    cnt = torch.tensor(N_SURV, dtype=torch.int32, device=dev)
    deg = torch.rand((R, U), device=dev, generator=g) < 1e-4
    adv = torch.zeros((R,), dtype=torch.bool, device=dev)
    adv[::64] = True
    out_t = torch.empty((3 * c2 + 3 * R + 1,), dtype=torch.int32, device=dev)

    def summary_fn(lib, tab):
        k, ix = (None, None) if tab is None else (tab.key.data_ptr(), tab.idx.data_ptr())

        def run():
            rc = lib.kh_bsgs_summary(pos.data_ptr(), qh.data_ptr(), ql.data_ptr(),
                                     cnt.data_ptr(), k, ix, deg.data_ptr(), adv.data_ptr(),
                                     deg.data_ptr(), adv.data_ptr(), out_t.data_ptr(),
                                     M_TABLE, B, c2, R, U, st_)
            if rc:
                cs.fail(f"kh_bsgs_summary launch failed (cudaError {rc})")
            return out_t
        return run

    names = [f"summary_P{p}" for p in SEARCH_P] + ["summary_binary"]
    if args.parent:  # in turns with this tree's shipped form
        names = ["parent_lookup", f"summary_P{shipped_p}"] + names + ["parent_lookup"]
    out["summary"] = {}
    for form, tab in (("device", table), ("host", None)):
        want = bsgs.chunk_summary_ref(tab, pos, qh, ql, cnt, deg, adv, (deg, adv))
        row = {}
        for name in names:
            fn = summary_fn(libs[name], tab)
            ms, got = cs.device_ms(fn, 50)
            if cs.max_abs_err([got], [want]):
                cs.fail(f"summary {name} differs from the plain version ({form})")
            row.setdefault(name, []).append((ms, cs.cold_ms(fn, flush)))
        cs.log(f"summary, {form} resolve, C2={c2} ({N_SURV} survivors) over {R} rows of "
               f"U={U}" + (f" and 2^{M_TABLE.bit_length() - 1} keys" if tab is not None else "")
               + ": " + ", ".join(f"{k} " + "/".join(f"{a:.4f} (cold {b:.4f})" for a, b in vs)
                                  for k, vs in row.items()) + " ms (equal to the plain version)")
        out["summary"][form] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
