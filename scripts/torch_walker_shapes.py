#!/usr/bin/env python3
"""Time the walker step's kernels on an NVIDIA GPU: walk_prefix in its
designs, the walk with and without stored prefixes, the step's lookup and
summary against the torch ops it replaced, and the whole walker chunk.

    python3 scripts/torch_walker_shapes.py [--parent DIR] [--chunk]

At the walker's main-path shape (W = 8, U = 4096, L = 32, rmd160, C = 256;
chip_smoke.py's phase 4c):
1. walk_prefix: the shipped kernel (csrc/walk.cu: a warp per chain, each
   segment staged in shared memory and written out by the block's 4
   chains together), the same with 8 chains a block, the warp scan
   storing from each lane, a thread per chain (the design before the
   warp scan, kept here as kh_walk_prefix_thread), the warp scan with no
   prefix stores (the stores' share) and, with --parent DIR (an earlier
   commit unpacked with git archive into a gitignored directory), DIR's
   csrc/walk.cu; each held to the shipped output (the variants also at
   L = 7, 33, 64, 65).
2. The walk without stored prefixes (L <= 32): kh_walk_totals writes the
   chain totals alone and kh_walk_emit_nopre takes each element's
   exclusive prefix from a second warp scan in place of the stored one.
   walk_prefix + pinv + walk_emit against walk_totals + pinv +
   walk_emit_nopre, outputs held equal, and each launch alone.
3. The lookup and summary: sorted_table.lookup_summary (the kernel)
   against lookup_summary_ref (the torch ops the walker step ran before:
   torch.searchsorted, gathers, masks, sum, argmax, cat) and
   sorted_table.lookup alone, on chip_smoke.walker_lookup_inputs (256
   survivor slots over 2^22 keys), and the kernel at C = 1, W = 1 (one
   search: its latency floor); card time (chip_smoke.device_ms) and the
   host's time to enqueue a call. Then the kernel's designs on the same
   inputs, warm and after a 64 MB fill (cold L2), each launched through
   ctypes and held to the shipped row: the shipped grid (a warp a
   survivor, 32-ary search; groups of threads a walker row), the same
   grid with a binary search in each lane (torch_cascade_shapes.BINARY)
   and, with --parent, DIR's csrc/lookup.cu, in turns (parent, shipped,
   binary, shipped, parent), at C = 256, W = 8 and at C = 1, W = 1.
4. With --chunk: the walker chunk (K = 8 steps) of this tree and, with
   --parent, of DIR, each in a process of its own run from its tree, in
   the order parent, this, this, parent (this, this without --parent),
   at T = 2^22 random hash160 targets: the device operations of a chunk
   (torch.profiler), the host's enqueue and the card's time a chunk, and
   the effective keys/s and wall time a chunk over 3 s of
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

W, U, L, C = 8, 4096, 32, 256  # chip_smoke.py's WK_W, WK_U, WK_L and cand_max
T_CHUNK = 1 << 22  # targets of the chunk comparison (chip_smoke.py's WK_T)

VARIANTS = r"""
#include "walk.cu"

namespace {

// walk_prefix as a thread per chain: L dependent products a thread
__global__ void __launch_bounds__(kThreads)
walk_prefix_thread_kernel(WalkArgs a, uint32_t* __restrict__ pre, uint32_t* __restrict__ totals) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.C) return;
  const long long n = a.C * a.L;
  Fe acc = denominator(a, c);
  kh::fe_store_lm(pre, n, c, acc);
  for (int l = 1; l < a.L; l++) {
    const long long i = (long long)l * a.C + c;
    acc = kh::fe_mul(acc, denominator(a, i));
    kh::fe_store_lm(pre, n, i, acc);
  }
  kh::fe_store_lm(totals, a.C, c, acc);
}

// the shipped warp scan with the prefix stores left out (totals only): the
// stores' share of the kernel
__global__ void __launch_bounds__(kThreads)
walk_prefix_nostore_kernel(WalkArgs a, uint32_t* __restrict__ totals) {
  const long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= a.C) return;
  Fe running = kh::fe_one();
  for (int lo = 0; lo < a.L; lo += 32) {
    const int l = lo + lane;
    Fe p = l < a.L ? denominator(a, (long long)l * a.C + c) : kh::fe_one();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Fe below = shfl_up_fe(p, d);
      if (lane >= d) p = kh::fe_mul(below, p);
    }
    if (lo > 0) p = kh::fe_mul(running, p);
    if (l == a.L - 1) kh::fe_store_lm(totals, a.C, c, p);
    running = shfl_fe(p, 31);
  }
}

// the warp scan storing each prefix straight from its lane (one word a
// lane, C*4 bytes apart)
__global__ void __launch_bounds__(kThreads)
walk_prefix_direct_kernel(WalkArgs a, uint32_t* __restrict__ pre, uint32_t* __restrict__ totals) {
  const long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= a.C) return;
  const long long n = a.C * a.L;
  Fe running = kh::fe_one();
  for (int lo = 0; lo < a.L; lo += 32) {
    const int l = lo + lane;
    const bool act = l < a.L;
    const long long i = (long long)l * a.C + c;
    Fe p = act ? denominator(a, i) : kh::fe_one();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Fe below = shfl_up_fe(p, d);
      if (lane >= d) p = kh::fe_mul(below, p);
    }
    if (lo > 0) p = kh::fe_mul(running, p);
    if (act) kh::fe_store_lm(pre, n, i, p);
    if (l == a.L - 1) kh::fe_store_lm(totals, a.C, c, p);
    running = shfl_fe(p, 31);
  }
}

// the chain totals alone (L <= 32: one segment a warp), a warp reduction
__global__ void __launch_bounds__(kThreads)
walk_totals_kernel(WalkArgs a, uint32_t* __restrict__ totals) {
  const long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= a.C) return;
  Fe p = lane < a.L ? denominator(a, (long long)lane * a.C + c) : kh::fe_one();
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) p = kh::fe_mul(p, shfl_down_fe(p, d));
  if (lane == 0) kh::fe_store_lm(totals, a.C, c, p);
}

// walk_emit for L <= 32 without stored prefixes: the products below each
// element from a warp scan up, beside the scan down for those above it
__global__ void __launch_bounds__(kThreads)
walk_emit_nopre_kernel(WalkArgs a, const uint32_t* __restrict__ inv_totals, EmitOut o) {
  const long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= a.C) return;
  const long long D = (long long)a.W * (a.U + 2);
  const bool act = lane < a.L;
  const long long i = (long long)lane * a.C + c;
  const Fe den = act ? denominator(a, i) : kh::fe_one();
  Fe suf = den, pre = den;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Fe up = shfl_down_fe(suf, d);
    const Fe dn = shfl_up_fe(pre, d);
    if (lane + d < 32) suf = kh::fe_mul(suf, up);
    if (lane >= d) pre = kh::fe_mul(dn, pre);
  }
  Fe above = shfl_down_fe(suf, 1);
  if (lane == 31) above = kh::fe_one();
  const Fe below = shfl_up_fe(pre, 1);
  if (act) {
    Fe inv = kh::fe_mul(kh::fe_load_lm(inv_totals, a.C, c), above);
    if (lane > 0) inv = kh::fe_mul(inv, below);
    if (i < D) emit(a, o, i, inv);
  }
}

}  // namespace

extern "C" int kh_walk_prefix_thread(const void* cx, const void* cy, const void* tx,
                                     const void* ty, const void* ax, const void* ay, void* pre,
                                     void* totals, int W, int U, int L, long long C,
                                     void* stream) {
  if (bad_shape(W, U, L, C)) return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  walk_prefix_thread_kernel<<<(unsigned)((C + kThreads - 1) / kThreads), kThreads, 0,
                              (cudaStream_t)stream>>>(a, (uint32_t*)pre, (uint32_t*)totals);
  return (int)cudaGetLastError();
}

extern "C" int kh_walk_prefix_nostore(const void* cx, const void* cy, const void* tx,
                                      const void* ty, const void* ax, const void* ay,
                                      void* totals, int W, int U, int L, long long C,
                                      void* stream) {
  if (bad_shape(W, U, L, C)) return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  walk_prefix_nostore_kernel<<<(unsigned)((32 * C + kThreads - 1) / kThreads), kThreads, 0,
                               (cudaStream_t)stream>>>(a, (uint32_t*)totals);
  return (int)cudaGetLastError();
}

extern "C" int kh_walk_prefix_direct(const void* cx, const void* cy, const void* tx,
                                     const void* ty, const void* ax, const void* ay, void* pre,
                                     void* totals, int W, int U, int L, long long C,
                                     void* stream) {
  if (bad_shape(W, U, L, C)) return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  walk_prefix_direct_kernel<<<(unsigned)((32 * C + kThreads - 1) / kThreads), kThreads, 0,
                              (cudaStream_t)stream>>>(a, (uint32_t*)pre, (uint32_t*)totals);
  return (int)cudaGetLastError();
}

extern "C" int kh_walk_prefix_staged8(const void* cx, const void* cy, const void* tx,
                                      const void* ty, const void* ax, const void* ay, void* pre,
                                      void* totals, int W, int U, int L, long long C,
                                      void* stream) {
  if (bad_shape(W, U, L, C)) return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  walk_prefix_kernel<8><<<(unsigned)((C + 7) / 8), 256, 0, (cudaStream_t)stream>>>(
      a, (uint32_t*)pre, (uint32_t*)totals);
  return (int)cudaGetLastError();
}

extern "C" int kh_walk_totals(const void* cx, const void* cy, const void* tx, const void* ty,
                              const void* ax, const void* ay, void* totals, int W, int U, int L,
                              long long C, void* stream) {
  if (bad_shape(W, U, L, C) || L > 32) return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  walk_totals_kernel<<<(unsigned)((32 * C + kThreads - 1) / kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(a, (uint32_t*)totals);
  return (int)cudaGetLastError();
}

extern "C" int kh_walk_emit_nopre(const void* cx, const void* cy, const void* tx, const void* ty,
                                  const void* ax, const void* ay, const void* inv_totals, void* x,
                                  void* y, void* deg, void* nx, void* ny, void* adeg, int W,
                                  int U, int L, long long C, int n_endo, void* stream) {
  if (bad_shape(W, U, L, C) || L > 32 || (n_endo != 1 && n_endo != 3))
    return (int)cudaErrorInvalidValue;
  const WalkArgs a{(const uint32_t*)cx, (const uint32_t*)cy, (const uint32_t*)tx,
                   (const uint32_t*)ty, (const uint32_t*)ax, (const uint32_t*)ay, W, U, L, C};
  const EmitOut o{(uint32_t*)x, (uint32_t*)y, (uint8_t*)deg, (uint32_t*)nx, (uint32_t*)ny,
                  (uint8_t*)adeg, n_endo};
  walk_emit_nopre_kernel<<<(unsigned)((32 * C + kThreads - 1) / kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(a, (const uint32_t*)inv_totals, o);
  return (int)cudaGetLastError();
}
"""

# one walker chunk of a tree, run from the tree's root (its own package and
# chip_smoke.py); prints a JSON line
CHUNK = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from keyhuntm1cpu_tpu_torch import _build
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

T = {T}
_build.kernels()
raw = np.random.default_rng(43).integers(0, 256, (T, 20), dtype=np.uint8).tobytes()
ts = TargetSet(kind="hash160", raw=[raw[i:i + 20] for i in range(0, len(raw), 20)],
               labels=[""] * T)
params = BruteParams(walkers={W}, block_u={U}, steps_per_chunk=8, chain_len={L}, cand_max={C})
eng = BruteEngine(ts, *cs.BRUTE_RANGE, mode="rmd160", params=params, device="cuda")
assert eng._walker
ctr = eng._centers_for_bases(eng._sequential_bases(0))
chunk = lambda: eng._walker_chunk(ctr.x, ctr.y)
chunk()
ops = cs.device_launches(chunk)
card_ms, _ = cs.device_ms(chunk, 2)
enqueue = []
for _ in range(20):
    torch.cuda.synchronize()
    t = time.perf_counter()
    chunk()
    enqueue.append(1000 * (time.perf_counter() - t))
torch.cuda.synchronize()
k0 = eng.stats.keys_covered
t0 = time.time()
eng.search(max_seconds=3.0)
dt = time.time() - t0
keys = eng.stats.keys_covered - k0
chunks = keys // (8 * {W} * eng.window)
print(json.dumps(dict(ops=ops, enqueue_ms=float(np.median(enqueue)), card_ms=card_ms,
                      wall_ms=1000 * dt / chunks, keys_per_s=keys * eng.stats.multiplier / dt)))
"""


def host_ms(fn, reps):
    """Milliseconds the host takes to enqueue fn(), over reps calls after
    a synchronise (the card's queue does not fill at these counts)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1000 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return ms


def chunk_runs(trees, log):
    """{label: [result, ...]} of the CHUNK program in each tree, in order."""
    code = CHUNK.replace("{T}", str(T_CHUNK))
    for k, v in (("{W}", W), ("{U}", U), ("{L}", L), ("{C}", C)):
        code = code.replace(k, str(v))
    out = {}
    for label, root in trees:
        res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                             text=True, timeout=900)
        if res.returncode:
            raise RuntimeError(f"walker chunk in {root} failed:\n{res.stdout}\n{res.stderr}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        log(f"walker chunk ({label}, {root}): {r['ops']} device operations, host enqueue "
            f"{r['enqueue_ms']:.3f} ms, card {r['card_ms']:.3f} ms, wall {r['wall_ms']:.3f} ms "
            f"a chunk, {r['keys_per_s']:.4e} effective keys/s")
        out.setdefault(label, []).append(r)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--chunk", action="store_true", help="also time whole walker chunks")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pwalk, tables, walk
    from keyhuntm1cpu_tpu_torch.curve.points import point_batch_from_ints
    from keyhuntm1cpu_tpu_torch.field import fe, pinv
    from keyhuntm1cpu_tpu_torch.filter import sorted_table as st
    from keyhuntm1cpu_tpu_torch.hash import phash
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from torch_cascade_shapes import BINARY, SEARCH_CALL
    from torch_pwalk_shapes import build

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    out = {"card": card}

    # the step of chip_smoke.py's phase 1: C == ADV, C == -ADV, C == 9G
    npts = 2 * U + 1
    tab_x, tab_y = tables.step_table(ecref.G, U)
    adv = ecref.scalar_mult(npts)
    rng = np.random.default_rng(41)
    keys = [npts, ecref.N - npts, 9] + [int(k) for k in rng.integers(2**40, 2**50, W - 3)]
    c = point_batch_from_ints([ecref.scalar_mult(k) for k in keys], dev)
    limbs = lambda v: torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)
    wargs = (c.x, c.y, pwalk.table_to_limb_major(tab_x, dev),
             pwalk.table_to_limb_major(tab_y, dev), limbs(adv[0]), limbs(adv[1]))
    nch = walk.n_chains(W, U, L)
    st_ = torch.cuda.current_stream().cuda_stream

    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    jobs = [("variants", VARIANTS, csrc)]
    with open(os.path.join(csrc, "lookup.cu")) as f:
        text, n = re.subn(SEARCH_CALL, lambda _: BINARY, f.read())
    assert n == 1, "lookup.cu's search call"
    jobs.append(("lookup_binary", text, csrc))
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
        with open(os.path.join(pdir, "walk.cu")) as f:
            jobs.append(("parent", f.read(), pdir))
        with open(os.path.join(pdir, "lookup.cu")) as f:
            jobs.append(("parent_lookup", f.read(), pdir))
    libs = build(jobs, os.path.join(_build.build_dir(), "walker_shapes"))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    var = libs["variants"][0]
    var.kh_walk_totals.argtypes = [vp] * 7 + [i, i, i, i64, vp]
    var.kh_walk_prefix_nostore.argtypes = [vp] * 7 + [i, i, i, i64, vp]
    var.kh_walk_emit_nopre.argtypes = [vp] * 13 + [i, i, i, i64, i, vp]
    for lib, _ in libs.values():
        if hasattr(lib, "kh_lookup_summary"):
            lib.kh_lookup_summary.argtypes = [vp] * 9 + [i64, i, i, i, i, vp]
        for fn in ("kh_walk_prefix", "kh_walk_prefix_thread", "kh_walk_prefix_direct",
                   "kh_walk_prefix_staged8"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [vp] * 8 + [i, i, i, i64, vp]
    for name, (_, blog) in libs.items():
        for ln in cs.ptxas_summary(blog):
            if ln.startswith("walk"):
                cs.log(f"ptxas ({name}) {ln}")

    def call(lib, fn, *ptrs_and_ints):
        rc = getattr(lib, fn)(*ptrs_and_ints, st_)
        if rc:
            cs.fail(f"{fn} launch failed (cudaError {rc})")

    ptrs = [t.data_ptr() for t in wargs]

    # 1. walk_prefix
    want = walk.walk_prefix(*wargs, L)
    if not all(torch.equal(a, b) for a, b in zip(want, walk.walk_prefix_ref(*wargs, L))):
        cs.fail("walk_prefix differs from walk_prefix_ref")

    def raw_prefix(lib, fn):
        pre, tot = torch.empty_like(want[0]), torch.empty_like(want[1])

        def run():
            call(lib, fn, *ptrs, pre.data_ptr(), tot.data_ptr(), W, U, L, nch)
            return pre, tot
        return run

    designs = {"warp a chain, staged stores, 4 warps a block (shipped)":
                   lambda: walk.walk_prefix(*wargs, L),
               "warp a chain, staged stores, 8 warps a block":
                   raw_prefix(var, "kh_walk_prefix_staged8"),
               "warp a chain, direct stores": raw_prefix(var, "kh_walk_prefix_direct"),
               "thread a chain": raw_prefix(var, "kh_walk_prefix_thread")}
    if args.parent:
        designs["parent"] = raw_prefix(libs["parent"][0], "kh_walk_prefix")
    prefix = {}
    for name, fn in designs.items():
        ms, got = cs.device_ms(fn, 50)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            cs.fail(f"walk_prefix ({name}) differs from the shipped kernel")
        prefix[name] = ms
    tot_ns = torch.empty_like(want[1])

    def nostore():
        call(var, "kh_walk_prefix_nostore", *ptrs, tot_ns.data_ptr(), W, U, L, nch)
        return tot_ns
    ms, got = cs.device_ms(nostore, 50)
    if not torch.equal(got, want[1]):
        cs.fail("walk_prefix without prefix stores: totals differ from the shipped kernel")
    prefix["warp a chain, no prefix stores (totals only)"] = ms
    cs.log(f"walk_prefix W={W} U={U} L={L} ({nch} chains): "
           + ", ".join(f"{k} {v:.4f} ms" for k, v in prefix.items()) + " (equal outputs)")
    for L2 in (7, 33, 64, 65):  # the variants at the other chain lengths
        ref2 = walk.walk_prefix(*wargs, L2)
        for fn in ("kh_walk_prefix_direct", "kh_walk_prefix_staged8"):
            pre2, tot2_ = torch.empty_like(ref2[0]), torch.empty_like(ref2[1])
            call(var, fn, *ptrs, pre2.data_ptr(), tot2_.data_ptr(), W, U, L2,
                 walk.n_chains(W, U, L2))
            if not (torch.equal(pre2, ref2[0]) and torch.equal(tot2_, ref2[1])):
                cs.fail(f"{fn} differs from the shipped kernel at L={L2}")
    cs.log("walk_prefix variants: equal to the shipped kernel at L = 7, 33, 64, 65")
    out["walk_prefix"] = prefix

    # 2. the walk with and without stored prefixes
    def shipped_walk():
        pre, tot = walk.walk_prefix(*wargs, L)
        return walk.walk_emit(*wargs, pre, pinv.inv_batch(tot), L, 1, True)

    tot2 = torch.empty_like(want[1])
    x = torch.empty((1, 8, W, npts), dtype=torch.int32, device=dev)
    y = torch.empty((8, W, npts), dtype=torch.int32, device=dev)
    deg = torch.empty((W, U), dtype=torch.bool, device=dev)
    nx, ny = torch.empty_like(c.x), torch.empty_like(c.y)
    adeg = torch.empty((W,), dtype=torch.bool, device=dev)
    outs = (x, y, deg, nx, ny, adeg)
    itot = pinv.inv_batch(want[1])

    def totals():
        call(var, "kh_walk_totals", *ptrs, tot2.data_ptr(), W, U, L, nch)
        return tot2

    def emit_nopre(inv_tot):
        call(var, "kh_walk_emit_nopre", *ptrs, inv_tot.data_ptr(),
             *[t.data_ptr() for t in outs], W, U, L, nch, 1)
        return outs

    def nopre_walk():
        return emit_nopre(pinv.inv_batch(totals()))

    ref = shipped_walk()
    for name, fn in (("stored", shipped_walk), ("no prefixes", nopre_walk)):
        if not all(torch.equal(a, b) for a, b in zip(fn(), ref)):
            cs.fail(f"the walk ({name}) differs from the shipped kernels")
    if not torch.equal(totals(), want[1]):
        cs.fail("kh_walk_totals differs from walk_prefix's totals")
    pair = {"walk_prefix + pinv + walk_emit": cs.device_ms(shipped_walk, 50)[0],
            "walk_totals + pinv + walk_emit_nopre": cs.device_ms(nopre_walk, 50)[0],
            "walk_emit alone": cs.device_ms(
                lambda: walk.walk_emit(*wargs, want[0], itot, L, 1, True), 50)[0],
            "walk_emit_nopre alone": cs.device_ms(lambda: emit_nopre(itot), 50)[0],
            "walk_totals alone": cs.device_ms(totals, 50)[0]}
    cs.log("the walk at L=32: " + ", ".join(f"{k} {v:.4f} ms" for k, v in pair.items())
           + " (equal outputs)")
    out["walk"] = pair

    # 3. the lookup and summary against the torch ops it replaced
    res = walk.walk_fused(c, *wargs[2:], need_y=False, chain_len=L)
    (le, he), (lo_, ho_) = phash.hash160_x2_from_batch(res.x_all[0].reshape(8, -1))
    largs, n_live = cs.walker_lookup_inputs(torch.cat([he, ho_]), torch.cat([le, lo_]),
                                            res.degenerate, res.adv_degenerate, rng)
    table, lpos, lqhi, lqlo, n, dg, ad, total = largs
    one = (table, lpos[:1], lqhi[:1], lqlo[:1], n, dg[:1], ad[:1], total)
    want_row = st.lookup_summary_ref(*largs)
    if not torch.equal(st.lookup_summary(*largs), want_row):
        cs.fail("lookup_summary differs from lookup_summary_ref")
    if int((want_row[:C] < total).sum()) != n_live:
        cs.fail("lookup_summary_ref misses the planted hits")
    lookup = {}
    for name, fn in (("kernel", lambda: st.lookup_summary(*largs)),
                     ("torch composition (lookup_summary_ref)",
                      lambda: st.lookup_summary_ref(*largs)),
                     ("sorted_table.lookup alone", lambda: st.lookup(table, lqhi, lqlo)),
                     ("kernel at C = 1, W = 1", lambda: st.lookup_summary(*one))):
        lookup[name] = {"card_ms": cs.device_ms(fn, 50)[0], "host_ms": host_ms(fn, 50)}
    cs.log(f"lookup and summary C={C} over {table.key.numel()} keys ({n_live} live hits): "
           + ", ".join(f"{k} {v['card_ms']:.4f} ms on the card, {v['host_ms']:.4f} ms to "
                       f"enqueue" for k, v in lookup.items()) + " (equal rows)")
    out["lookup"] = lookup

    # the kernel's designs, raw launches in turns, warm and cold
    flush = torch.empty((1 << 24,), dtype=torch.int32, device=dev)  # 64 MB, past the L2

    def raw_lookup(lib, a):
        tab, pos_, qh_, ql_, n_, dg_, ad_, tot = a
        row = torch.empty((st.summary_width(pos_.shape[0], dg_.shape[0]),), dtype=torch.int32,
                          device=dev)
        ptrs = [t.data_ptr() for t in (pos_, qh_, ql_, n_, tab.key, tab.idx, dg_, ad_, row)]

        def run():
            call(lib, "kh_lookup_summary", *ptrs, tab.key.numel(), pos_.shape[0],
                 dg_.shape[0], dg_.shape[1], tot)
            return row
        return run

    designs = [("shipped", _build.kernels()), ("binary", libs["lookup_binary"][0])]
    if args.parent:
        par = ("parent", libs["parent_lookup"][0])
        designs = [par, designs[0], designs[1], designs[0], par]
    grid = {}
    for shape, a in (("C=256 W=8", largs), ("C=1 W=1", one)):
        want_a = st.lookup_summary_ref(*a)
        row = {}
        for name, lib in designs:
            fn = raw_lookup(lib, a)
            ms, got = cs.device_ms(fn, 50)
            if not torch.equal(got, want_a):
                cs.fail(f"lookup_summary ({name}, {shape}) differs from lookup_summary_ref")
            row.setdefault(name, []).append((ms, cs.cold_ms(fn, flush)))
        cs.log(f"lookup_summary designs at {shape}: "
               + ", ".join(f"{k} " + "/".join(f"{w:.4f} (cold {c:.4f})" for w, c in v)
                           for k, v in row.items()) + " ms (equal rows)")
        grid[shape] = row
    out["lookup_designs"] = grid
    del table, largs, one, flush

    # 4. whole chunks, each tree in its own process
    if args.chunk:
        this = ("this tree", HERE)
        trees = ([("parent", os.path.abspath(args.parent)), this, this,
                  ("parent", os.path.abspath(args.parent))] if args.parent else [this, this])
        torch.cuda.empty_cache()
        out["chunk"] = chunk_runs(trees, cs.log)
    cs.log(f"card {card}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
