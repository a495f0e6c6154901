#!/usr/bin/env python3
"""Time the port's field inversions on an NVIDIA GPU: four designs of
pinv (csrc/pinv.cu), and every kernel that inverts with each inversion.

    python3 scripts/torch_pinv_shapes.py [--parent DIR]

pinv designs, each a copy of csrc/pinv.cu with its kernel rewritten and
held to inv_batch_ref (0 -> 0 planted at a warp and a block edge), timed
by chip_smoke.device_ms at n = 1 (one inversion's latency), 1,025 (the
walker step's chain totals) and 65,536 (a throughput check):
- chain: one thread per element, the secp256k1 addition chain (255
  squarings and 15 products; the design before divsteps);
- var: one thread per element, fe.cuh fe_inv_var (variable-time safegcd
  divsteps: the lanes of a warp diverge by their divstep counts);
- const: one thread per element, fe.cuh fe_inv_const (20 batches of 30
  branch-free divsteps, the same instructions for every input);
- tree: one inversion (fe_inv_var) per block of 128 elements through a
  shared-memory product tree; zeros enter as 1 and leave as 0.
Callers: K1 and K2 (csrc/pwalk.cu), K4 (csrc/pbrute.cu, rmd160 and xpoint)
and K6's to-affine launch (csrc/ladder.cu), one copy each with the
inversion call replaced by each of chain, var and const, held to the
shipped kernels' outputs and timed at the main paths' shapes (K1 T = 1,
K = 256; K2 R = 256, U = 16384; K4 K = 256, U = 16384, T = 32; K6 V =
34,816). With --parent DIR (an earlier commit unpacked with git archive
into a gitignored directory), DIR's csrc/pinv.cu with its fe.cuh is
timed the same way in the same run. One nvcc per copy, all in parallel.
Prints one line per design and caller and a JSON line of all times.
``pinv_designs`` is what chip_smoke.py's phase 1 calls.
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

NS = (1, 1025, 65536)
INVERSIONS = {"chain": "fe_inv_chain", "var": "fe_inv_var", "const": "fe_inv_const"}

# the addition chain a^(p-2) (fe_tiles.inv's), on fe.cuh's product and square
CHAIN = r"""
namespace kh {
static __device__ __noinline__ Fe chain_sqr_n(Fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) x = fe_sqr(x);
  return x;
}
static __device__ __noinline__ Fe fe_inv_chain(const Fe& a) {
  Fe x1 = a;
  Fe x2 = fe_mul(chain_sqr_n(x1, 1), x1);
  Fe x3 = fe_mul(chain_sqr_n(x2, 1), x1);
  Fe x6 = fe_mul(chain_sqr_n(x3, 3), x3);
  Fe x9 = fe_mul(chain_sqr_n(x6, 3), x3);
  Fe x11 = fe_mul(chain_sqr_n(x9, 2), x2);
  Fe x22 = fe_mul(chain_sqr_n(x11, 11), x11);
  Fe x44 = fe_mul(chain_sqr_n(x22, 22), x22);
  Fe x88 = fe_mul(chain_sqr_n(x44, 44), x44);
  Fe x176 = fe_mul(chain_sqr_n(x88, 88), x88);
  Fe x220 = fe_mul(chain_sqr_n(x176, 44), x44);
  Fe x223 = fe_mul(chain_sqr_n(x220, 3), x3);
  Fe t = fe_mul(chain_sqr_n(x223, 23), x22);
  t = fe_mul(chain_sqr_n(t, 5), x1);
  t = fe_mul(chain_sqr_n(t, 3), x2);
  return fe_mul(chain_sqr_n(t, 2), x1);
}
}  // namespace kh
"""

# one inversion per block of kGroup elements: a heap-ordered product tree
# (leaves at [G, 2G)), fe_inv_var on thread 0, then down
TREE_KERNEL = r"""
namespace {
constexpr int kGroup = 128;
__global__ void __launch_bounds__(kGroup)
inv_tree_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n) {
  __shared__ kh::Fe tree[2 * kGroup];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kGroup + t;
  const kh::Fe one = kh::fe_one();
  kh::Fe x = one;
  if (i < n) x = kh::fe_load_lm(a, n, i);
  const bool zero = kh::fe_is_zero(x);
  tree[kGroup + t] = zero ? one : x;
  __syncthreads();
  for (int s = kGroup / 2; s >= 1; s >>= 1) {
    if (t < s) tree[s + t] = kh::fe_mul(tree[2 * (s + t)], tree[2 * (s + t) + 1]);
    __syncthreads();
  }
  if (t == 0) tree[1] = kh::fe_inv_var(tree[1]);
  __syncthreads();
  for (int s = 1; s < kGroup; s <<= 1) {
    if (t < s) {
      const int k = s + t;
      const kh::Fe inv = tree[k], l = tree[2 * k], r = tree[2 * k + 1];
      tree[2 * k] = kh::fe_mul(inv, r);
      tree[2 * k + 1] = kh::fe_mul(inv, l);
    }
    __syncthreads();
  }
  if (i < n) kh::fe_store_lm(out, n, i, zero ? kh::Fe{{0, 0, 0, 0, 0, 0, 0, 0}} : tree[kGroup + t]);
}
}  // namespace

extern "C" int kh_inv_batch(const void* a, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  inv_tree_kernel<<<(unsigned)((n + kGroup - 1) / kGroup), kGroup, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
"""

INVERSION = re.compile(r"kh::fe_inv(?:_var|_const|_chain)?\b")


def with_inversion(src, inv):
    """src with every inversion it names made kh::<inv>, the chain's source
    added after fe.cuh's include."""
    src = src.replace('#include "fe.cuh"\n', '#include "fe.cuh"\n' + CHAIN, 1)
    out, n = INVERSION.subn(f"kh::{inv}", src)
    assert n >= 1, "no inversion"
    return out


def pinv_sources(csrc):
    """{design: source} of the four pinv designs, from csrc/pinv.cu."""
    with open(os.path.join(csrc, "pinv.cu")) as f:
        src = f.read()
    out = {name: with_inversion(src, inv) for name, inv in INVERSIONS.items()}
    head = src[: src.index("namespace {")]
    out["tree"] = head.replace('#include "fe.cuh"\n', '#include "fe.cuh"\n' + CHAIN, 1) + TREE_KERNEL
    return out


def _inputs(n, dev):
    """(8, n) int32 limbs of seeded random field elements, zeros at a warp
    edge and a block edge (and at 0 when n > 1: a lone 0 would time no
    inversion)."""
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.field import fe

    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
    v[7] &= 0x7FFFFFFF  # below p
    for j in (0, 31, 128):
        if j < n and n > 1:
            v[:, j] = 0
    if n > 2:
        v[:, 1] = fe.int_to_limbs(1)
    return torch.from_numpy(v.view(np.int32)).to(dev)


def pinv_designs(dev, ns=NS, parent=None, log=print):
    """Build the four pinv designs (and, with parent, DIR's pinv.cu) and
    time each at every n of ns, held to inv_batch_ref. Returns {design:
    {n: ms}}."""
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.field import pinv
    from torch_pwalk_shapes import build

    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    jobs = [(f"pinv_{k}", v, csrc) for k, v in pinv_sources(csrc).items()]
    if parent:
        pdir = os.path.join(os.path.abspath(parent), "keyhuntm1cpu_tpu_torch", "csrc")
        with open(os.path.join(pdir, "pinv.cu")) as f:
            jobs.append(("pinv_parent", f.read(), pdir))
    libs = build(jobs, os.path.join(_build.build_dir(), "pinv_shapes"))
    st = torch.cuda.current_stream().cuda_stream
    cases = {n: _inputs(n, dev) for n in ns}
    want = {n: pinv.inv_batch_ref(a) for n, a in cases.items()}
    times = {}
    for name, (lib, blog) in libs.items():
        lib.kh_inv_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p]
        regs = "; ".join(ln for ln in cs.ptxas_summary(blog) if "inv" in ln.split(":")[0])
        row = {}
        for n, a in cases.items():
            out = torch.empty_like(a)

            def run():
                rc = lib.kh_inv_batch(a.data_ptr(), out.data_ptr(), n, st)
                if rc:
                    cs.fail(f"{name}: launch failed (cudaError {rc})")
                return out

            out.fill_(-1)
            ms, got = cs.device_ms(run, 20)
            if not torch.equal(got, want[n]):
                cs.fail(f"{name} differs from inv_batch_ref at n={n}")
            row[n] = ms
        times[name[len("pinv_"):]] = row
        log(f"pinv {name[len('pinv_'):]}: " + ", ".join(f"n={n} {ms:.4f} ms"
                                                        for n, ms in row.items())
            + f" (equal to inv_batch_ref) | {regs}")
    return times


def caller_times(dev, log=print):
    """K1, K2, K4 (rmd160, xpoint) and K6's to-affine launch with each
    inversion, held to the shipped kernels. Returns {kernel: {inversion: ms}}."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pbrute, pladder, pwalk, tables
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from torch_pwalk_shapes import build

    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    jobs = []
    for fname in ("pwalk", "pbrute", "ladder"):
        with open(os.path.join(csrc, f"{fname}.cu")) as f:
            src = f.read()
        jobs += [(f"{fname}_{k}", with_inversion(src, inv), csrc) for k, inv in INVERSIONS.items()]
    libs = build(jobs, os.path.join(_build.build_dir(), "pinv_shapes"))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = torch.cuda.current_stream().cuda_stream
    U, K = cs.U, cs.K

    def limbs(v):
        return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def ptr(ts):
        return [t.data_ptr() for t in ts]

    # K1 and K2 at the BSGS main path's shapes (m = 2^28)
    stride = 2 * (1 << 28)
    adv = ecref.point_neg(ecref.scalar_mult(U * stride))
    tab = pwalk.adv_multiples(adv, K, dev)
    p = ecref.scalar_mult(0x7CCE5EFDACCF6808 - 12345)
    px, py = limbs(p[0])[:, None].contiguous(), limbs(p[1])[:, None].contiguous()
    ax, ay = limbs(adv[0]), limbs(adv[1])
    k1_want = pwalk.advance_chain(px, py, ax, ay, K, tab)
    k1_out = (empty(8, K), empty(8, K), empty(8, 1), empty(8, 1), empty(1, K, dtype=torch.bool))
    s_pt = ecref.point_neg(ecref.scalar_mult(stride))
    tx_np, ty_np = tables.step_table(s_pt, U)
    tx, ty = pwalk.table_to_limb_major(tx_np, dev), pwalk.table_to_limb_major(ty_np, dev)
    bx, by = k1_want[0], k1_want[1]
    k2_want = pwalk.walk_blocks(bx, by, tx, ty)
    k2_out = (empty(K, U), empty(K, U), empty(K, U, dtype=torch.bool))
    # K4 at the fused brute path's shape, T = 32 intervals
    gx_np, gy_np = tables.step_table(ecref.G, U)
    gtx, gty = pwalk.table_to_limb_major(gx_np, dev), pwalk.table_to_limb_major(gy_np, dev)
    b0 = ecref.scalar_mult(cs.BRUTE_RANGE[0])
    badv = ecref.scalar_mult(U)
    kbx, kby, _, _, _ = pwalk.advance_chain(limbs(b0[0])[:, None].contiguous(),
                                            limbs(b0[1])[:, None].contiguous(),
                                            limbs(badv[0]), limbs(badv[1]), K)
    rng = np.random.default_rng(7)
    vals = [int(v) for v in rng.integers(0, 2**63, 32)]
    tgt = torch.from_numpy(np.ascontiguousarray(pbrute.pack_intervals(vals, vals))
                           .view(np.int32)).to(dev)
    btab = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    k4_want = {m: pbrute.brute_walk_blocks(kbx, kby, gtx, gty, tgt, btab, m, 1, 0)
               for m in ("rmd160", "xpoint")}
    k4_out = empty(K, U)
    # K6's to-affine launch on the ladder's Jacobian output, V = 34,816
    V = 34816
    ks = torch.from_numpy(rng.integers(0, 2**32, (8, V), dtype=np.uint64).astype(np.uint32)
                          .view(np.int32)).to(dev)
    lgx, lgy = pladder.gtable_tensors(dev)
    jac, inf, irr = empty(3, 8, V), empty(V, dtype=torch.bool), empty(V, dtype=torch.bool)
    _build.launch("kh_ladder_jac", *ptr((ks, lgx, lgy, jac, inf, irr)), V, st)
    k6_want = pladder.scalar_mult_tiles(ks, lgx, lgy)[:2]
    k6_out = (empty(8, V), empty(8, V))
    torch.cuda.synchronize()

    times = {}
    for name, (lib, blog) in libs.items():
        fname, inv = name.split("_")
        if fname == "pwalk":
            lib.kh_advance_chain.argtypes = [vp] * 9 + [i, i, vp]
            lib.kh_walk_blocks.argtypes = [vp] * 7 + [i64, i, vp]
            cases = {"K1 T=1 K=256": (lambda: lib.kh_advance_chain(
                         *ptr((px, py) + tuple(tab) + k1_out), 1, K, st), k1_out, k1_want),
                     "K2 R=256 U=16384": (lambda: lib.kh_walk_blocks(
                         *ptr((bx, by, tx, ty) + k2_out), K, U, st), k2_out, k2_want)}
        elif fname == "pbrute":
            lib.kh_brute_walk_blocks.argtypes = [vp] * 7 + [i64, i, i, i, i, i, vp]
            cases = {f"K4 {m} K=256 U=16384 T=32": (
                lambda m=m: lib.kh_brute_walk_blocks(
                    *ptr((kbx, kby, gtx, gty, tgt, btab, k4_out)), K, U, tgt.shape[1], 0,
                    pbrute.MODES.index(m), 1, st), (k4_out,), (k4_want[m],))
                for m in ("rmd160", "xpoint")}
        else:
            lib.kh_ladder_affine.argtypes = [vp] * 4 + [i, vp]
            cases = {f"K6 to-affine V={V}": (lambda: lib.kh_ladder_affine(
                *ptr((jac, inf) + k6_out), V, st), k6_out, k6_want)}
        for label, (fn, outs, want) in cases.items():
            def run():
                rc = fn()
                if rc:
                    cs.fail(f"{name}: {label} launch failed (cudaError {rc})")
                return outs

            for t in outs:
                t.fill_(-1)
            ms, got = cs.device_ms(run, 10)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                cs.fail(f"{name}: {label} differs from the shipped kernel")
            times.setdefault(label, {})[inv] = ms
        regs = "; ".join(ln for ln in cs.ptxas_summary(blog)
                         if ln.split(":")[0].endswith("_kernel"))
        log(f"{name}: " + ", ".join(f"{lb} {times[lb][inv]:.4f} ms" for lb in cases)
            + f" | {regs}")
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    designs = pinv_designs(dev, parent=args.parent, log=cs.log)
    callers = caller_times(dev, log=cs.log)
    cs.log(f"card {card}")
    print(json.dumps({"card": card, "pinv": designs, "callers": callers}), flush=True)


if __name__ == "__main__":
    main()
