#!/usr/bin/env python3
"""Time the port's filter probe (csrc/probe.cu) on an NVIDIA GPU: the
card's ceiling for random 4-byte reads, the probe's compile-time shapes,
and the level-1 stage of the BSGS cascade against the composition it
replaced.

    python3 scripts/torch_probe_shapes.py [--parent DIR]

1. The ceiling: a gather kernel that does nothing but random word reads
   (fmix32 of a counter picks each word; no keys loaded, one word stored
   per thread), R = 1, 2, 4, 8 or 16 reads in flight a thread, 4,194,304
   reads over filters of 2^24 (L2-resident), 2^28, 2^32, 2^34 and 2^35 bits
   (DRAM, past the TLB's reach): ms and reads per second for each.
2. The shapes: copies of csrc/probe.cu with other kProbeQ (keys a thread
   of the fused form) and kProbeThreads, and one whose fused form reads
   its words through __ldg (which may allocate in L1, as the mask form's
   reads do), built by nvcc (all in parallel) and called
   through ctypes, each held to the shipped kernels' outputs and timed at
   the main paths' shapes: BSGS level 1 (4,194,304 random keys against a
   2^35-bit bitmap of bit density 1/128, m = 2^28's; compacted to C1 =
   34,816) and the walker (131,088 keys against 2^34 bits of density 2^-12,
   cand_max = 256). The mask form (one key a thread) at both shapes and in
   bloom2 form on 34,816 keys, for the shipped source and the parent's.
3. The level-1 stage (probe, compaction, key gathers) through the fused
   kernel (bitmap.probe_compact) against its composition before the fusion
   (the mask form, compact_positions, the gathers and the count), and the
   whole cascade (bitmap.filtered_survivors against the same composition
   and the bloom2 stage), held equal. With --parent DIR (an earlier commit
   unpacked with git archive into a gitignored directory), DIR's
   csrc/probe.cu runs the composition's probes too, in the same run.
Prints one line per measurement and a JSON line of all times.
``read_ceiling`` is what chip_smoke.py's phase 3 calls.
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

CEILING_BITS = (24, 28, 32, 34, 35)
CEILING_READS = 1 << 22  # the BSGS chunk's level-1 queries
CEILING_R = (1, 2, 4, 8, 16)
# the fused form's (kProbeQ, kProbeThreads): the shipped shape first
SHAPES = [(8, 128), (1, 128), (2, 128), (4, 128), (16, 128), (8, 64), (4, 256), (8, 256)]
LDG = "v = __ldg(p);"  # the fused form's word reads as the mask form's
B_BSGS, C1, C2 = 1 << 22, 34816, 1024  # the BSGS chunk's queries and cascade budgets
B_WALK, C_WALK = 131088, 256  # the walker step's rmd160 queries, cand_max

GATHER = r"""
#include <cuda_runtime.h>
#include <cstdint>
namespace {
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13; h *= 0xC2B2AE35u; h ^= h >> 16;
  return h;
}
template <int R>
__global__ void gather_kernel(const uint32_t* __restrict__ words, uint32_t wmask,
                              uint32_t* __restrict__ out, long long threads) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint32_t w[R];
#pragma unroll
  for (int r = 0; r < R; r++) {
    const uint32_t i = fmix32((uint32_t)(t * R + r) * 0x9E3779B1u + 0x2545F491u) & wmask;
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(w[r]) : "l"(words + i));
  }
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < R; r++) acc ^= w[r];
  out[t] = acc;
}
template <int R>
void go(const void* words, unsigned wmask, void* out, long long reads, cudaStream_t s) {
  const long long threads = reads / R;
  gather_kernel<R><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      (const uint32_t*)words, wmask, (uint32_t*)out, threads);
}
}  // namespace
extern "C" int kh_gather(const void* words, unsigned wmask, void* out, long long reads, int R,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 1: go<1>(words, wmask, out, reads, s); break;
    case 2: go<2>(words, wmask, out, reads, s); break;
    case 4: go<4>(words, wmask, out, reads, s); break;
    case 8: go<8>(words, wmask, out, reads, s); break;
    case 16: go<16>(words, wmask, out, reads, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


def gather_lib():
    """The ceiling's gather kernel, built into the build directory."""
    from keyhuntm1cpu_tpu_torch import _build
    from torch_pwalk_shapes import build

    lib = build([("gather", GATHER, HERE)], os.path.join(_build.build_dir(), "probe_shapes"))
    lib = lib["gather"][0]
    vp = ctypes.c_void_p
    lib.kh_gather.argtypes = [vp, ctypes.c_uint, vp, ctypes.c_longlong, ctypes.c_int, vp]
    return lib


def read_ceiling(words, bits_list=CEILING_BITS, reads=CEILING_READS, rs=CEILING_R, log=print):
    """ms of `reads` random word reads over the first 2^bits bits of the
    int32 tensor `words` (on the card), for each bits and reads-in-flight
    R. Returns {bits: {R: ms}}."""
    import torch

    import chip_smoke as cs

    lib = gather_lib()
    out = torch.empty(reads, dtype=torch.int32, device=words.device)
    st = torch.cuda.current_stream(words.device).cuda_stream
    res = {}
    for bits in bits_list:
        if (1 << (bits - 5)) > words.numel():
            cs.fail(f"read_ceiling: 2^{bits} bits exceed the buffer")
        row = {}
        for r in rs:
            def run():
                rc = lib.kh_gather(words.data_ptr(), (1 << (bits - 5)) - 1, out.data_ptr(),
                                   reads, r, st)
                if rc:
                    cs.fail(f"gather launch failed (cudaError {rc})")
            row[r], _ = cs.device_ms(run, 20)
        res[bits] = row
        best = min(row, key=row.get)
        log(f"random-read ceiling 2^{bits} bits ({(1 << (bits - 3)) / 2**20:.0f} MiB): "
            + ", ".join(f"R={r} {ms:.4f}" for r, ms in row.items())
            + f" ms for {reads} reads; best {reads / row[best] / 1e6:.3f} G reads/s (R={best})")
    return res


def variant_source(src, q, threads, ldg=False):
    for name, v in (("kProbeQ", q), ("kProbeThreads", threads)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", src)
        assert n == 1, name
    if ldg:
        src, n = re.subn(r'asm\("ld\.global\.nc\.L1::no_allocate.*\);', LDG, src)
        assert n == 1, "ld_word"
    return src


def random_filter(bits, density_log2, dev, seed):
    """int32 words of 2^bits bits, each bit set with probability
    2^-density_log2 (the AND of that many random words)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n = 1 << (bits - 5)
    w = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=g)
    for _ in range(density_log2 - 1):
        w &= torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=g)
    return w


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from torch_pwalk_shapes import build

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    out = {"card": card}

    bm = bmp.DeviceBitmap(random_filter(35, 7, dev, 1), 35)  # m = 2^28 in 2^35 bits
    out["ceiling"] = read_ceiling(bm.words, log=cs.log)
    b2 = bmp.DeviceBloom2(random_filter(35, 6, dev, 2), 35)  # load 2m/2^35
    wk = bmp.DeviceBitmap(random_filter(34, 12, dev, 3), 34)  # 2^22 targets in 2^34 bits
    g = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda n: torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=g)
    qhi, qlo = rnd(B_BSGS), rnd(B_BSGS)
    whi, wlo = rnd(B_WALK), rnd(B_WALK)
    h2, l2 = rnd(C1), rnd(C1)
    st = torch.cuda.current_stream().cuda_stream

    # 2. the shapes, held to the shipped kernels
    want_mask = {"bsgs": bmp.probe(bm, qhi, qlo), "walker": bmp.probe(wk, whi, wlo),
                 "bloom2": bmp.probe_bloom2(b2, h2, l2)}
    want_pc = {"bsgs": bmp.probe_compact(bm, qhi, qlo, C1),
               "walker": bmp.probe_compact(wk, whi, wlo, C_WALK)}
    for key, (f, h, l, c) in {"bsgs": (bm, qhi, qlo, C1), "walker": (wk, whi, wlo, C_WALK)}.items():
        ref = bmp.probe_compact_ref(f, h, l, c)
        if not all(torch.equal(a, b) for a, b in zip(want_pc[key], ref)):
            cs.fail(f"probe_compact differs from probe_compact_ref ({key})")
    cs.log(f"shipped probe_compact equal to probe_compact_ref: BSGS "
           f"{int(want_pc['bsgs'].n)} survivors of {B_BSGS}, walker {int(want_pc['walker'].n)}")
    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    with open(os.path.join(csrc, "probe.cu")) as f:
        src = f.read()
    jobs = [(f"Q{q}_T{t}", variant_source(src, q, t), csrc) for q, t in SHAPES]
    jobs.append((f"Q{SHAPES[0][0]}_T{SHAPES[0][1]}_ldg", variant_source(src, *SHAPES[0], True),
                 csrc))
    shipped = jobs[0][0]
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
        with open(os.path.join(pdir, "probe.cu")) as f:
            jobs.append(("parent", f.read(), pdir))
    libs = build(jobs, os.path.join(_build.build_dir(), "probe_shapes"))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def mask_fn(lib, f, h, l, bloom2):
        m = torch.empty(h.shape, dtype=torch.bool, device=dev)

        def run():
            rc = lib.kh_probe(f.words.data_ptr(), h.data_ptr(), l.data_ptr(), m.data_ptr(),
                              h.shape[0], f.bits_log2, int(bloom2), st)
            if rc:
                cs.fail(f"kh_probe launch failed (cudaError {rc})")
            return m
        return run

    times = {}
    for name, (lib, blog) in libs.items():
        lib.kh_probe.argtypes = [vp] * 4 + [i64, i, i, vp]
        row = {}
        for key, (f, h, l, b2f) in {"bsgs": (bm, qhi, qlo, False), "walker": (wk, whi, wlo, False),
                                     "bloom2": (b2, h2, l2, True)}.items():
            if name not in (shipped, "parent"):
                continue
            ms, got = cs.device_ms(mask_fn(lib, f, h, l, b2f), 20)
            if not torch.equal(got, want_mask[key]):
                cs.fail(f"{name}: mask form differs from the shipped kernel ({key})")
            row[f"mask {key}"] = ms
        if name != "parent":
            lib.kh_probe_compact.argtypes = [vp] * 9 + [i64, i64, i, i, vp]
            lib.kh_probe_tile.argtypes = [i]
            tile = lib.kh_probe_tile(0)
            for key, (f, h, l, c) in {"bsgs": (bm, qhi, qlo, C1),
                                      "walker": (wk, whi, wlo, C_WALK)}.items():
                outs = tuple(torch.empty(c, dtype=torch.int32, device=dev) for _ in range(3))
                cnt = torch.empty((), dtype=torch.int32, device=dev)
                # two scratches, zeroed once: a launch uses one and zeroes the other
                pair = torch.zeros((2, 1 + -(-h.shape[0] // tile)), dtype=torch.int64,
                                   device=dev)
                turn = [0]

                def run(f=f, h=h, l=l, c=c, outs=outs, cnt=cnt, pair=pair, turn=turn):
                    this, other = pair[turn[0]], pair[1 - turn[0]]
                    rc = lib.kh_probe_compact(f.words.data_ptr(), h.data_ptr(), l.data_ptr(),
                                              *[t.data_ptr() for t in outs], cnt.data_ptr(),
                                              this.data_ptr(), other.data_ptr(), other.numel(),
                                              h.shape[0], f.bits_log2, c, st)
                    if rc:
                        cs.fail(f"{name}: kh_probe_compact launch failed (cudaError {rc})")
                    turn[0] ^= 1
                    return outs + (cnt,)

                for t in outs:
                    t.fill_(-1)
                ms, got = cs.device_ms(run, 20)
                if not all(torch.equal(a, b) for a, b in zip(got, want_pc[key])):
                    cs.fail(f"{name}: fused form differs from the shipped kernel ({key})")
                row[f"fused {key}"] = ms
        regs = "; ".join(ln for ln in cs.ptxas_summary(blog) if ln.startswith("probe"))
        cs.log(f"probe {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
               + f" ms | {regs}")
        times[name] = row
    out["shapes"] = times

    # 3. the level-1 stage and the cascade: fused against the composition
    def composition(probe_mask, probe_b2=None):
        """The level-1 stage before the fusion: mask, count, compaction,
        gathers; with probe_b2 the bloom2 stage after it (the cascade)."""
        def run():
            mask = probe_mask()
            n = mask.sum(dtype=torch.int32)
            pos1 = bmp.compact_positions(mask, C1, B_BSGS)
            safe1 = pos1.clamp(max=B_BSGS - 1).long()
            qh1, ql1 = qhi[safe1], qlo[safe1]
            if probe_b2 is None:
                return pos1, qh1, ql1, n
            mask2 = probe_b2(qh1, ql1) & (pos1 < B_BSGS)
            n2 = mask2.sum(dtype=torch.int32)
            pos2 = bmp.compact_positions(mask2, C2, C1)
            safe2 = pos2.clamp(max=C1 - 1).long()
            pos = torch.where(pos2 < C1, pos1[safe2], B_BSGS)
            return pos, qh1[safe2], ql1[safe2], torch.where(n > C1, n + C2, n2)
        return run

    trees = {"this tree": libs[shipped][0]}
    if args.parent:
        trees["parent"] = libs["parent"][0]
    stage = {"fused": cs.device_ms(lambda: bmp.probe_compact(bm, qhi, qlo, C1), 20)}
    cascade = {"fused": cs.device_ms(lambda: bmp.filtered_survivors(
        bm, qhi, qlo, C2, bm2=b2, stage1_max=C1), 20)}
    for label, lib in trees.items():
        b2_fn = lambda h, l, lib=lib: mask_fn(lib, b2, h.contiguous(), l.contiguous(), True)()
        stage[f"composition, {label}'s probe"] = cs.device_ms(
            composition(mask_fn(lib, bm, qhi, qlo, False)), 20)
        cascade[f"composition, {label}'s probes"] = cs.device_ms(
            composition(mask_fn(lib, bm, qhi, qlo, False), b2_fn), 20)
    walker = {"fused": cs.device_ms(lambda: bmp.probe_compact(wk, whi, wlo, C_WALK), 20)}

    def walker_composition(probe_mask):
        def run():
            mask = probe_mask()
            pos = bmp.compact_positions(mask, C_WALK, B_WALK)
            safe = pos.clamp(max=B_WALK - 1).long()
            return pos, whi[safe], wlo[safe], mask.sum(dtype=torch.int32)
        return run

    for label, lib in trees.items():
        walker[f"composition, {label}'s probe"] = cs.device_ms(
            walker_composition(mask_fn(lib, wk, whi, wlo, False)), 20)
    for name, table in (("level-1 stage", stage), ("cascade", cascade),
                        ("walker level-1 stage", walker)):
        ref = table["fused"][1]
        for label, (ms, got) in table.items():
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                cs.fail(f"{name}: {label} differs from the fused form's")
        shape = (f"B={B_WALK}, 2^34 bits, C={C_WALK}" if name.startswith("walker")
                 else f"B={B_BSGS}, 2^35 bits, C1={C1}")
        cs.log(f"{name} at {shape}: "
               + ", ".join(f"{k} {v[0]:.4f} ms" for k, v in table.items()) + " (equal outputs)")
    out["level1"] = {k: v[0] for k, v in stage.items()}
    out["cascade"] = {k: v[0] for k, v in cascade.items()}
    out["walker level1"] = {k: v[0] for k, v in walker.items()}
    cs.log(f"card {card}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
