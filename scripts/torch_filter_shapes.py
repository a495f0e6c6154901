#!/usr/bin/env python3
"""Time K3 (csrc/filter.cu kh_insert_keys) and the minikey compaction and
key derivation (csrc/minikey.cu kh_minikey_compact_keys) on an NVIDIA GPU:
the card's random read-modify-write ceiling, each kernel's shapes, and the
torch ops each replaced.

    python3 scripts/torch_filter_shapes.py [--parent DIR] [--chunk]

1. The ceiling: a kernel that does nothing but random 4-byte atomicOr
   (fmix32 of a counter picks each word) into filters of 2^34 and 2^35
   bits (2 and 4 GiB), 1 or 3 a thread, at 1,572,864 atomics (a streaming
   build step's 524,288 keys, 3 each) and 4,194,304 (a brute target set of
   2^22): the result unused (which nvcc compiles to RED), inline
   red.global.or.b32, and the result used (ATOM); the SASS opcodes of each
   (cuobjdump -sass) and of the shipped K3.
2. K3's shapes: copies of csrc/filter.cu with 512-thread blocks, with a
   grid of one wave of resident blocks (in place of the cap at 64 blocks
   an SM), with inline red.global.or.b32, and a kernel that gives each of a
   key's three atomics its own thread; each held to the shipped kernel and
   timed at the build step (524,288 keys into 2^35 + 2^35 bits) and at the
   brute target bitmap (4,194,304 keys into 2^34 bits alone). With
   --parent DIR (an earlier commit unpacked with git archive into a
   gitignored directory), DIR's K3 (a keep mask) too, and the streaming
   build step before (K1, K2, the keep mask, DIR's K3 and the torch ops of
   the degeneracy count) and after (engine/bsgs.filter_build_step): its
   device operations (torch.profiler) and card time.
3. kh_minikey_compact_keys with 128, 256, 512 and 1024 threads a block
   (tiles of 8,192 to 65,536 lanes), with a look-back that reads 4 tiles
   a lane a round, and with the first round hashed during the look-back,
   each held to the shipped kernel at B = 2^23, V = 34,816 on K5's mask;
   two timing probes that leave out the hashes or the look-back (their
   outputs wrong by design); beside the composition it replaced (the
   count and compact_positions, and with --parent DIR's kh_minikey_keys):
   card time and device operations.
4. With --chunk: the brute target bitmap's set-up (TargetSet.build_bitmap
   on the card, 2^22 targets, 2^34 bits) and the minikeys chunk at B =
   2^23 (card time, device operations, the host's enqueue, minikeys/s over
   3 s with one target), each tree in its own process from its root:
   DIR, this, this, DIR (this, this without --parent).
Prints one line per measurement and a JSON line of all times.
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
sys.path.insert(0, os.path.join(HERE, "scripts"))

CEILING_BITS = (34, 35)
CEILING_N = (3 * 524288, 1 << 22)  # a build step's atomics, a 2^22 target set's
MODES = {0: "atomicOr, result unused", 1: "red.global.or.b32", 2: "atomicOr, result used"}
STEP_KEYS, TARGET_KEYS = 524288, 1 << 22  # BUILD_BLOCKS * build_block; phase 4c's T
MK_THREADS = (256, 128, 512, 1024)  # kCkThreads: the shipped width first

RMW = r"""
#include <cuda_runtime.h>
#include <cstdint>
namespace {
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13; h *= 0xC2B2AE35u; h ^= h >> 16;
  return h;
}
template <int MODE, int R>
__global__ void rmw_kernel(uint32_t* __restrict__ words, uint32_t wmask,
                           uint32_t* __restrict__ out, long long threads) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < R; r++) {
    const uint32_t c = (uint32_t)(t * R + r);
    uint32_t* p = words + (fmix32(c * 0x9E3779B1u + 0x2545F491u) & wmask);
    const uint32_t bit = 1u << (c & 31u);
    if (MODE == 0) atomicOr(p, bit);
    if (MODE == 1) asm volatile("red.global.or.b32 [%0], %1;" :: "l"(p), "r"(bit) : "memory");
    if (MODE == 2) acc ^= atomicOr(p, bit);
  }
  if (MODE == 2) out[t] = acc;
}
template <int MODE, int R>
void go(void* words, unsigned wmask, void* out, long long n, cudaStream_t s) {
  const long long threads = n / R;
  rmw_kernel<MODE, R><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      (uint32_t*)words, wmask, (uint32_t*)out, threads);
}
}  // namespace
extern "C" int kh_rmw(void* words, unsigned wmask, void* out, long long n, int mode, int R,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 1) {
    if (mode == 0) go<0, 1>(words, wmask, out, n, s);
    else if (mode == 1) go<1, 1>(words, wmask, out, n, s);
    else go<2, 1>(words, wmask, out, n, s);
  } else if (R == 3) {
    if (mode == 0) go<0, 3>(words, wmask, out, n, s);
    else if (mode == 1) go<1, 3>(words, wmask, out, n, s);
    else go<2, 3>(words, wmask, out, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

# a thread an atomic: atomic i is atomic i % 3 of key i / 3 (the bitmap's,
# then the two bloom2 bits); built beside the shipped source
SPLIT = r"""
#include "filter.cu"
namespace {
__global__ void __launch_bounds__(256)
insert_split_kernel(uint32_t* __restrict__ w1, uint32_t* __restrict__ w2,
                    const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
                    long long n, int bits, int b2bits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 3 * n) return;
  const long long key = i / 3;
  const int r = (int)(i - 3 * key);
  const uint32_t hi = __ldg(qhi + key), lo = __ldg(qlo + key);
  if (r == 0) {
    set_bit(w1, lo, hi, bits);
    return;
  }
  uint32_t h, e = 0;
  if (r == 1) {
    h = fmix32(lo ^ (hi * 0x9E3779B1u) ^ 0x2545F491u);
    if (b2bits > 32) e = fmix32(hi ^ (lo * 0xC2B2AE3Du) ^ 0x27D4EB2Fu);
  } else {
    h = fmix32(hi ^ (lo * 0x85EBCA77u) ^ 0x633D9ABDu);
    if (b2bits > 32) e = fmix32(lo ^ (hi * 0x165667B1u) ^ 0x9E3779B9u);
  }
  set_bit(w2, h, e, b2bits);
}
}  // namespace
extern "C" int kh_insert_split(void* w1, void* w2, const void* qhi, const void* qlo,
                               long long n, int bits, int b2bits, void* stream) {
  insert_split_kernel<<<(unsigned)((3 * n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)w1, (uint32_t*)w2, (const uint32_t*)qhi, (const uint32_t*)qlo, n, bits,
      b2bits);
  return (int)cudaGetLastError();
}
"""
# kh_minikey_compact_keys variants (source rewrites of csrc/minikey.cu):
# probes that time a piece by leaving it out (their outputs are wrong by
# design), a look-back that reads 4 tiles a lane a round, and the first
# round's hashes started before the look-back (warps 1.. hash while warp 0
# looks back)
MK_SHA = "        minikey_digest(w22, base_lo + (uint32_t)ln, runs, st);\n"
MK_NO_SHA = "        for (int j = 0; j < 8; j++) st[j] = (uint32_t)ln;\n"
MK_LOOK = "        prefix = look_back(status, tile, lane);\n"
MK_NO_LOOK = "        prefix = (uint32_t)tile * 63u;\n"  # ~the mean count a tile: distinct slots
MK_WIDE = r"""__device__ uint32_t look_back(const unsigned long long* status, long long tile, int lane) {
  constexpr int kLB = 4;  // tiles a lane reads a round
  uint32_t prefix = 0;
  for (long long last = tile - 1;; last -= 32 * kLB) {
    unsigned long long s[kLB];
    bool pending = false;
#pragma unroll
    for (int q = 0; q < kLB; q++) {
      const long long j = last - lane * kLB - q;
      s[q] = j >= 0 ? ld_status(status + j) : kPrefix;
      pending |= (s[q] >> 32) == 0;
    }
    while (__any_sync(0xFFFFFFFFu, pending)) {
      __nanosleep(32);
      pending = false;
#pragma unroll
      for (int q = 0; q < kLB; q++) {
        if ((s[q] >> 32) == 0) s[q] = ld_status(status + (last - lane * kLB - q));
        pending |= (s[q] >> 32) == 0;
      }
    }
    int my = kLB;  // this lane's nearest tile with a prefix
#pragma unroll
    for (int q = kLB - 1; q >= 0; q--)
      if ((s[q] & ~0xFFFFFFFFull) == kPrefix) my = q;
    const uint32_t done = __ballot_sync(0xFFFFFFFFu, my < kLB);
    const int stop = done ? __ffs(done) - 1 : 31;
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < kLB; q++)
      if (lane < stop || (lane == stop && (!done || q <= my))) v += (uint32_t)s[q];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    prefix += v;
    if (done) return prefix;
  }
}

// scratch:"""
MK_SPEC_OLD = """    if (warp == 0) {
      uint32_t prefix = 0;
      if (tile == 0) {
        if (lane == 0) atomicExch(status, kPrefix | agg);
      } else {
        if (lane == 0) atomicExch(status + tile, kCount | agg);
        prefix = look_back(status, tile, lane);
        if (lane == 0) atomicExch(status + tile, kPrefix | (prefix + agg));
      }
      if (lane == 0) s_prefix = prefix;
    }
    __syncthreads();
    const uint32_t prefix = s_prefix;
    const uint32_t excl = before + incl - c;  // the tile's valid lanes before this thread's
    // the tile's ranks [0, lim) land in slots prefix + rank < V
    const uint32_t lim = prefix >= (uint32_t)V ? 0u : min(agg, (uint32_t)V - prefix);
    for (uint32_t r0 = 0; r0 < lim; r0 += kCkThreads) {"""
MK_SPEC_NEW = """    if (t == 0) atomicExch(status + tile, (tile == 0 ? kPrefix : kCount) | agg);
    const uint32_t excl = before + incl - c;  // the tile's valid lanes before this thread's
    // the first round, ranks below kCkThreads - 32 (each lands below V
    // whatever the prefix), is hashed by warps 1.. during the look-back
    constexpr uint32_t kSpec = kCkThreads - 32;
    const uint32_t lim0 = min(agg, min((uint32_t)V, kSpec));
    {
      unsigned long long f = flags;
      for (uint32_t rank = excl; f && rank < kSpec; rank++) {
        const int j = __ffsll((long long)f) - 1;
        f &= f - 1;
        s_lane[rank] = (int32_t)(i0 + j);
      }
    }
    __syncthreads();
    uint32_t st0[8];
    int32_t ln0 = 0;
    if (warp == 0) {
      uint32_t prefix = 0;
      if (tile != 0) {
        prefix = look_back(status, tile, lane);
        if (lane == 0) atomicExch(status + tile, kPrefix | (prefix + agg));
      }
      if (lane == 0) s_prefix = prefix;
    } else if (t - 32 < (int)lim0) {
      ln0 = s_lane[t - 32];
      minikey_digest(w22, base_lo + (uint32_t)ln0, runs, st0);
    }
    __syncthreads();
    const uint32_t prefix = s_prefix;
    const uint32_t lim = prefix >= (uint32_t)V ? 0u : min(agg, (uint32_t)V - prefix);
    if (warp > 0 && t - 32 < (int)min(lim0, lim)) {
      const long long slot = prefix + (t - 32);
      vidx[slot] = ln0;
#pragma unroll
      for (int j = 0; j < 8; j++) k[(long long)j * V + slot] = st0[7 - j];
    }
    for (uint32_t r0 = kSpec; r0 < lim; r0 += kCkThreads) {"""
# variant -> (text replaced, its replacement); the probes' outputs are not compared
MK_VARIANTS = {"mk_probe_no_sha": (MK_SHA, MK_NO_SHA),
               "mk_probe_no_lookback": (MK_LOOK, MK_NO_LOOK),
               "mk_wide_lookback": (None, None), "mk_spec_sha": (MK_SPEC_OLD, MK_SPEC_NEW)}
RED_ASM = ('asm volatile("red.global.or.b32 [%0], %1;" :: "l"(words + word), '
           '"r"(1u << bit) : "memory");')

# the tree's bitmap set-up and minikeys chunk, run from the tree's root (its
# own package and chip_smoke.py); prints a JSON line
CHUNK = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from keyhuntm1cpu_tpu_torch import _build
from keyhuntm1cpu_tpu_torch.engine import minikeys as mk
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

_build.kernels()
out = {}
rng = np.random.default_rng(5)
raw = [r.tobytes() for r in rng.integers(0, 256, (cs.WK_T, 20), dtype=np.uint8)]
ts = TargetSet(kind="hash160", raw=raw, labels=[""] * len(raw))
torch.cuda.synchronize()
t0 = time.time()
bm = ts.build_bitmap(device="cuda")
torch.cuda.synchronize()
out["bitmap_s"] = time.time() - t0
out["bitmap_bits"] = bm.bits_log2
del bm, ts, raw
torch.cuda.empty_cache()
params = mk.tuned_params(batch=cs.MK_BATCH)
eng = mk.MinikeyEngine(TargetSet(kind="hash160", raw=[b"\x01" * 20], labels=["t"]),
                       prefix=cs.MK_PREFIX, params=params, device="cuda")
low, _, w22, w23 = cs.minikey_bases(eng, mk._B58, cs.MK_COUNTER)
chunk = lambda: eng._chunk_fn(low, w22, w23)
chunk()
ops = cs.device_launches(chunk)
card_ms, _ = cs.device_ms(chunk, 10)
enqueue = []
for _ in range(20):
    torch.cuda.synchronize()
    t = time.perf_counter()
    chunk()
    enqueue.append(1000 * (time.perf_counter() - t))
eng.counter = cs.MK_COUNTER
eng.search(max_chunks=1, stop_on_first=False)  # warm-up chunk
torch.cuda.synchronize()
k0 = eng.stats.keys_covered
t0 = time.time()
eng.search(max_seconds=3.0, stop_on_first=False)
torch.cuda.synchronize()
dt = time.time() - t0
out["minikeys"] = dict(ops=ops, enqueue_ms=float(np.median(enqueue)), card_ms=card_ms,
                       rate=(eng.stats.keys_covered - k0) / dt)
print(json.dumps(out))
"""


def sass_ops(so, pattern=r"RED|ATOM"):
    """{function: {opcode: count}} of the opcodes matching `pattern` in
    the SASS of the shared library `so` (cuobjdump -sass)."""
    from collections import Counter

    from keyhuntm1cpu_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=300)
    counts, name = {}, None
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if name and m and re.match(pattern, m.group(1)):
            counts[name][m.group(1)] += 1
    return {k: dict(c) for k, c in counts.items()}


def rmw_ceiling(words, bits_list=CEILING_BITS, ns=CEILING_N, log=print):
    """ms of n random 4-byte atomicOr over the first 2^bits bits of the
    int32 tensor `words` (on the card; its bits change), for each bits and
    n, in each mode and at 1 and 3 a thread. Returns {"2^bits bits, n
    atomics": {mode and atomics a thread: ms}}."""
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from torch_pwalk_shapes import build

    lib = build([("rmw", RMW, HERE)], os.path.join(_build.build_dir(), "filter_rmw"))["rmw"][0]
    lib.kh_rmw.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sink = torch.empty(max(ns), dtype=torch.int32, device=words.device)
    st = torch.cuda.current_stream(words.device).cuda_stream
    res = {}
    for bits in bits_list:
        if (1 << (bits - 5)) > words.numel():
            cs.fail(f"rmw_ceiling: 2^{bits} bits exceed the buffer")
        for n in ns:
            row = {}
            for mode, label in MODES.items():
                for r in (1, 3):
                    def run(bits=bits, n=n, mode=mode, r=r):
                        rc = lib.kh_rmw(words.data_ptr(), (1 << (bits - 5)) - 1,
                                        sink.data_ptr(), n, mode, r, st)
                        if rc:
                            cs.fail(f"rmw launch failed (cudaError {rc})")
                    row[f"{label}, {r} a thread"], _ = cs.device_ms(run, 20)
            res[f"2^{bits} bits, {n} atomics"] = row
            best = min(row.values())
            log(f"random RMW ceiling 2^{bits} bits, {n} atomics: "
                + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
                + f" ms; best {n / best / 1e6:.3f} G atomics/s")
    return res


def k3_source(src, threads=None, blocks_per_sm=None, red_asm=False):
    out = src
    for name, v in (("kThreads", threads), ("kMaxBlocksPerSM", blocks_per_sm)):
        if v is not None:
            out, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", out)
            assert n == 1, name
    if red_asm:
        out, n = re.subn(r"atomicOr\(words \+ word, 1u << bit\);", RED_ASM, out)
        assert n == 1, "set_bit"
    return out


def chunk_runs(trees, log):
    """{label: [result, ...]} of the CHUNK program in each tree, in order."""
    out = {}
    for label, root in trees:
        res = subprocess.run([sys.executable, "-c", CHUNK], cwd=root, capture_output=True,
                             text=True, timeout=900)
        if res.returncode:
            raise RuntimeError(f"chunk program in {root} failed:\n{res.stdout}\n{res.stderr}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        v = r["minikeys"]
        log(f"{label} ({root}): brute target bitmap set-up {r['bitmap_s']:.3f} s (2^22 "
            f"targets, 2^{r['bitmap_bits']} bits); minikeys chunk {v['ops']} device "
            f"operations, host enqueue {v['enqueue_ms']:.3f} ms, card {v['card_ms']:.3f} ms, "
            f"{v['rate']:.4e} minikeys/s")
        out.setdefault(label, []).append(r)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--chunk", action="store_true",
                    help="also time the bitmap set-up and the minikeys chunk of each tree")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.engine import minikeys as mk
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.hash import pminikey
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet
    from torch_pwalk_shapes import build

    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card {card}")
    out = {"card": card}
    st = torch.cuda.current_stream().cuda_stream
    vp, i, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    csrc = os.path.join(HERE, "keyhuntm1cpu_tpu_torch", "csrc")
    pdir = (os.path.join(os.path.abspath(args.parent), "keyhuntm1cpu_tpu_torch", "csrc")
            if args.parent else None)
    read = lambda d, f: open(os.path.join(d, f)).read()

    # every library of this run, built at once
    src = read(csrc, "filter.cu")
    jobs = [("rmw", RMW, csrc), ("k3_shipped", src, csrc),
            ("k3_T512", k3_source(src, threads=512), csrc),
            ("k3_wave", k3_source(src, blocks_per_sm=8), csrc),
            ("k3_T512_wave", k3_source(src, threads=512, blocks_per_sm=4), csrc),
            ("k3_red_asm", k3_source(src, red_asm=True), csrc), ("k3_split", SPLIT, csrc)]
    mk_src = read(csrc, "minikey.cu")
    for t in MK_THREADS:
        text, n = re.subn(r"constexpr int kCkThreads = \d+;", f"constexpr int kCkThreads = {t};",
                          mk_src)
        assert n == 1
        jobs.append((f"mk_T{t}", text, csrc))
    lb = mk_src.index("__device__ uint32_t look_back(")
    lb_end = mk_src.index("// scratch:", lb)
    for name, (a, b) in MK_VARIANTS.items():
        text = (mk_src[:lb] + MK_WIDE + mk_src[lb_end + len("// scratch:"):]
                if name == "mk_wide_lookback" else mk_src)
        if a is not None:
            assert text.count(a) == 1, name
            text = text.replace(a, b)
        jobs.append((name, text, csrc))
    if pdir:
        jobs += [("k3_parent", read(pdir, "filter.cu"), pdir),
                 ("mk_parent", read(pdir, "minikey.cu"), pdir)]
    out_dir = os.path.join(_build.build_dir(), "filter_shapes")
    libs = build(jobs, out_dir)
    for name in ("rmw", "k3_shipped", "k3_red_asm", "k3_split"):
        cs.log(f"SASS atomics of {name}: {sass_ops(os.path.join(out_dir, name + '.so'))}")

    # 1. the random read-modify-write ceiling
    big = torch.zeros(1 << 30, dtype=torch.int32, device=dev)  # 2^35 bits
    out["ceiling"] = rmw_ceiling(big, log=cs.log)
    del big
    torch.cuda.empty_cache()

    # 2. K3's shapes, held to the shipped kernel
    g = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda n: torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                                  generator=g)
    step_hi, step_lo = rnd(STEP_KEYS), rnd(STEP_KEYS)
    tgt_hi, tgt_lo = rnd(TARGET_KEYS), rnd(TARGET_KEYS)
    ones = torch.ones(TARGET_KEYS, dtype=torch.bool, device=dev)
    shapes = {"step": (step_hi, step_lo, 35, 35), "targets": (tgt_hi, tgt_lo, 34, None)}
    want = {}
    for key, (h, l, bits, b2bits) in shapes.items():
        w1 = bmp.empty_filter(bits, dev)
        w2 = None if b2bits is None else bmp.empty_filter(b2bits, dev)
        bmp.insert_keys(w1, bits, w2, b2bits or 0, h, l, h.shape[0])
        want[key] = (w1, w2)
    times = {}
    for name, (lib, blog) in libs.items():
        if not name.startswith("k3_"):
            continue
        if name == "k3_parent":
            lib.kh_insert_keys.argtypes = [vp] * 5 + [i64, i, i, vp]
        else:
            lib.kh_insert_keys.argtypes = [vp] * 4 + [i64, vp, vp, i, vp, i, i, vp]
        row = {}
        for key, (h, l, bits, b2bits) in shapes.items():
            if key == "targets" and name in ("k3_split", "k3_parent"):
                continue  # one atomic a key; the parent built this bitmap on the host
            w1 = bmp.empty_filter(bits, dev)
            w2 = None if b2bits is None else bmp.empty_filter(b2bits, dev)
            n = h.shape[0]

            def run(lib=lib, name=name, w1=w1, w2=w2, h=h, l=l, n=n, bits=bits,
                    b2bits=b2bits or 0):
                w2p = None if w2 is None else w2.data_ptr()
                if name == "k3_split":
                    rc = lib.kh_insert_split(w1.data_ptr(), w2p, h.data_ptr(), l.data_ptr(), n,
                                             bits, b2bits, st)
                elif name == "k3_parent":
                    rc = lib.kh_insert_keys(w1.data_ptr(), w2p, h.data_ptr(), l.data_ptr(),
                                            ones.data_ptr(), n, bits, b2bits, st)
                else:
                    rc = lib.kh_insert_keys(w1.data_ptr(), w2p, h.data_ptr(), l.data_ptr(), n,
                                            None, None, 0, None, bits, b2bits, st)
                if rc:
                    cs.fail(f"{name} launch failed (cudaError {rc})")

            if name == "k3_split":
                lib.kh_insert_split.argtypes = [vp] * 4 + [i64, i, i, vp]
            run()
            torch.cuda.synchronize()
            if not (torch.equal(w1, want[key][0])
                    and (w2 is None or torch.equal(w2, want[key][1]))):
                cs.fail(f"{name} differs from the shipped K3 ({key})")
            row[key], _ = cs.device_ms(run, 20)
            del w1, w2
            torch.cuda.empty_cache()
        regs = "; ".join(ln for ln in cs.ptxas_summary(blog) if "insert" in ln)
        cs.log(f"K3 {name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
               + f" (step: {STEP_KEYS} keys into 2^35 + 2^35 bits; targets: {TARGET_KEYS} "
               f"keys into 2^34 bits) | {regs}")
        times[name] = row
    out["k3"] = times
    del want
    torch.cuda.empty_cache()

    # the build step before and after, on the same walk
    ub, K = cs.BUILD_BLOCK, bsgs.BUILD_BLOCKS
    walk = pwalk.walk_tables(ecref.G, ub, ecref.scalar_mult(ub), K, dev)
    tx, ty, ax, ay, adv_tab = walk[:5]
    limbs = lambda v: torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)
    base = ecref.scalar_mult(2 * ub)
    px, py = limbs(base[0])[None], limbs(base[1])[None]
    w1, w2 = bmp.empty_filter(35, dev), bmp.empty_filter(35, dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    KU = K * ub
    steps = {"after (filter_build_step)": lambda: bsgs.filter_build_step(
        px, py, walk, w1, 35, w2, 35, KU, bad)}
    if pdir:
        plib = libs["k3_parent"][0]
        lane = torch.arange(KU, dtype=torch.int64, device=dev)

        def before():
            res = pwalk.chunk_multi(px, py, tx, ty, ax, ay, K=K, U=ub, T=1, adv_tab=adv_tab)
            keep = lane < KU
            rc = plib.kh_insert_keys(w1.data_ptr(), w2.data_ptr(), res.qhi.data_ptr(),
                                     res.qlo.data_ptr(), keep.data_ptr(), KU, 35, 35, st)
            if rc:
                cs.fail(f"parent K3 launch failed (cudaError {rc})")
            bad.add_((res.degenerate.reshape(-1) & keep).sum())
            bad.add_(res.adv_degenerate.sum())
            return res.next_x, res.next_y
        steps["before (parent's K3, keep mask, count ops)"] = before
    step_out = {}
    for label, fn in steps.items():
        fn()
        ops = cs.device_launches(fn)
        ms, _ = cs.device_ms(fn, 20)
        step_out[label] = dict(ops=ops, ms=ms)
        cs.log(f"build step {label}: {ops} device operations, {ms:.4f} ms on the card "
               f"(K = {K}, build_block = {ub}, 2^35 + 2^35 bits)")
    if int(bad):
        cs.fail("a degenerate lane in the build step")
    out["build_step"] = step_out
    del w1, w2, tx, ty, adv_tab, walk
    torch.cuda.empty_cache()

    # 3. the minikey compaction and keys: tile widths, and the composition
    B, V = cs.MK_BATCH, mk.valid_budget(cs.MK_BATCH)
    eng = mk.MinikeyEngine(TargetSet(kind="hash160", raw=[b"\x01" * 20], labels=["t"]),
                           prefix=cs.MK_PREFIX, params=mk.tuned_params(batch=B), device=dev)
    low, _, w22, w23 = cs.minikey_bases(eng, mk._B58, cs.MK_COUNTER)
    valid = pminikey.minikey_valid(low, w23, B, mk._B58)
    runs = pminikey._runs_array(mk._B58)
    ref = pminikey.compact_keys(valid, V, low, w22, B, mk._B58)
    mk_times = {}
    for name in [f"mk_T{t}" for t in MK_THREADS] + list(MK_VARIANTS):
        lib, blog = libs[name]
        lib.kh_minikey_compact_keys.argtypes = [vp] * 6 + [u32, i64, i, vp, i, vp]
        tile = lib.kh_minikey_tile()
        outs = (torch.empty((), dtype=torch.int32, device=dev),
                torch.empty(V, dtype=torch.int32, device=dev),
                torch.empty((8, V), dtype=torch.int32, device=dev))
        scratch = torch.empty(1 + -(-B // tile), dtype=torch.int64, device=dev)

        def run(lib=lib, outs=outs, scratch=scratch):
            rc = lib.kh_minikey_compact_keys(valid.data_ptr(), w22.data_ptr(),
                                             *[o.data_ptr() for o in outs], scratch.data_ptr(),
                                             low, B, V, runs.ctypes.data, runs.shape[1], st)
            if rc:
                cs.fail(f"kh_minikey_compact_keys launch failed (cudaError {rc})")
            return outs

        ms, got = cs.device_ms(run, 20)
        if "probe" in name:
            how = "a timing probe, its output wrong by design"
        elif all(torch.equal(a, b) for a, b in zip(got, ref)):
            how = "equal to the shipped kernel"
        else:
            cs.fail(f"compact_keys {name} differs from the shipped kernel")
        regs = "; ".join(ln for ln in cs.ptxas_summary(blog) if "compact" in ln)
        mk_times[f"{name}, tile {tile}"] = ms
        cs.log(f"compact_keys {name} (tile {tile} lanes): {ms:.4f} ms at B={B}, V={V} "
               f"({int(ref[0])} valid; {how}) | {regs}")
    comps = {"compact_keys (shipped)": lambda: pminikey.compact_keys(valid, V, low, w22, B,
                                                                   mk._B58),
             "count + compact_positions": lambda: (valid.sum(dtype=torch.int32),
                                                   bmp.compact_positions(valid, V, B))}
    if pdir:
        plib = libs["mk_parent"][0]
        plib.kh_minikey_keys.argtypes = [vp, vp, vp, u32, i64, i, vp, i, vp]

        def composition():
            n_valid = valid.sum(dtype=torch.int32)
            vidx = bmp.compact_positions(valid, V, B)
            k = torch.empty((8, V), dtype=torch.int32, device=dev)
            rc = plib.kh_minikey_keys(vidx.data_ptr(), w22.data_ptr(), k.data_ptr(), low, B, V,
                                      runs.ctypes.data, runs.shape[1], st)
            if rc:
                cs.fail(f"parent kh_minikey_keys launch failed (cudaError {rc})")
            return n_valid, vidx, k
        comps["count + compact_positions + parent's kh_minikey_keys"] = composition
    comp_out = {}
    for label, fn in comps.items():
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            cs.fail(f"{label} differs from compact_keys")
        ops = cs.device_launches(fn)
        ms, _ = cs.device_ms(fn, 20)
        comp_out[label] = dict(ops=ops, ms=ms)
        cs.log(f"minikey compaction and keys, {label}: {ops} device operations, {ms:.4f} ms "
               f"on the card (equal outputs)")
    out["compact_keys"] = dict(tiles=mk_times, compositions=comp_out)
    del eng, valid, ref
    torch.cuda.empty_cache()

    # 4. the bitmap set-up and the minikeys chunk, each tree in its own process
    if args.chunk:
        this = ("this tree", HERE)
        trees = ([("parent", os.path.abspath(args.parent)), this, this,
                  ("parent", os.path.abspath(args.parent))] if args.parent else [this, this])
        out["chunk"] = chunk_runs(trees, cs.log)
    cs.log(f"card {card}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
