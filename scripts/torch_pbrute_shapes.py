#!/usr/bin/env python3
"""Time the fused brute chunk's kernels on an NVIDIA GPU: K4 in its shapes,
with and without the block's shared inversion, the compaction kernel
against the torch ops it replaced, and whole fused chunks.

    python3 scripts/torch_pbrute_shapes.py [--parent DIR] [--chunk] [--compaction]

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
   to enqueue a call. Then csrc/compact.cu in other forms, each built by
   its own nvcc, launched through ctypes on a scratch pair of its own and
   held to the shipped summary: SPLIT_SOURCE with 2 and 4 blocks a step
   (each part with its own counts) at 512 threads a block, 2 and 4 at 256
   and 128 threads (the shipped kernel: a block a step of 512), kBatch = 2
   and 8 rows in flight a warp (4 shipped), kPrefetch = 1 flag word loaded
   beside each step's count in the last block (4 shipped), and the
   shipped form without its last block's compaction
   (only the per-step words held equal: the tail's share); with --parent,
   DIR's compact.cu (its own signature: one scratch, a memset of the
   ticket before each launch), in turns (parent, shipped, the forms,
   shipped, parent); on K4's rmd160 hit words (3 hits) and on a chunk
   with no hit (the usual chunk over a few targets).
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


# kh_compact_hits with kSplit blocks a step, each with its own counts of
# its rows (on 32-row boundaries), degenerate words and first, merged by
# the last block: the compaction's multi-block forms
SPLIT_SOURCE = r"""
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kSplit = 1;  // blocks a step, each with its own counts
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;  // words of a hit row
constexpr int kBatch = 4;    // rows a warp loads before it reduces them
constexpr int kPrefetch = 4;  // flag words the last block loads beside a part's count
constexpr uint32_t kQueryMask = (1u << 30) - 1;

struct CompactArgs {
  const uint32_t* hits;   // (K, U)
  const uint8_t* adeg;    // (K,)
  int32_t* out;           // (2C + 3K + 1,)
  unsigned long long* ticket;  // zero on entry: blocks done << 32 | their flagged rows
  unsigned long long* next;    // the next launch's ticket, zeroed here
  uint32_t* part_rows;    // (K*kSplit) flagged rows of each part
  uint32_t* part_deg;     // (K*kSplit) degenerate words of each part (kSplit > 1)
  uint32_t* part_first;   // (K*kSplit) the first of them in the step, or U (kSplit > 1)
  uint32_t* rowbits;      // (K, W) the flags of step k's rows, bit r % 32 of word r / 32
  int K, U, C, R, W;
};

// The block's exclusive scan of one value a thread; *total gets the sum.
// Every thread must call it.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* s_warp, uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    const uint32_t x = s_warp[w];
    before += w < warp ? x : 0u;
    agg += x;
  }
  __syncthreads();  // s_warp is reused
  *total = agg;
  return before + incl - v;
}

// The flag words [*w0, *w1) of step k that part s covers: kSplit even
// shares of the step's W words (empty when W < kSplit).
__device__ __forceinline__ void part_words(int W, int s, int* w0, int* w1) {
  *w0 = s * W / kSplit;
  *w1 = (s + 1) * W / kSplit;
}

// Block b = k*kSplit + s: part s of step k's row flags, flagged-row count
// and degenerate summary. Returns the flagged-row count (in thread 0).
__device__ uint32_t part_summary(const CompactArgs& a, int b, uint32_t* s_bits,
                                 uint32_t* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = b / kSplit, s = b % kSplit;
  int w0, w1;
  part_words(a.W, s, &w0, &w1);
  const int r0 = 32 * w0, rows = min(32 * w1, a.U / kLanes) - r0;  // this part's rows
  const uint4* step = reinterpret_cast<const uint4*>(a.hits + (long long)k * a.U);
  for (int j = threadIdx.x; j < w1 - w0; j += kThreads) s_bits[j] = 0;
  __syncthreads();
  uint32_t n_deg = 0, n_flag = 0;
  int first = a.U;
  for (int i0 = warp; i0 < rows; i0 += kWarps * kBatch) {
    uint4 w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; j++) {
      const int i = i0 + j * kWarps;
      w[j] = i < rows ? __ldg(step + (long long)(r0 + i) * 32 + lane) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kBatch; j++) {
      const int i = i0 + j * kWarps;  // warp-uniform
      if (i < rows) {
        const bool flag = __any_sync(0xFFFFFFFFu, ((w[j].x | w[j].y | w[j].z | w[j].w) &
                                                   kQueryMask) != 0);
        if (lane == 0 && flag) atomicOr(s_bits + i / 32, 1u << (i % 32));
        n_flag += flag;
        const uint32_t d = ((w[j].x >> 30) & 1u) | ((w[j].y >> 29) & 2u) |
                           ((w[j].z >> 28) & 4u) | ((w[j].w >> 27) & 8u);
        n_deg += __popc(d);
        if (d) first = min(first, (r0 + i) * kLanes + 4 * lane + __ffs(d) - 1);
      }
    }
  }
  n_deg = __reduce_add_sync(0xFFFFFFFFu, n_deg);
  first = __reduce_min_sync(0xFFFFFFFFu, first);
  if (lane == 0) {
    s_red[warp] = n_deg;
    s_red[kWarps + warp] = (uint32_t)first;
    s_red[2 * kWarps + warp] = n_flag;  // the same in every lane
  }
  __syncthreads();
  for (int j = threadIdx.x; j < w1 - w0; j += kThreads)
    a.rowbits[(long long)k * a.W + w0 + j] = s_bits[j];
  uint32_t nf = 0;
  if (threadIdx.x == 0) {
    uint32_t nd = 0;
    int f = a.U;
    for (int i = 0; i < kWarps; i++) {
      nd += s_red[i];
      f = min(f, (int)s_red[kWarps + i]);
      nf += s_red[2 * kWarps + i];
    }
    a.part_rows[b] = nf;
    if constexpr (kSplit == 1) {
      a.out[2 * a.C + k] = (int32_t)nd;
      a.out[2 * a.C + a.K + k] = f < a.U ? f : 0;
    } else {
      a.part_deg[b] = nd;
      a.part_first[b] = (uint32_t)f;
    }
    if (s == 0) a.out[2 * a.C + 2 * a.K + k] = a.adeg[k] != 0;
  }
  return nf;
}

// The last block, n_rows flagged rows in all: the first R of them, then
// the first C non-zero query words in them (and, kSplit > 1, each step's
// degenerate words). The parts' counts and row flags come from other
// blocks (through L2: __ldcg).
__device__ void compact(const CompactArgs& a, uint32_t n_rows, int* s_rsel, uint32_t* s_warp) {
  const int t = threadIdx.x;
  const int rows = a.U / kLanes, parts = a.K * kSplit;
  if constexpr (kSplit > 1) {
    for (int k = t; k < a.K; k += kThreads) {
      uint32_t nd = 0, f = (uint32_t)a.U;
      for (int s = 0; s < kSplit; s++) {
        nd += __ldcg(a.part_deg + k * kSplit + s);
        f = min(f, __ldcg(a.part_first + k * kSplit + s));
      }
      a.out[2 * a.C + k] = (int32_t)nd;
      a.out[2 * a.C + a.K + k] = f < (uint32_t)a.U ? (int32_t)f : 0;
    }
  }
  uint32_t n = 0;
  if (n_rows) {  // block-uniform
    // 1. rank the parts' flagged rows; a part with rows to give expands
    // its flag words
    uint32_t base = 0;
    for (int e0 = 0; e0 < parts; e0 += kThreads) {
      const int e = e0 + t, k = e / kSplit;
      int w0 = 0, w1 = 0;
      if (e < parts) part_words(a.W, e % kSplit, &w0, &w1);
      const uint32_t* bits = a.rowbits + (long long)k * a.W;
      // the count and the first flag words, loaded together (one round trip)
      const uint32_t c = e < parts ? __ldcg(a.part_rows + e) : 0u;
      uint32_t pre[kPrefetch];
#pragma unroll
      for (int j = 0; j < kPrefetch; j++) pre[j] = w0 + j < w1 ? __ldcg(bits + w0 + j) : 0u;
      uint32_t tot;
      uint32_t rank = base + block_scan(c, s_warp, &tot);
      if (c && rank < (uint32_t)a.R) {
#pragma unroll
        for (int j = 0; j < kPrefetch; j++) {
          for (uint32_t b = pre[j]; b && rank < (uint32_t)a.R; b &= b - 1)
            s_rsel[rank++] = k * rows + 32 * (w0 + j) + __ffs(b) - 1;
        }
        for (int j = w0 + kPrefetch; j < w1 && rank < (uint32_t)a.R; j++) {
          for (uint32_t b = __ldcg(bits + j); b && rank < (uint32_t)a.R; b &= b - 1)
            s_rsel[rank++] = k * rows + 32 * j + __ffs(b) - 1;
        }
      }
      base += tot;
    }
    const int picked = (int)min(base, (uint32_t)a.R);  // base == n_rows
    __syncthreads();
    // 2. the non-zero query words of the picked rows, in order (the rows
    // past the flagged ones are padding and hold none)
    for (int i0 = 0; i0 < picked * kLanes; i0 += kThreads) {
      const int i = i0 + t;
      uint32_t q = 0;
      int p = 0;
      if (i < picked * kLanes) {
        p = s_rsel[i / kLanes] * kLanes + i % kLanes;
        q = __ldcg(a.hits + p) & kQueryMask;
      }
      uint32_t tot;
      const uint32_t r = n + block_scan(q != 0, s_warp, &tot);
      if (q && r < (uint32_t)a.C) {
        a.out[r] = p;
        a.out[a.C + r] = (int32_t)q;
      }
      n += tot;
    }
  }
  for (int j = (int)min(n, (uint32_t)a.C) + t; j < a.C; j += kThreads) {
    a.out[j] = a.K * a.U;
    a.out[a.C + j] = 0;
  }
  if (t == 0) a.out[2 * a.C + 3 * a.K] = n_rows > (uint32_t)a.R ? a.C + 1 : (int32_t)n;
}

__global__ void __launch_bounds__(kThreads) compact_hits_kernel(CompactArgs a) {
  // max(W, R) words: the part's row flags, then (the last block) the R
  // picked rows
  extern __shared__ uint32_t s_dyn[];
  __shared__ uint32_t s_red[3 * kWarps];
  __shared__ bool s_last;
  __shared__ uint32_t s_rows;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.next = 0;
  const uint32_t nf = part_summary(a, blockIdx.x, s_dyn, s_red);
  __threadfence();  // this block's flags and counts before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(a.ticket, 1ull << 32 | nf);
    s_last = old >> 32 == gridDim.x - 1;
    s_rows = (uint32_t)old + nf;  // every block's, in the last one
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  compact(a, s_rows, reinterpret_cast<int*>(s_dyn), s_red);
}

}  // namespace

// scratch: 2 + 3*K*kSplit + K*W u32 (W = ceil(U / 4096)), its first two
// (the ticket) zero on entry; next: the other scratch, whose ticket this
// launch zeroes.
extern "C" int kh_compact_hits(const void* hits, const void* adeg, void* out, void* scratch,
                               void* next, int K, int U, int C, void* stream) {
  if (K < 1 || U < kLanes || U % kLanes || C < 1 || (long long)K * U >= 0x7FFFFFFFLL ||
      (long long)K * kSplit >= 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int R = C / 32 > 8 ? C / 32 : 8;
  const int W = (U / kLanes + 31) / 32;
  const size_t smem = (size_t)(R > W ? R : W) * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)scratch;
  const long long parts = (long long)K * kSplit;
  uint32_t* part_rows = w + 2;
  uint32_t* extra = part_rows + parts;  // the degenerate parts (kSplit > 1)
  uint32_t* rowbits = kSplit > 1 ? extra + 2 * parts : extra;
  const CompactArgs a{(const uint32_t*)hits, (const uint8_t*)adeg, (int32_t*)out,
                      (unsigned long long*)w, (unsigned long long*)next, part_rows, extra,
                      extra + parts,
                      rowbits, K, U, C, R, W};
  compact_hits_kernel<<<(unsigned)parts, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
"""
# the compaction's forms: (name, source, constants); "shipped" is
# csrc/compact.cu, "split" SPLIT_SOURCE; "notail" drops the shipped
# kernel's last-block compaction
COMPACT_FORMS = [("split2_t512", "split", dict(kSplit=2, kThreads=512)),
                 ("split4_t512", "split", dict(kSplit=4, kThreads=512)),
                 ("split2_t256", "split", dict(kSplit=2, kThreads=256)),
                 ("split4_t128", "split", dict(kSplit=4, kThreads=128)),
                 ("batch2", "shipped", dict(kBatch=2)),
                 ("batch8", "shipped", dict(kBatch=8)),
                 ("prefetch1", "shipped", dict(kPrefetch=1)),
                 ("notail", "shipped", {})]
TAIL_CALL = "compact(a, s_rows, reinterpret_cast<int*>(s_dyn), s_red);"


def compaction_forms(hits, adeg, parent, csrc, stream):
    """{input: {form: [card ms, ...]}} of kh_compact_hits' forms on (hits,
    adeg) and on no hit at C, in turns, each held to pbrute.compact_hits
    (see the docstring)."""
    import torch

    import chip_smoke as cs
    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.curve import pbrute
    from torch_pwalk_shapes import build

    K, U = hits.shape
    with open(os.path.join(csrc, "compact.cu")) as f:
        src = f.read()
    jobs = [("shipped", src, csrc)]
    for name, base, consts in COMPACT_FORMS:
        text = src if base == "shipped" else SPLIT_SOURCE
        for k, v in consts.items():
            text, n = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};", text)
            assert n == 1, k
        if name == "notail":
            assert text.count(TAIL_CALL) == 1
            text = text.replace(TAIL_CALL, "")
        jobs.append((name, text, csrc))
    if parent:
        pdir = os.path.join(os.path.abspath(parent), "keyhuntm1cpu_tpu_torch", "csrc")
        with open(os.path.join(pdir, "compact.cu")) as f:
            jobs.append(("parent", f.read(), pdir))
    libs = {k: v[0] for k, v in build(jobs, os.path.join(_build.build_dir(),
                                                         "compact_forms")).items()}
    vp, i = ctypes.c_void_p, ctypes.c_int
    steps = slice(2 * C, 2 * C + 3 * K)  # the per-step words, all that notail writes
    split = {name: consts.get("kSplit", 1) for name, _, consts in COMPACT_FORMS}

    def form(name, hits):
        lib = libs[name]
        row = torch.empty_like(want)
        ptrs = (hits.data_ptr(), adeg.data_ptr(), row.data_ptr())
        if name == "parent":  # hits adeg out scratch | K U C stream, a memset inside
            lib.kh_compact_hits.argtypes = [vp] * 4 + [i, i, i, vp]
            scratch = torch.empty((1 + K + K * -(-U // 4096),), dtype=torch.int32,
                                  device=hits.device)

            def run():
                rc = lib.kh_compact_hits(*ptrs, scratch.data_ptr(), K, U, C, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
                return row
            return run
        lib.kh_compact_hits.argtypes = [vp] * 5 + [i, i, i, vp]
        # the ticket, each part's counts (three with kSplit > 1), the row flags
        parts = K * split.get(name, 1)
        words = 2 + parts * (3 if parts > K else 1) + K * -(-U // 4096)
        pair = torch.zeros((2, -(-words // 2)), dtype=torch.int64, device=hits.device)
        turn = [0]

        def run():
            rc = lib.kh_compact_hits(*ptrs, pair[turn[0]].data_ptr(),
                                     pair[1 - turn[0]].data_ptr(), K, U, C, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")
            turn[0] ^= 1
            return row
        return run

    names = ["shipped"] + [f[0] for f in COMPACT_FORMS] + ["shipped"]
    if parent:
        names = ["parent"] + names + ["parent"]
    out = {}
    for label, h in (("K4's hits", hits), ("no hit", torch.zeros_like(hits))):
        want = pbrute.compact_hits(h, adeg, C)
        res = out[label] = {}
        for name in names:
            ms, got = cs.device_ms(form(name, h), 50)
            same = (torch.equal(got[steps], want[steps]) if name == "notail"
                    else torch.equal(got, want))
            res.setdefault(name, []).append(ms if same else None)
            if not same:
                cs.log(f"compaction form {name} differs from the shipped kernel: not timed")
        cs.log(f"compaction forms K={K} U={U} C={C} on {label} (card ms, in turns): "
               + ", ".join(f"{k} " + "/".join("differs" if v is None else f"{v:.4f}"
                                             for v in vs) for k, vs in res.items()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to time beside this one")
    ap.add_argument("--chunk", action="store_true", help="also time whole fused chunks")
    ap.add_argument("--compaction", action="store_true",
                    help="the compaction alone (2): no K4 designs, no SASS counts")
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
             csrc) for g, t, b, sh in variants if not args.compaction]
    if args.parent and not args.compaction:
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
    out["compaction_forms"] = compaction_forms(hits, a0, args.parent, csrc, st)

    # 3. SASS of the field product and squaring
    if not args.compaction:
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
