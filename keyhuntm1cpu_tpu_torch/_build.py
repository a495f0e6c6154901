"""Lazy builder for the port's native code.

Two shared libraries, both built on first use into ``build/`` beside this
file (or ``$KEYHUNT_TORCH_BUILD``) and loaded with ctypes:

- ``libkh_kernels_<hash>.so``: nvcc over ``csrc/*.cu`` for sm_90a, one
  nvcc per source, all started together, then one link. Each entry point
  takes raw device pointers, sizes and a CUDA stream, launches on that
  stream without synchronising, and returns a ``cudaError_t``. The
  compilers' output (``-Xptxas -v``: registers, spills) is kept beside the
  library as ``libkh_kernels_<hash>.log`` (``kernels_build_log()``).
- ``libkeyhunt_host_<hash>.so``: g++ over ``native/keyhunt_host.cpp`` (the
  JAX package's native host library: the baby-table builder, and the
  hashes, bulk address parse and exact scalar mults that ``native.py``
  binds). It is built here because ``*.so`` is not committed, and without
  ``-march=native`` so the library runs on any x86-64 host.

``<hash>`` is a digest of the sources and flags, so an edited source
rebuilds. Builds hold a file lock (parallel test workers) and land by
atomic rename. Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from typing import List, Optional

from .core import metrics

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
HOST_SRC = os.path.join(REPO_DIR, "native", "keyhunt_host.cpp")

NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = NVCC_ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17"]


def build_dir() -> str:
    return os.environ.get("KEYHUNT_TORCH_BUILD", os.path.join(PKG_DIR, "build"))


def _digest(paths: List[str], flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands in parallel; their output, or RuntimeError."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"build step failed ({' '.join(c)}):\n{o}")
    return "".join(outs)


def _build(name: str, sources: List[str], deps: List[str], cmd: List[str],
           flags: List[str], link: List[str], counter: Optional[str] = None) -> str:
    """Build `sources` unless a library with the same digest exists;
    returns the library path. Each source is compiled to an object by its
    own process (cmd + flags -c), all at once, then cmd + link makes the
    library; `counter` (a metrics counter) counts the builds."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    digest = _digest(sources + deps, cmd[:1] + flags + link)
    out = os.path.join(out_dir, f"{name}_{digest}.so")
    with open(os.path.join(out_dir, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            if counter:
                metrics.count(counter)
            tmp = out + f".tmp{os.getpid()}"
            objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
            log = _run_all([cmd + flags + ["-c", "-o", o, src]
                            for o, src in zip(objs, sources)])
            log += _run_all([cmd + link + ["-o", tmp] + objs])
            for o in objs:
                os.remove(o)
            with open(out[:-3] + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
            for old in glob.glob(os.path.join(out_dir, f"{name}_*")):
                if not old.startswith(out[:-3]):
                    os.remove(old)
    return out


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """Build (if needed) and load the CUDA kernel library: the span
    kernel_build, an nvcc build (counted in kernel_builds) or a cache load."""
    cu = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    cuh = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    with metrics.span("kernel_build"):
        lib = ctypes.CDLL(_build("libkh_kernels", cu, cuh, [_nvcc()], NVCC_FLAGS,
                                 NVCC_ARCH + ["-shared"], counter="kernel_builds"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    i64, u32 = ctypes.c_longlong, ctypes.c_uint
    sigs = {
        # w23 mask | base_lo B runs(host) n_runs stream
        "kh_minikey_valid": [vp, vp, u32, i64, vp, i, vp],
        # valid w22 n_valid vidx k scratch | base_lo B V runs(host) n_runs stream
        "kh_minikey_compact_keys": [vp] * 6 + [u32, i64, i, vp, i, vp],
        "kh_minikey_tile": [],
        # k gtx gty jac inf irr | V stream
        "kh_ladder_jac": [vp] * 6 + [i, vp],
        # jac inf ax ay | V stream
        "kh_ladder_affine": [vp] * 4 + [i, vp],
        # x lo_e hi_e lo_o hi_o | n stream
        "kh_hash160_x2": [vp] * 5 + [i, vp],
        # x y lo hi | n stream
        "kh_hash160_u": [vp] * 4 + [i, vp],
        # px py tab_x tab_y | bx by nx ny adeg | ctab_x ctab_y cx cy cflag | T K stream
        "kh_advance_chain": [vp] * 14 + [i, i, vp],
        # bx by tx ty | qlo qhi deg | words mask | hx hy cx cy cflag | R U bits stream
        "kh_walk_blocks": [vp] * 14 + [i64, i, i, vp],
        # words1 words2 qhi qlo | n_keep | deg adeg | n_adeg | bad | bits b2bits stream
        "kh_insert_keys": [vp] * 4 + [i64, vp, vp, i, vp, i, i, vp],
        # bx by tx ty tgt btab hits | K U T TB mode n_endo stream
        "kh_brute_walk_blocks": [vp] * 7 + [i64, i, i, i, i, i, vp],
        # hits adeg out scratch next | K U C stream
        "kh_compact_hits": [vp] * 5 + [i, i, i, vp],
        # a out | n stream
        "kh_inv_batch": [vp, vp, i64, vp],
        # x y lo hi | n stream
        "kh_keccak_eth": [vp] * 4 + [i, vp],
        # words qhi qlo mask | n bits bloom2 stream
        "kh_probe": [vp] * 4 + [i64, i, i, vp],
        # words qhi qlo pos ohi olo n_out scratch next | next_words n bits C stream
        "kh_probe_compact": [vp] * 9 + [i64, i64, i, i, vp],
        "kh_probe_tile": [i],
        # mask qhi qlo pos ohi olo n_out scratch next | next_words rows U C stream
        "kh_mask_compact": [vp] * 9 + [i64, i64, i, i, vp],
        # words qhi qlo pos_in n_in pos ohi olo n_out scratch next | next_words n bits C
        # fill stream
        "kh_bloom2_compact": [vp] * 11 + [i64, i64, i, i, i, vp],
        # cx cy tx ty ax ay pre totals | W U L C stream
        "kh_walk_prefix": [vp] * 8 + [i, i, i, i64, vp],
        # cx cy tx ty ax ay pre inv_totals x y deg nx ny adeg | W U L C n_endo stream
        "kh_walk_emit": [vp] * 14 + [i, i, i, i64, i, vp],
        # pos qhi qlo count key idx deg adeg out | m C W U total stream
        "kh_lookup_summary": [vp] * 9 + [i64, i, i, i, i, vp],
        # pos qhi qlo count key idx cdeg cadv rdeg radv out | m B C R U stream
        "kh_bsgs_summary": [vp] * 11 + [i64, i64, i, i, i, vp],
    }
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def kernels_build_log() -> str:
    """What the compilers printed when the loaded kernel library was built."""
    path = kernels()._name
    with open(path[:-3] + ".log") as f:
        return f.read()


@lru_cache(maxsize=1)
def host_lib() -> ctypes.CDLL:
    """Build (if needed) and load the native host library."""
    cxx = os.environ.get("CXX", "g++")
    lib = ctypes.CDLL(_build("libkeyhunt_host", [HOST_SRC], [], [cxx], GXX_FLAGS,
                             ["-shared"]))
    lib.kh_baby_build.argtypes = [ctypes.c_uint64, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_int]
    lib.kh_baby_build.restype = ctypes.c_int
    lib.kh_baby_keys_range.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.POINTER(ctypes.c_uint64)]
    lib.kh_baby_keys_range.restype = ctypes.c_int
    u8p, u64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64
    sigs = {  # name: (argtypes, restype)
        "kh_sha256": ([u8p, u64, u8p], None),
        "kh_hash160": ([u8p, u64, u8p], None),
        "kh_parse_addresses": ([ctypes.c_char_p, u64, u8p, u64], u64),
        "kh_scalar_mult": ([u8p, u8p, u8p], ctypes.c_int),
        "kh_verify_h160": ([u8p, u64, ctypes.c_int, u8p, u8p], None),
    }
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def kernel_wrappers() -> dict:
    """Kernel name -> the wrappers that launch it. Each wrapper counts its
    own launches in its ``launches`` attribute (on CUDA tensors only); the
    probe kernel has two wrappers, and the BSGS summary kernel one a
    resolve mode."""
    from .curve import pbrute, pladder, pwalk, walk
    from .engine import bsgs
    from .field import pinv
    from .filter import bitmap as bmp
    from .filter import sorted_table as st
    from .hash import phash, pminikey

    return {"advance_chain": (pwalk.advance_chain,), "walk_blocks": (pwalk.walk_blocks,),
            "insert_keys": (bmp.insert_keys,),
            "brute_walk_blocks": (pbrute.brute_walk_blocks,),
            "compact_hits": (pbrute.compact_hits,),
            "minikey_valid": (pminikey.minikey_valid,),
            "minikey_compact_keys": (pminikey.compact_keys,),
            "scalar_mult": (pladder.scalar_mult_tiles,),
            "hash160_x2": (phash.hash160_x2_from_batch,),
            "hash160_u": (phash.hash160_u_from_batch,),
            "inv_batch": (pinv.inv_batch,), "keccak_eth": (phash.keccak_eth_from_batch,),
            "probe": (bmp.probe, bmp.probe_bloom2),
            "walk_prefix": (walk.walk_prefix,), "walk_emit": (walk.walk_emit,),
            "lookup_summary": (st.lookup_summary,),
            "bloom2_compact": (bmp.bloom2_compact,), "mask_compact": (bmp.mask_compact,),
            "chunk_summary": (bsgs.chunk_summary,),
            "chunk_summary_host": (bsgs.chunk_summary_host,)}


def launch_counts() -> dict:
    """Kernel name -> its launches in this process so far."""
    return {name: sum(w.launches for w in ws) for name, ws in kernel_wrappers().items()}


def on_cuda(*tensors) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises for mixed or other devices (no silent fallback)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tensors[0].device}")
    return kind == "cuda"


class Stream(int):
    """A raw CUDA stream handle (what the entry points take) that carries
    the index of the device it belongs to."""

    device: int


def launch(fn: str, *args) -> None:
    """Call a kernel entry point; raise if the launch reported an error.
    The device of the Stream among args is current during the call: an
    entry point launches on the current device, and the stream and
    pointers it is given belong to the tensors' device, which need not be
    the one the caller has current. With the timeline on (core.metrics),
    the call is an NVTX range named by the kernel."""
    import torch

    dev = next(a.device for a in args if isinstance(a, Stream))
    tl = metrics.get_metrics().timeline
    nvtx = tl.nvtx if tl is not None else None
    if nvtx is not None:
        nvtx.range_push(fn)
    try:
        with torch.cuda.device(dev):
            rc = getattr(kernels(), fn)(*args)
    finally:
        if nvtx is not None:
            nvtx.range_pop()
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed (cudaError {rc})")


def stream(t) -> Stream:
    """Raw handle of the current CUDA stream on tensor t's device."""
    import torch

    s = Stream(torch.cuda.current_stream(t.device).cuda_stream)
    s.device = t.device.index  # a CUDA tensor's device always has one
    return s


class ScratchPairs:
    """Scratch for kernels that keep a ticket (and status words) in device
    memory and must find them zero on entry, with no memset before a
    launch. One pair of zeroed buffers a (device, stream): launches on one
    stream never overlap, so they take turns on its two buffers, and each
    launch zeroes the other one, which the launch before it used; another
    stream (a side stream, a thread's) has its own pair. whole: the kernels
    zero all of the other buffer and take its size in 64-bit words after
    the two pointers; else they zero only its first word (a ticket: the
    rest is rewritten whole by every launch). Kernels that share a pool
    must agree on what they zero."""

    def __init__(self, whole: bool):
        self.whole = whole
        self.pairs = {}  # (device, stream) -> [(2, words) int64 buffer, turn]
        self._lock = threading.Lock()

    def launch(self, fn: str, t, words: int, head: tuple, tail: tuple) -> None:
        """Launch kernel fn on the current stream of t's device with
        arguments head, this launch's buffer, the other one (and its words
        when whole), tail and the stream; this launch needs `words` 64-bit
        words. The launch and the turn are taken under a lock, so threads
        that share a stream keep them in order."""
        import torch

        s = stream(t)
        key = (s.device, int(s))
        with self._lock:
            pair = self.pairs.get(key)
            if pair is None or pair[0].shape[1] < words:
                pair = self.pairs[key] = [torch.zeros((2, words), dtype=torch.int64,
                                                      device=t.device), 0]
            buf, turn = pair
            other = (buf.shape[1],) if self.whole else ()
            launch(fn, *head, buf[turn].data_ptr(), buf[1 - turn].data_ptr(), *other, *tail, s)
            pair[1] = 1 - turn
