"""The port's bench: BSGS throughput behind a bit-exact key recovery gate,
then every gated mode section (bench.py and bench_modes.py of the JAX
package, on the port's engines).

    python -m keyhuntm1cpu_tpu_torch.bench [--device cuda|cpu]

Protocol (bench.py:59-218):
1. The exact table: host resolve (the default) builds or maps the native
   host table (filter/host_table.py, cached under .table_cache/) and
   prefaults it, then builds the two filters on the device by the
   streaming walk; device resolve builds the sorted baby table on the
   device (or loads BENCH_TABLE_CACHE, saving it there after a build),
   then its bitmap.
2. Gate: puzzle 63's key 0x7CCE5EFDACCF6808 recovered bit-exact from a
   +-3*U*stride window around it, or no rate is reported.
3. Throughput: chunks over puzzle 64's range [2^63, 2^64) for
   BENCH_SECONDS, each summary copied to the host with at most 8 in
   flight and none decoded; keys/s = chunks * K * U * stride / wall s
   (bench.py:174-175, the reference's keys = steps * N).
4. The mode sections (bench_modes.py): bsgs_t16 on the headline's table
   and filters, then the brute modes, minikeys, vanity and the -e and
   T = 4096 variants, each behind its own gate.

Prints the JSON line {"metric": "bsgs_keys_per_sec_chip", "value", "unit":
"keys/s", "vs_baseline": value / 1.2e9 (the reference README's RTX-4090
claim), "modes", "gate", "device": {"name", "power_limit"}, "m",
"resolve", "device_idle_share" (CUDA events around each chunk; null on the
CPU), "chunks", "seconds", "setup_s", "launches"} once the headline exists
and again after every section: the last JSON line on stdout is the most
complete. A failed gate or section is recorded in the line ("error" at
the top, or modes["error"]) and the bench exits 1; a refused variable
exits 2.

Environment (bench.py's names and defaults): BENCH_M (2^30), BENCH_U
(16384), BENCH_K (256), BENCH_SECONDS (20), BENCH_CAND (128: the floor of
the chunk's cascade budgets, BSGSParams.chunk_cand_max), BENCH_BITS (35;
empty: sized from m), BENCH_RESOLVE (host), BENCH_CASCADE2 (auto),
BENCH_TABLE_CACHE (device resolve's table file; empty: none), BENCH_MODES
(1; 0 or off skips the sections), BENCH_MODE_SECONDS (5), BENCH_PROFILE
(a directory: a torch.profiler trace of the throughput window), and
BENCH_DEVICE (cuda; --device beats it). BENCH_SB and BENCH_PROBE_MODE are
TPU-only and refused. bench.py's supervise() (a device probe, the TPU
queue's lock and a ladder of smaller m after a failure) is not ported:
this bench runs at the m it is given or fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from . import bench_modes as bm
from .engine.bsgs import BSGSEngine, BSGSParams, build_baby_table
from .filter import host_table as ht
from .ref import ecref

PUZZLE63_KEY = 0x7CCE5EFDACCF6808
PUZZLE64_KEY = 0xF7051F27B09112D4  # its pubkey is derived exactly (bench.py:132-135)
PUZZLE64_RANGE = (1 << 63, 1 << 64)
BASELINE_KEYS_PER_SEC = 1.2e9  # the reference README's RTX-4090 claim (bench.py:20-21)
BUILD_BLOCK = 4096
TPU_ONLY = {
    "BENCH_SB": "the Pallas walk kernel's steps a grid block",
    "BENCH_PROBE_MODE": "the Pallas bitmap-gather strategy",
}

log = bm.log


@dataclass(frozen=True)
class BenchConfig:
    m: int = 1 << 30
    block_u: int = 16384
    steps: int = 256
    seconds: float = 20.0
    cand: int = 128
    bits_log2: Optional[int] = 35
    resolve: str = "host"
    cascade2: str = "auto"
    table_cache: str = ""
    modes: bool = True
    mode_seconds: float = 5.0
    profile: str = ""
    device: str = "cuda"

    @classmethod
    def from_env(cls, env, device: Optional[str] = None) -> "BenchConfig":
        """The BENCH_* variables of env; `device` beats BENCH_DEVICE."""
        bits = env.get("BENCH_BITS", "35")
        return cls(m=int(env.get("BENCH_M", 1 << 30)), block_u=int(env.get("BENCH_U", 16384)),
                   steps=int(env.get("BENCH_K", 256)),
                   seconds=float(env.get("BENCH_SECONDS", 20.0)),
                   cand=int(env.get("BENCH_CAND", 128)), bits_log2=int(bits) if bits else None,
                   resolve=env.get("BENCH_RESOLVE", "host"),
                   cascade2=env.get("BENCH_CASCADE2", "auto"),
                   table_cache=env.get("BENCH_TABLE_CACHE", ""),
                   modes=env.get("BENCH_MODES", "1") not in ("0", "off"),
                   mode_seconds=float(env.get("BENCH_MODE_SECONDS", 5.0)),
                   profile=env.get("BENCH_PROFILE", ""),
                   device=device or env.get("BENCH_DEVICE", "cuda"))

    def params(self) -> BSGSParams:
        return BSGSParams(m=self.m, block_u=self.block_u, steps_per_chunk=self.steps,
                          build_block=BUILD_BLOCK, chunk_cand_max=self.cand,
                          bits_log2=self.bits_log2, cascade2=self.cascade2,
                          resolve=self.resolve)


def refusal(env) -> Optional[str]:
    """The reason a TPU-only variable refuses this run, or None."""
    for name, what in TPU_ONLY.items():
        if env.get(name):
            return (f"{name} is TPU-only ({what}); the CUDA kernels have one form: "
                    f"unset it")
    return None


def device_info(dev: torch.device) -> dict:
    """{"name", "power_limit"}: nvidia-smi's name and power.limit of the
    card, torch's name where nvidia-smi is absent; the CPU has neither."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        res = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        res = None
    if res is not None and res.returncode == 0 and res.stdout.strip():
        name, _, limit = res.stdout.strip().splitlines()[0].rpartition(",")
        return {"name": name.strip(), "power_limit": limit.strip()}
    return {"name": torch.cuda.get_device_name(dev), "power_limit": None}


def headline(cfg: BenchConfig, dev: torch.device, result: dict, emit) -> dict:
    """Steps 1-3 into `result`; returns the table and filters for the
    sections (BSGSEngine's keyword arguments). Raises GateError when
    puzzle 63's key is not recovered."""
    params = cfg.params()
    setup = result["setup_s"]
    pub63 = ecref.scalar_mult(PUZZLE63_KEY)
    htab = table = None
    loaded = False
    # the kernels and the native host library are built on first use:
    # built here, so that no set-up step below counts the build
    t0 = time.time()
    if dev.type == "cuda":
        _build.kernels()
    _build.host_lib()
    setup["build"] = time.time() - t0
    if cfg.resolve == "host":
        # the host exact table: mapped from the disk cache, or built once by
        # the native library; prefaulted so page-ins stay out of the decode
        t0 = time.time()
        htab = ht.ensure_host_table(cfg.m, ht.DEFAULT_CACHE_DIR, progress=True)
        setup["host_table"] = time.time() - t0
        t0 = time.time()
        htab.prefault()
        setup["prefault"] = time.time() - t0
        log(f"[bench] host table m={cfg.m} ready in {setup['host_table']:.1f} s, "
            f"prefault {setup['prefault']:.1f} s")
    else:
        t0 = time.time()
        if cfg.table_cache and os.path.exists(cfg.table_cache):
            try:
                table = BSGSEngine.load_table(cfg.table_cache, device=dev)
            except (OSError, ValueError, KeyError) as e:
                log(f"[bench] table cache load failed ({e}); rebuilding")
            if table is not None and table.key.shape[0] != cfg.m:
                log(f"[bench] table cache holds m={table.key.shape[0]}, not {cfg.m}; rebuilding")
                table = None
        loaded = table is not None
        if not loaded:
            table = build_baby_table(cfg.m, BUILD_BLOCK, dev)
            bm.sync(dev)
        setup["table"] = time.time() - t0
        log(f"[bench] baby table m={cfg.m} {'loaded' if loaded else 'built'} in "
            f"{setup['table']:.2f} s")
    t0 = time.time()
    eng = BSGSEngine([pub63], *PUZZLE64_RANGE, params, device=dev, host_table=htab,
                     table=table)
    bm.sync(dev)
    setup["filters"] = time.time() - t0
    log(f"[bench] filters built in {setup['filters']:.2f} s (bits={eng.bitmap.bits_log2}, "
        f"C1={eng.C1}, C2={eng.C2})")
    if cfg.resolve == "device" and cfg.table_cache and not loaded:
        eng.save_table(cfg.table_cache)
    shared = dict(table=eng.table, bitmap=eng.bitmap, host_table=eng.host_table,
                  bloom2=eng.bloom2)

    # gate: puzzle 63 from a window of +-3 device steps around its key
    window = cfg.block_u * eng.stride
    eng63 = BSGSEngine([pub63], PUZZLE63_KEY - 3 * window, PUZZLE63_KEY + 3 * window, params,
                       device=dev, **shared)
    t0 = time.time()
    keys = [f.private_key for f in eng63.search()]
    if keys != [PUZZLE63_KEY]:
        raise bm.GateError(f"puzzle-63 recovery FAILED: {[hex(k) for k in keys]}")
    result["gate"] = "ok"
    log(f"[gate] puzzle-63 key recovered bit-exact in {time.time() - t0:.2f} s over a "
        f"{6 * window / 1e12:.1f}T-key window")

    eng64 = BSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], *PUZZLE64_RANGE, params, device=dev,
                       **shared)
    px, py = bm.warm_chunk(eng64)
    prof = None
    if cfg.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    chunks, elapsed, idle = bm.chunk_window(eng64, px, py, cfg.seconds)
    if prof is not None:
        prof.stop()
        os.makedirs(cfg.profile, exist_ok=True)
        path = os.path.join(cfg.profile, "bench_trace.json")
        prof.export_chrome_trace(path)
        log(f"[bench] profiler trace written to {path}")
    value = bm.range_keys_per_sec(chunks, eng64.p.steps_per_chunk, cfg.block_u, eng64.stride,
                                  elapsed)
    result.update(value=value, vs_baseline=value / BASELINE_KEYS_PER_SEC,
                  device_idle_share=idle, chunks=chunks, seconds=elapsed)
    log(f"[bench] throughput: {chunks} chunks in {elapsed:.2f} s -> {value:.4e} keys/s "
        f"(m={cfg.m}, U={cfg.block_u}, K={eng64.p.steps_per_chunk}, idle share {idle})")
    emit()
    return shared


def main(argv=None, env=None) -> int:
    """Run the bench; returns the exit code (0, 1 failed, 2 refused)."""
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the engines run (default BENCH_DEVICE, else cuda)")
    args = ap.parse_args(argv)
    reason = refusal(env)
    if reason:
        log(f"[bench] refused: {reason}")
        return 2
    cfg = BenchConfig.from_env(env, args.device)
    dev = torch.device(cfg.device)
    result = {"metric": "bsgs_keys_per_sec_chip", "value": None, "unit": "keys/s",
              "vs_baseline": None, "modes": {}, "gate": None, "device": None, "m": cfg.m,
              "resolve": cfg.resolve, "device_idle_share": None, "chunks": None,
              "seconds": None, "setup_s": {}, "launches": {}}

    def emit():
        result["launches"] = _build.launch_counts()
        print(json.dumps(result), flush=True)

    try:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                               "(--device cpu runs the CPU check)")
        result["device"] = device_info(dev)
        log(f"[bench] m=2^{cfg.m.bit_length() - 1} on {result['device']}, resolve {cfg.resolve}")
        shared = headline(cfg, dev, result, emit)
    except Exception as e:  # the line says what failed; no rate without the gate
        traceback.print_exc()
        result["error"] = f"{type(e).__name__}: {e}"
        emit()
        return 1
    if not cfg.modes:
        return 0
    try:
        result["modes"]["bsgs_t16"] = bm.bench_bsgs_multitarget(
            cfg.params(), seconds=cfg.mode_seconds, device=dev, **shared)
        emit()
        for name, res in bm.iter_all(seconds=cfg.mode_seconds, device=dev):
            result["modes"][name] = res
            emit()
    except Exception as e:  # a failed section is recorded, never hidden
        traceback.print_exc()
        result["modes"]["error"] = f"{type(e).__name__}: {e}"
        emit()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
