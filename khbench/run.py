"""Run one cell of the benchmark once.

    python3 khbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Set-up (imports, the kernel build or its
cache, the table and filters, the engine, a warm-up over every shape) is
timed from the process's start; the window is one call into the engine's
search; then the reference checks what the window produced. The last line
on standard output is one JSON object: correct, attempted, failed, the
metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer metrics, with busy and window seconds and a breakdown), the
device, and last the numbers compared beside their limits, which also
close standard error. No result, and a non-zero exit, without the cards
the cell asks for, for a layout refused in set-up (khbench/runners/), or
where jax or the JAX package was loaded.

--fault NAME breaks the timed path on purpose (khbench/faults.py): the
control and the faults the checks must catch. The benchmark never sets it.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = (time.time(), time.perf_counter())
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT  # run as a script: import the package, not its files
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "keyhuntm1cpu_tpu")


def process_start() -> float:
    """The process's start, epoch seconds (Linux /proc; else this module's
    first statement)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _T0[0]


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is jax's, jaxlib's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def smi(query: str) -> str:
    """The first card's nvidia-smi reading, or "" without one."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


class NoChip(Exception):
    pass


def reader(metric: str) -> str:
    """The module under khbench/metrics/ that reads a metric: its name up
    to the first dot."""
    return metric.split(".", 1)[0]


def run_cell(bench: str, workload: str, seed: int, seconds: float, trace: bool,
             fault=None, device: str = "cuda") -> dict:
    """One run; the result object (with "checks" last). device "cpu" skips
    the look for cards and runs every chip as a CPU device (the tests)."""
    from khbench import generator, spec
    from khbench.runners.common import Ctx

    cell = spec.load(bench, workload)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoChip(f"{workload} needs {cell.chips} CUDA device(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                         "available")
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    else:
        devices = [torch.device(device)] * cell.chips
    cfg = cell.config
    if cfg.get("devices", 1) != cell.chips:
        raise ValueError(f"{workload}: configuration is for {cfg.get('devices', 1)} chips, "
                         f"the cell asks for {cell.chips}")
    ctx = Ctx(cfg=cfg, inputs=generator.generate(cell.mix, cfg, seed), seed=seed,
              seconds=seconds, trace=trace, devices=devices, fault=fault,
              card_clock=not trace and any(m["source"] == "device_trace"
                                           for m in cell.end_to_end))
    runner = importlib.import_module(f"khbench.runners.{cfg['engine']}")
    ctx.mark("imports")
    try:
        out = runner.run(ctx)
    finally:
        for undo in reversed(ctx.undo):
            undo()
    t_proc = process_start()
    # the system's set-up: the card clock's start is the harness's own
    clock_s = ctx.card.readings.get("card_clock_start_s", 0.0) if ctx.card is not None else 0.0
    setup_s = (ctx.marks["window"] - _T0[1]) + (_T0[0] - t_proc) - clock_s
    card_busy_s = ctx.card.busy_s() if ctx.card is not None else None
    r = dict(keys=out.keys, wall_s=out.wall_s, setup_s=setup_s, n_devices=len(devices),
             card_busy_s=card_busy_s, **out.readings)
    if trace and devices[0].type == "cuda":
        clock = smi("clocks.max.sm")
        r["clock_mhz"] = float(clock.split()[0]) if clock else None
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        # a metric split by cells ("name.part") shares the reader of its head
        v = importlib.import_module(f"khbench.metrics.{reader(m['name'])}").read(r)
        if v is None and not trace and (m["source"] != "device_trace"
                                        or devices[0].type == "cuda"):
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if set(out.checks) != set(cell.limits):
        raise RuntimeError(f"checks {sorted(out.checks)} do not match the cell's limits "
                           f"{sorted(cell.limits)}")
    checks = {k: {"value": out.checks[k], "limit": cell.limits[k]} for k in sorted(out.checks)}
    dev = {"platform": "gpu" if devices[0].type == "cuda" else devices[0].type,
           "kind": torch.cuda.get_device_name(0) if devices[0].type == "cuda" else "cpu",
           "count": len(devices), "memory_peak_bytes": out.memory_peak_bytes}
    tr = r.get("trace")
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": dev}
    if trace and tr:
        cards = list(tr["cards"].values())
        dev["busy_s"] = sum(c["busy_s"] for c in cards) / len(cards) if cards else 0.0
        dev["window_s"] = tr["window_s"]
        if devices[0].type == "cuda":
            dev["power_limit"] = smi("power.limit")
            dev["clocks_max_sm_mhz"] = r.get("clock_mhz")
        ops = sorted(tr["kernel_ms"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(tr["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v / 1e3] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in gaps]}
    diag = {k: v for k, v in out.readings.items() if k not in ("trace", "shape")}
    if ctx.card is not None and ctx.card.readings:
        diag.update(ctx.card.readings, card_busy_s=card_busy_s, wall_s=out.wall_s)
    # set-up by stage: seconds from the process's start to the end of each
    diag["setup_marks_s"] = {k: v - _T0[1] + (_T0[0] - t_proc) for k, v in ctx.marks.items()}
    if tr:
        pairs = tr["sampled_pair_ms"]
        diag["sampled_chunk_pair_ms"] = sum(pairs) / len(pairs) if pairs else None
        diag["kernel_launches"] = tr["kernel_launches"]
    result["diag"] = diag
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from khbench.runners.common import Refused

    try:
        result = run_cell(os.path.join(os.getcwd(), "BENCHMARK.json"), args.workload, args.seed, args.seconds,
                          bool(args.trace), args.fault)
    except NoChip as e:
        print(f"khbench: {e}", file=sys.stderr)
        return 2
    except Refused as e:
        import torch

        peak = max((torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())),
                   default=0) if torch.cuda.is_available() else 0
        print(f"khbench: refused in set-up, {time.time() - process_start():.1f} s after the "
              f"process's start (card memory peak {peak} B): {e}", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"khbench: loaded {', '.join(bad)}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(f"khbench: readings {json.dumps(result.pop('diag'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
