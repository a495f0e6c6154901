"""Command-line interface of the port (BSGS host-resolve, sequential order).

    python -m keyhuntm1cpu_tpu_torch.cli -m bsgs -f targets.pub \
        -r A:B | -b BITS [--m-babies N | -k K -n N] [-u U] [--chunk-steps K] \
        [--all] [-q] [--max-seconds S] [--device cuda|cpu]

Target lines are compressed (66 hex) or uncompressed (130 hex) pubkeys.
Found keys are appended to KEYFOUNDKEYFOUND.txt. Exit code: 0 found,
1 not found, 2 usage or setup error.
"""

from __future__ import annotations

import argparse
import sys

from .core.log import get_logger
from .ref import ecref


def parse_range(s: str):
    if ":" not in s:
        raise argparse.ArgumentTypeError("range must be start:end (hex)")
    a, b = s.split(":", 1)
    if not a:
        raise argparse.ArgumentTypeError("range start is required")
    return int(a, 16), (int(b, 16) if b else ecref.N - 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="keyhunt-torch",
        description="secp256k1 BSGS key search on PyTorch + CUDA "
                    "(host-resolve mode)")
    p.add_argument("-m", "--mode", required=True,
                   help="search mode; this port implements bsgs only")
    p.add_argument("-f", "--file", required=True, help="pubkey target file")
    p.add_argument("-r", "--range", type=parse_range, default=None,
                   help="start:end hex key range")
    p.add_argument("-b", "--bits", type=int, default=None,
                   help="scan [2^(b-1), 2^b)")
    p.add_argument("--m-babies", type=int, default=None,
                   help="baby-table size m (overrides -n/-k)")
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="m = sqrt(N) * k")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None,
                   help="N (a perfect square; default 0x100000000000)")
    p.add_argument("-u", "--block-u", type=int, default=4096,
                   help="giant centers per device step")
    p.add_argument("--chunk-steps", type=int, default=8,
                   help="device steps per chunk")
    p.add_argument("-B", "--policy", default="sequential",
                   help="range order; this port implements sequential only")
    p.add_argument("--all", action="store_true",
                   help="keep searching after the first found key")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop at the next chunk boundary past this many seconds")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default cuda; no GPU is an error)")
    return p


def read_pubkeys(path: str):
    with open(path) as f:
        return [ecref.parse_pubkey(ln.split()[0]) for ln in f if ln.strip()]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = get_logger()
    if args.quiet:
        log.set_level("warn")
    if args.mode != "bsgs":
        log.error(f"-m {args.mode}: this port implements -m bsgs only")
        return 2
    if args.policy != "sequential":
        log.error(f"-B {args.policy}: this port implements -B sequential only")
        return 2
    if args.bits is not None:
        if args.range is not None:
            log.error("-r and -b are mutually exclusive")
            return 2
        if not 1 <= args.bits <= 256:
            log.error("-b bits must be in 1..256")
            return 2
        args.range = (max(1, 1 << (args.bits - 1)), 1 << args.bits)
    if args.range is None:
        log.error("-r start:end or -b bits is required")
        return 2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("--device cuda: no CUDA device is available")
        return 2
    from .engine.bsgs import BSGSEngine, BSGSParams, resolve_m
    from .engine.common import write_found_key

    try:
        targets = read_pubkeys(args.file)
        m = resolve_m(args.m_babies, args.n_value, args.k_factor)
        params = BSGSParams(m=m, block_u=args.block_u,
                            steps_per_chunk=args.chunk_steps)
        a, b = args.range
        eng = BSGSEngine(targets, a, b, params, device=args.device)
    except (ValueError, OSError) as e:
        log.error(str(e))
        return 2
    found = eng.search(stop_on_first=not args.all,
                       progress_every=0 if args.quiet else 16,
                       max_seconds=args.max_seconds)
    log.plus(f"{eng.stats.human()} ({eng.stats.keys_covered:.3e} keys)")
    for f in found:
        write_found_key(f)
        log.result(f"FOUND {f.private_key:064x} -> {f.target}")
    if not found:
        log.plus("no key found in range")
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
