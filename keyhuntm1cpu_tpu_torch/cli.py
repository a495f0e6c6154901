"""Command-line interface of the port: BSGS (host-resolve, sequential order),
the brute-force modes and minikeys.

    python -m keyhuntm1cpu_tpu_torch.cli -m bsgs -f targets.pub \
        -r A:B | -b BITS [--m-babies N | -k K -n N] [-u U] [--chunk-steps K] \
        [--all] [-q] [--max-seconds S] [--max-chunks N] [--device cuda|cpu]
    python -m keyhuntm1cpu_tpu_torch.cli -m address|rmd160|xpoint|eth -f targets \
        -r A:B | -b BITS [-c eth] [-l compress|uncompress|both] [-e] [-I S] \
        [-R [--seed S] [-n N]] [-t W] [-u U] [--chunk-steps K] [--all] ...
    python -m keyhuntm1cpu_tpu_torch.cli -m minikeys -f addresses \
        [-C PREFIX] [-8 ALPHABET] [-u B] [--max-chunks N] [--max-seconds S] [--all]

BSGS target lines are compressed (66 hex) or uncompressed (130 hex)
pubkeys; brute targets are addresses or hash160 hex (address, rmd160),
ETH addresses (-m eth, or -m address -c eth) or x coordinates / pubkeys
(xpoint). Brute target sets of up to 65,536 entries run the fused path (one
chain per chunk) when -u is a multiple of 128; larger sets, or any other
-u, run the walker path (-t walkers, each moving 2U+1 keys per step).
minikeys targets are addresses or hash160 hex (compressed or uncompressed
keys both match). Minikeys scans a counter, not a key range: it takes no
-r or -b; its batch is 2^22 minikeys on the card and 4096 on the CPU, or
-u when that is larger.
Found keys are appended to KEYFOUNDKEYFOUND.txt. Exit code: 0 found,
1 not found, 2 usage or setup error.
"""

from __future__ import annotations

import argparse
import sys

from .core.log import get_logger
from .ref import ecref

BRUTE_MODES = ("address", "rmd160", "xpoint", "eth")
MODES = ("bsgs",) + BRUTE_MODES + ("minikeys",)


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
        description="secp256k1 key search on PyTorch + CUDA: BSGS "
                    "(host-resolve), the brute-force modes and minikeys")
    p.add_argument("-m", "--mode", required=True,
                   help="bsgs, address, rmd160, xpoint, eth or minikeys")
    p.add_argument("-f", "--file", required=True, help="target file")
    p.add_argument("-r", "--range", type=parse_range, default=None,
                   help="start:end hex key range")
    p.add_argument("-b", "--bits", type=int, default=None,
                   help="scan [2^(b-1), 2^b)")
    p.add_argument("--m-babies", type=int, default=None,
                   help="bsgs: baby-table size m (overrides -n/-k)")
    p.add_argument("-k", "--k-factor", type=int, default=1,
                   help="bsgs: m = sqrt(N) * k")
    p.add_argument("-n", "--n-value", type=lambda s: int(s, 0), default=None,
                   help="bsgs: N (a perfect square; default 0x100000000000); "
                        "brute with -R: sequential keys per random base")
    p.add_argument("-c", "--crypto", default="btc", choices=["btc", "eth"],
                   help="eth: -m address targets ETH addresses (keccak)")
    p.add_argument("-l", "--look", default=None,
                   choices=["compress", "uncompress", "both"],
                   help="pubkey form(s) hashed by -m address/rmd160")
    p.add_argument("-e", "--endo", action="store_true",
                   help="brute: also check the GLV endomorphism keys "
                        "lambda*k and lambda^2*k (rmd160, xpoint)")
    p.add_argument("-I", "--stride", type=int, default=1,
                   help="brute: scan a, a+stride, a+2*stride, ...")
    p.add_argument("-R", "--random", action="store_true", dest="random_mode",
                   help="brute: random chunk order")
    p.add_argument("--seed", type=int, default=0, help="seed of -R")
    p.add_argument("-w", "-t", "--walkers", "--threads", type=int, default=8,
                   help="brute: walkers of the walker path, taken by target sets "
                        "past 65,536 entries (reference -t threads); the fused "
                        "path runs one chain per chunk")
    p.add_argument("-u", "--block-u", type=int, default=4096,
                   help="keys (brute) or giant centers (bsgs) per device step "
                        "(brute: a multiple of 128 for the fused path, any other "
                        "value runs the walker path); minikeys: the least batch")
    p.add_argument("--chunk-steps", type=int, default=8,
                   help="device steps per chunk")
    p.add_argument("-B", "--policy", default="sequential",
                   help="bsgs range order; this port implements sequential only")
    p.add_argument("--all", action="store_true",
                   help="keep searching after the first found key")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop at the next chunk boundary past this many seconds")
    p.add_argument("--max-chunks", type=int, default=None,
                   help="stop after N device chunks")
    p.add_argument("-v", "--vanity", action="append", default=[],
                   help="vanity prefixes: not in this port yet")
    p.add_argument("-S", "--save-table", action="store_true",
                   help="table and target caches: not in this port yet")
    p.add_argument("--sharded", nargs="?", const="range", default=None,
                   help="multi-device search: not in this port yet")
    p.add_argument("-8", "--alphabet", default=None,
                   help="minikeys: custom 58-character base58 alphabet")
    p.add_argument("-C", "--minikey-prefix", default=None,
                   help="minikeys: scan prefix, 'S' + 11 characters (default random)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default cuda; no GPU is an error)")
    return p


def read_pubkeys(path: str):
    with open(path) as f:
        return [ecref.parse_pubkey(ln.split()[0]) for ln in f if ln.strip()]


def _bsgs_engine(args):
    from .engine.bsgs import BSGSEngine, BSGSParams, resolve_m

    m = resolve_m(args.m_babies, args.n_value, args.k_factor)
    params = BSGSParams(m=m, block_u=args.block_u, steps_per_chunk=args.chunk_steps)
    a, b = args.range
    return BSGSEngine(read_pubkeys(args.file), a, b, params, device=args.device)


def _brute_engine(args, log):
    from .engine.brute import BruteEngine, BruteParams
    from .utils.targets import parse_target_file

    mode = args.mode
    if args.crypto == "eth":
        mode = "eth"
    elif mode in ("address", "rmd160"):
        mode = {"compress": mode, "uncompress": "address_u",
                "both": "rmd160_both"}[args.look or "compress"]
    kind = "eth" if mode == "eth" else args.mode
    seq_per_base = None
    if args.n_value is not None:
        # reference -n outside bsgs: with -R, N sequential keys per random
        # base; values below 1024 revert to its 2^32 default
        seq_per_base = args.n_value if args.n_value >= 1024 else 0x100000000
        if not args.random_mode:
            log.warn("-n only affects brute modes with -R (random)")
    params = BruteParams(walkers=args.walkers, block_u=args.block_u,
                         steps_per_chunk=args.chunk_steps, endo=args.endo, stride=args.stride,
                         random_mode=args.random_mode, seed=args.seed,
                         seq_per_base=seq_per_base if args.random_mode else None)
    a, b = args.range
    return BruteEngine(parse_target_file(args.file, kind), a, b, mode=mode,
                       params=params, device=args.device)


def _minikey_engine(args):
    from .engine.minikeys import MinikeyEngine, tuned_params
    from .utils.targets import parse_target_file

    default_batch = (1 << 22) if args.device == "cuda" else 4096
    params = tuned_params(batch=max(default_batch, args.block_u), device=args.device)
    return MinikeyEngine(parse_target_file(args.file, "address"),
                         prefix=args.minikey_prefix, params=params,
                         alphabet=args.alphabet, device=args.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = get_logger()
    if args.quiet:
        log.set_level("warn")
    if args.mode not in MODES:
        log.error(f"-m {args.mode}: this port implements -m {', '.join(MODES)} only")
        return 2
    minikeys = args.mode == "minikeys"
    if not minikeys and (args.alphabet is not None or args.minikey_prefix is not None):
        log.error("-8 and -C only apply to -m minikeys")
        return 2
    for flag, on in (("-v", args.vanity), ("-S", args.save_table),
                     ("--sharded", args.sharded)):
        if on:
            log.error(f"{flag}: not in this port yet")
            return 2
    if args.crypto == "eth" and args.mode != "address":
        log.error("-c eth is only valid with -m address")
        return 2
    if args.mode == "bsgs" and args.policy != "sequential":
        log.error(f"-B {args.policy}: this port implements -B sequential only")
        return 2
    if minikeys and (args.range is not None or args.bits is not None):
        log.error("-m minikeys scans minikey counters and takes no -r or -b")
        return 2
    if args.bits is not None:
        if args.range is not None:
            log.error("-r and -b are mutually exclusive")
            return 2
        if not 1 <= args.bits <= 256:
            log.error("-b bits must be in 1..256")
            return 2
        args.range = (max(1, 1 << (args.bits - 1)), 1 << args.bits)
    if args.range is None and not minikeys:
        log.error("-r start:end or -b bits is required")
        return 2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("--device cuda: no CUDA device is available")
        return 2
    from .engine.common import write_found_key

    try:
        if minikeys:
            eng = _minikey_engine(args)
        elif args.mode == "bsgs":
            eng = _bsgs_engine(args)
        else:
            eng = _brute_engine(args, log)
    except (ValueError, OSError) as e:
        log.error(str(e))
        return 2
    progress = 0 if args.quiet else 16
    if minikeys:
        found = eng.search(max_chunks=args.max_chunks or (1 << 30), stop_on_first=not args.all,
                           progress_every=progress, max_seconds=args.max_seconds)
    else:
        max_steps = None if args.max_chunks is None else args.max_chunks * args.chunk_steps
        found = eng.search(max_steps=max_steps, stop_on_first=not args.all,
                           progress_every=progress, max_seconds=args.max_seconds)
    log.plus(f"{eng.stats.human()} ({eng.stats.keys_covered:.3e} keys)")
    for f in found:
        write_found_key(f)
        log.result(f"FOUND {f.private_key:064x} -> {f.target}")
    if not found:
        log.plus("no key found in range")
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
