"""Command-line interface of the port: BSGS (device- and host-resolve),
the brute-force modes, vanity prefixes and minikeys, on one device or
sharded over several; every flag of keyhuntm1cpu_tpu/cli.py but the
TPU-only --probe-mode, which is refused with its reason.

    python -m keyhuntm1cpu_tpu_torch.cli -m bsgs -f targets.pub \
        -r A:B | -b BITS [--m-babies N | -k K -n N] [-z MULT] [-u U] [--chunk-steps K] \
        [--resolve device|host [--host-table-cache DIR]] [--cascade2 auto|on|off] \
        [-S [--table-file F] [-6]] \
        [-B sequential|backward|both|random|dance [--seed S]] \
        [--sharded [range|table] [--table-comm all_gather|ring] [--n-devices D]] \
        [--all] [-q] [--max-seconds S] [--max-chunks N] [--device cuda|cpu]
    python -m keyhuntm1cpu_tpu_torch.cli -m address|rmd160|xpoint|eth -f targets \
        -r A:B | -b BITS [-c eth] [-l compress|uncompress|both | --uncompressed] [-e] \
        [-I S] [-R [--seed S] [-n N]] [-t W] [-u U] [--chunk-steps K] [-v PREFIX] [-S] ...
    python -m keyhuntm1cpu_tpu_torch.cli -m vanity -v PREFIX [-v ...] | -f prefixes \
        [-r A:B | -b BITS] [-l compress|uncompress|both] [-e] [-u U] [--chunk-steps K]
    python -m keyhuntm1cpu_tpu_torch.cli -m minikeys -f addresses \
        [-C PREFIX] [-8 ALPHABET] [-u B] [--max-chunks N] [--max-seconds S] [--all]

Every mode takes --config FILE (JSON, core/config.py: the file and
KEYHUNT_* variables give defaults, flags set on the command line win),
--checkpoint FILE (resume if it exists), --checkpoint-every SECONDS,
--metrics-port P (/metrics.json, /metrics, /healthz and / on 127.0.0.1:
the counters, the spans' counts and seconds, and the record of the last
search call), --trace-out FILE (a Chrome-trace timeline of the search
loops' spans and each chunk's card interval, written at exit; the
KEYHUNT_TRACE_OUT variable does the same for any entry point),
--notify-cmd CMD (run once a found key with its hex and target appended),
-s N (progress every N chunks; 0 none), -d (debug lines), -M (no
rewritten lines) and -E (accepted and ignored, as by the reference). The
first SIGTERM or SIGINT stops the search at its next chunk boundary and
saves the checkpoint; a second one exits at once.

BSGS target lines are compressed (66 hex) or uncompressed (130 hex)
pubkeys. BSGS resolves on the card by default: the baby table is built
there (or, with -S, loaded from --table-file, default
keyhunt_tpu_baby_<m>.npz, and saved there after a build; files of either
package load); --resolve host keeps only the two filters on the card and
the exact table on the host (its own disk cache, --host-table-cache; -S is
ignored there). -z MULT enlarges the BSGS bitmap by ceil(log2 MULT) bits.
Brute targets are addresses or hash160 hex (address, rmd160),
ETH addresses (-m eth, or -m address -c eth) or x coordinates / pubkeys
(xpoint); they parse through the npz cache data_<sha8>_<kind>.npz beside
the file, or from a reference data_<8hex>.dat in the cwd, which -S writes
in address and rmd160 modes. Brute target sets of up to 65,536 entries
run the fused path (one chain per chunk) when -u is a multiple of 128;
larger sets, or any other -u, run the walker path (-t walkers, each
moving 2U+1 keys per step).
--sharded (device-resolve BSGS and the fused brute path) runs one shard
a device over --n-devices devices, every visible card by default, round
robin over the cards when more (one CPU shard with --device cpu unless
--n-devices is given): "range" gives each shard a slice of the range,
"table" (bsgs) gives each shard 1/D of the baby table and its filters, the
shards' queries probed all at once (--table-comm all_gather) or one
shard's a hop (ring). The sharded engines scan in order (no -B, no -R).
Vanity prefixes (-m vanity, or -v beside -m address|rmd160) run the fused
path only; -m vanity scans [1, 2^63) unless -r or -b is given, and on the
card with -u at least 4096 and --chunk-steps at least 32.
minikeys targets are addresses or hash160 hex (compressed or uncompressed
keys both match). Minikeys scans a counter, not a key range: it takes no
-r or -b; its batch is 2^22 minikeys on the card and 4096 on the CPU, or
-u when that is larger.
Found keys are appended to KEYFOUNDKEYFOUND.txt. Exit code: 0 found,
1 not found, 2 usage or setup error.
"""

from __future__ import annotations

import argparse
import os
import sys

from .core.log import get_logger
from .ref import ecref

BRUTE_MODES = ("address", "rmd160", "xpoint", "eth")
MODES = ("bsgs",) + BRUTE_MODES + ("vanity", "minikeys")
POLICIES = ("sequential", "backward", "both", "random", "dance")
LOOK_MODES = {"compress": "rmd160", "uncompress": "address_u", "both": "rmd160_both"}
# flags of the JAX CLI that this port refuses, and why
TPU_ONLY = ("probe_mode",)
# (attribute, Config field) pairs a --config file may default: the JAX CLI's
CONFIG_FIELDS = (
    ("m_babies", "m_babies"), ("block_u", "block_u"),
    ("chunk_steps", "steps_per_chunk"), ("walkers", "walkers"),
    ("stride", "stride"), ("policy", "bsgs_policy"),
    ("seed", "seed"), ("checkpoint", "checkpoint_file"),
    ("metrics_port", "metrics_port"), ("quiet", "quiet"),
    ("k_factor", "k_factor"), ("n_value", "n_value"),
    ("filter_mult", "filter_mult"), ("crypto", "crypto"),
    ("alphabet", "minikey_alphabet"), ("cascade2", "cascade2"),
    ("table_comm", "table_comm"), ("n_devices", "n_devices"),
)


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
        description="secp256k1 key search on PyTorch + CUDA: BSGS, the "
                    "brute-force modes, vanity and minikeys")
    p.add_argument("--config", default=None,
                   help="JSON config file (core/config.py): the file and KEYHUNT_* "
                        "variables give defaults, flags set here win")
    p.add_argument("-m", "--mode", required=True,
                   help="bsgs, address, rmd160, xpoint, eth, vanity or minikeys")
    p.add_argument("-f", "--file", default=None,
                   help="target file (-m vanity: prefixes, one a line)")
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
    p.add_argument("-8", "--alphabet", default=None,
                   help="minikeys: custom 58-character base58 alphabet")
    p.add_argument("-z", "--filter-mult", type=int, default=1,
                   help="bsgs: bitmap size multiplier >= 1 (ceil(log2) more bits, at "
                        "most 2^35); brute modes compare exactly and ignore it")
    p.add_argument("-u", "--block-u", type=int, default=4096,
                   help="keys (brute) or giant centers (bsgs) per device step "
                        "(brute: a multiple of 128 for the fused path, any other "
                        "value runs the walker path); minikeys: the least batch")
    p.add_argument("--chunk-steps", type=int, default=8,
                   help="device steps per chunk")
    p.add_argument("-B", "--policy", default="sequential",
                   help="bsgs range order: " + ", ".join(POLICIES))
    p.add_argument("--seed", type=int, default=0, help="seed of -R and -B")
    p.add_argument("-w", "-t", "--walkers", "--threads", type=int, default=8,
                   help="brute: walkers of the walker path, taken by target sets "
                        "past 65,536 entries (reference -t threads); the fused "
                        "path runs one chain per chunk")
    p.add_argument("-I", "--stride", type=int, default=1,
                   help="brute: scan a, a+stride, a+2*stride, ...")
    p.add_argument("-E", dest="_e_compat", default=None,
                   help="accepted for reference-argv compatibility and ignored")
    p.add_argument("-R", "--random", action="store_true", dest="random_mode",
                   help="brute: random chunk order")
    p.add_argument("-e", "--endo", action="store_true",
                   help="brute: also check the GLV endomorphism keys "
                        "lambda*k and lambda^2*k (rmd160, xpoint)")
    p.add_argument("-S", "--save-table", action="store_true",
                   help="bsgs device resolve: load the baby table from --table-file, "
                        "or build it and save it there; address and rmd160: write "
                        "the reference target cache data_<8hex>.dat in the cwd")
    p.add_argument("--table-file", default=None,
                   help="baby table file (default keyhunt_tpu_baby_<m>.npz)")
    p.add_argument("--probe-mode", default=None,
                   help="TPU-only (the bitmap-gather strategy): refused here")
    p.add_argument("--cascade2", default="auto", choices=["auto", "on", "off"],
                   help="bsgs device resolve: the level-2 bloom between the bitmap "
                        "and the exact search (auto: when the bitmap's survivors "
                        "outgrow the search width)")
    p.add_argument("--resolve", default="device", choices=["device", "host"],
                   help="bsgs: exact resolution on the card (the sorted baby table) "
                        "or on the host (the card keeps the two filters only)")
    p.add_argument("--host-table-cache", default=None,
                   help="bsgs --resolve host: the host table's cache dir (default "
                        ".table_cache/)")
    p.add_argument("-6", "--skip-checksum", action="store_true", dest="skip_checksum",
                   help="skip the table file's checksum")
    p.add_argument("--checkpoint", default=None,
                   help="search-position checkpoint file (resume if it exists)")
    p.add_argument("--checkpoint-every", type=float, default=60.0,
                   help="seconds between checkpoint writes")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics.json, /metrics, /healthz and / on this port "
                        "(0: a free one)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome-trace timeline of the search loops' spans and "
                        "the card's chunk intervals to FILE at exit (as KEYHUNT_TRACE_OUT)")
    p.add_argument("--sharded", nargs="?", const="range", default=None,
                   choices=["range", "table"],
                   help="multi-device search: 'range' (default) gives each device a "
                        "slice of the range; 'table' (bsgs) shards the baby table 1/D "
                        "per device, so m scales past one card's memory")
    p.add_argument("--table-comm", default="all_gather", choices=["all_gather", "ring"],
                   help="--sharded table membership schedule: every device probes all "
                        "devices' queries at once, or one device's block a hop for D hops")
    p.add_argument("--n-devices", type=int, default=None,
                   help="--sharded: the number of shards, round robin over the visible "
                        "cards (default every visible card; 1 with --device cpu)")
    p.add_argument("-s", "--stats-every", type=float, default=5.0,
                   help="progress line every N chunks; 0 omits it")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-d", "--debug", action="store_true", help="debug-level logging")
    p.add_argument("-M", "--matrix", action="store_true",
                   help="matrix mode: never rewrite a line")
    p.add_argument("--all", action="store_true",
                   help="keep searching after the first found key")
    p.add_argument("-l", "--look", default=None,
                   choices=["compress", "uncompress", "both"],
                   help="pubkey form(s) hashed by -m address/rmd160")
    p.add_argument("--uncompressed", action="store_true",
                   help="alias for -l uncompress")
    p.add_argument("-v", "--vanity", action="append", default=[],
                   help="vanity prefix (repeatable): -m vanity, or beside "
                        "-m address|rmd160")
    p.add_argument("-C", "--minikey-prefix", default=None,
                   help="minikeys: scan prefix, 'S' + 11 characters (default random)")
    p.add_argument("--max-chunks", type=int, default=None,
                   help="stop after N device chunks")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop at the next chunk boundary past this many seconds")
    p.add_argument("--notify-cmd", default=None,
                   help="command run once a found key, with the key hex and the "
                        "target appended as arguments")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default cuda; no GPU is an error)")
    return p


def apply_config(args, log) -> None:
    """--config: the file and KEYHUNT_* env give defaults; a flag set on
    the command line (a value other than the parser's default) wins; the
    file's sharded = true means --sharded range. The TPU-only probe_mode
    is warned about and ignored."""
    from .core.config import Config, load_config

    cfg = load_config(args.config)
    defaults = build_parser().parse_args(
        ["-m", args.mode, *(["-f", args.file] if args.file else [])])
    for attr, key in CONFIG_FIELDS:
        if getattr(args, attr) == getattr(defaults, attr):
            v = getattr(cfg, key)
            if v is not None:
                setattr(args, attr, v)
    if cfg.sharded and args.sharded is None:
        args.sharded = "range"
    if cfg.probe_mode != Config().probe_mode:
        log.warn(f"config probe_mode={cfg.probe_mode!r} is TPU-only; ignored by this port")


def read_pubkeys(path: str):
    with open(path) as f:
        return [ecref.parse_pubkey(ln.split()[0]) for ln in f if ln.strip()]


def _devices(args):
    """The shards' devices of a --sharded run."""
    from .parallel.mesh import default_devices

    return default_devices(args.device, args.n_devices)


def _bsgs_engine(args, log):
    from .engine.bsgs import BSGSEngine, BSGSParams, resolve_m
    from .filter.bitmap import scaled_bits_log2

    m = resolve_m(args.m_babies, args.n_value, args.k_factor)
    params = BSGSParams(m=m, block_u=args.block_u, steps_per_chunk=args.chunk_steps,
                        bits_log2=scaled_bits_log2(m, args.filter_mult),
                        cascade2=args.cascade2, resolve=args.resolve,
                        table_cache=args.host_table_cache, table_comm=args.table_comm)
    a, b = args.range
    pubkeys = read_pubkeys(args.file)
    devs = _devices(args) if args.sharded else None
    table, path = None, args.table_file or f"keyhunt_tpu_baby_{m}.npz"
    if args.save_table and args.resolve == "host":
        log.warn("--resolve host caches its table on disk itself; -S/--table-file ignored")
    elif args.save_table:
        try:
            table = BSGSEngine.load_table(path, verify_checksum=not args.skip_checksum,
                                          device=devs[0] if devs else args.device)
        except FileNotFoundError:
            pass
        except ValueError as e:
            log.warn(f"{path}: {e}; building the table anew")
        if table is not None and table.key.shape != (m,):
            log.warn(f"{path} holds {table.key.shape[0]} keys, not m={m}; building anew")
            table = None
        if table is not None:
            log.plus(f"loaded baby table from {path}")
    if args.sharded:
        from .parallel import ShardedBSGSEngine, ShardedTableBSGSEngine

        cls = ShardedTableBSGSEngine if args.sharded == "table" else ShardedBSGSEngine
        eng = cls(pubkeys, a, b, params, table=table, devices=devs)
    else:
        eng = BSGSEngine(pubkeys, a, b, params, device=args.device, table=table)
    if args.save_table and args.resolve == "device" and table is None:
        eng.save_table(path)
        log.plus(f"saved baby table to {path}")
    if args.sharded == "table":
        log.plus(f"bsgs: m={m}, table sharded over {eng.n_shards} devices ({eng.rows} rows "
                 f"each, {args.table_comm}), bitmaps 2^{eng.shard_bits} bits")
    else:
        log.plus(f"bsgs: m={m}, {args.resolve} resolve, bitmap 2^{eng.bitmap.bits_log2} bits"
                 + (f", range sharded over {eng.n_shards} devices" if args.sharded else ""))
    return eng


def _brute_engine(args, log):
    from .engine.brute import BruteParams
    from .utils.targets import parse_target_file_cached

    mode = args.mode
    if args.crypto == "eth":
        mode = "eth"
    elif mode in ("address", "rmd160"):
        mode = LOOK_MODES[_look(args)]
    kind = "eth" if mode == "eth" else args.mode
    targets = parse_target_file_cached(args.file, kind)
    if args.save_table and targets.kind == "hash160":
        # reference -S in address mode: write the data_<8-hex>.dat a
        # reference build loads, unless one exists
        from .utils.legacy import dat_cache_path
        from .utils.targets import write_reference_dat

        if not os.path.exists(dat_cache_path(args.file)):
            log.plus(f"wrote {write_reference_dat(args.file, targets)}")
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
    intervals = []
    if args.vanity and args.mode in ("address", "rmd160") and args.crypto != "eth":
        # -v beside address mode: the same scan also flags the hash160s
        # inside the vanity intervals
        intervals = _intervals(args.vanity)
    a, b = args.range
    return _brute_or_sharded(args, targets, a, b, mode, params, intervals,
                             list(args.vanity) if intervals else [])


def _brute_or_sharded(args, targets, a, b, mode, params, intervals, prefixes):
    from .engine.brute import BruteEngine

    if args.sharded:
        from .parallel import ShardedBruteEngine

        return ShardedBruteEngine(targets, a, b, mode=mode, params=params,
                                  devices=_devices(args), intervals=intervals,
                                  prefixes=prefixes)
    return BruteEngine(targets, a, b, mode=mode, params=params, device=args.device,
                       intervals=intervals, prefixes=prefixes)


def _look(args) -> str:
    return args.look or ("uncompress" if args.uncompressed else "compress")


def _intervals(prefixes):
    from .engine.vanity import vanity_intervals

    return [iv for pref in prefixes for iv in vanity_intervals(pref)]


def _vanity_engine(args):
    """-m vanity: the fused brute path with an interval-only target set,
    at least U = 4096 and K = 32 on the card (the JAX CLI's floors)."""
    from .engine.brute import BruteParams
    from .utils.targets import TargetSet

    prefixes = list(args.vanity)
    if args.file:
        with open(args.file) as f:
            prefixes += [ln.strip() for ln in f if ln.strip()]
    if not prefixes:
        raise ValueError("vanity mode needs -v prefixes or a -f prefix file")
    card = args.device == "cuda"
    params = BruteParams(block_u=max(4096, args.block_u) if card else args.block_u,
                         steps_per_chunk=max(32, args.chunk_steps) if card else args.chunk_steps,
                         endo=args.endo)
    a, b = args.range or (1, 1 << 63)
    return _brute_or_sharded(args, TargetSet(kind="hash160", raw=[], labels=[]), a, b,
                             LOOK_MODES[_look(args)], params, _intervals(prefixes), prefixes)


def _minikey_engine(args):
    from .engine.minikeys import MinikeyEngine, tuned_params
    from .utils.targets import parse_target_file

    default_batch = (1 << 22) if args.device == "cuda" else 4096
    params = tuned_params(batch=max(default_batch, args.block_u), device=args.device)
    return MinikeyEngine(parse_target_file(args.file, "address"),
                         prefix=args.minikey_prefix, params=params,
                         alphabet=args.alphabet, device=args.device)


def _notify(cmd: str, f, log) -> None:
    """Run the --notify-cmd for one found key; a failure is a warning
    (the key is already in KEYFOUNDKEYFOUND.txt)."""
    import subprocess

    try:
        subprocess.run([*cmd.split(), f"{f.private_key:064x}", f.target], timeout=30,
                       check=False)
    except Exception as e:  # a notification failure never loses the key
        log.warn(f"notify command failed: {e}")


def _refusal(args):
    """The reason this run is refused before anything starts, or None."""
    minikeys, vanity = args.mode == "minikeys", args.mode == "vanity"
    if args.mode not in MODES:
        return f"-m {args.mode}: this port implements -m {', '.join(MODES)} only"
    for attr in TPU_ONLY:
        if getattr(args, attr) is not None:
            return (f"--{attr.replace('_', '-')} is TPU-only (the JAX package's Pallas "
                    "kernels); the CUDA kernels have one form")
    if args.sharded and minikeys:
        return "--sharded applies to bsgs and the brute modes, not to -m minikeys"
    if args.sharded == "table" and args.mode != "bsgs":
        return ("--sharded table applies to bsgs only (brute modes have no baby table); "
                "use --sharded")
    if args.sharded and args.mode == "bsgs" and args.resolve == "host":
        return ("--resolve host applies to the single-device engine (sharded engines "
                "keep per-device tables)")
    if args.n_devices is not None and args.n_devices < 1:
        return "--n-devices must be >= 1"
    if not minikeys and (args.alphabet is not None or args.minikey_prefix is not None):
        return "-8 and -C only apply to -m minikeys"
    if args.policy not in POLICIES:
        return f"-B {args.policy}: the range orders are {', '.join(POLICIES)}"
    if args.crypto == "eth" and args.mode != "address":
        return "-c eth is only valid with -m address"
    if minikeys and (args.range is not None or args.bits is not None):
        return "-m minikeys scans minikey counters and takes no -r or -b"
    if args.bits is not None:
        if args.range is not None:
            return "-r and -b are mutually exclusive"
        if not 1 <= args.bits <= 256:
            return "-b bits must be in 1..256"
    if args.range is None and args.bits is None and not (minikeys or vanity):
        return "-r start:end or -b bits is required"
    if args.file is None and not vanity:
        return "-f target file is required for this mode"
    if args.filter_mult < 1:
        return "-z must be >= 1"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = get_logger()
    from .core.errors import KeyhuntError

    try:
        if args.config:
            apply_config(args, log)
        return _run(args, log)
    except (ValueError, OSError, KeyhuntError) as e:
        log.error(str(e))
        return 2


def _run(args, log) -> int:
    if args.quiet:
        log.set_level("warn")
    elif args.debug:
        log.set_level("debug")
    log.matrix = args.matrix
    reason = _refusal(args)
    if reason:
        log.error(reason)
        return 2
    if args.bits is not None:
        args.range = (max(1, 1 << (args.bits - 1)), 1 << args.bits)
    if args.k_factor < 1:
        args.k_factor = 1  # the reference clamps KFACTOR <= 0 to 1
    if args.filter_mult > 1 and args.mode != "bsgs":
        log.plus("-z noted: brute-mode membership is an exact compare (no "
                 "false-positive filter to enlarge)")
    if args.table_comm != "all_gather" and args.sharded != "table":
        log.warn("--table-comm applies only to --sharded table (the schedule of the "
                 "table shards' membership traffic); this run does not use it")
    if args.sharded and args.mode == "bsgs" and args.policy != "sequential":
        log.warn(f"the sharded engines scan their slices in order; -B {args.policy} ignored")
    if args.save_table and args.mode not in ("bsgs", "address", "rmd160"):
        log.warn("-S applies to -m bsgs (the baby table) and -m address|rmd160 "
                 "(the reference .dat); ignored")
    log.debug(f"arguments: {vars(args)}")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("--device cuda: no CUDA device is available")
        return 2
    from .core.checkpoint import CheckpointManager
    from .engine.common import install_stop_handlers, write_found_key

    install_stop_handlers(log)
    ckmgr = (CheckpointManager(args.checkpoint, every_s=args.checkpoint_every)
             if args.checkpoint else None)
    # reference -s 0 omits the stats output entirely
    progress = 0 if (args.quiet or args.stats_every == 0) else max(1, int(args.stats_every))
    from .core import metrics

    metrics.trace_to(args.trace_out)
    metrics_srv = None
    if args.metrics_port is not None:
        from .core.metrics import MetricsServer, get_metrics

        get_metrics().set_info("mode", args.mode)
        metrics_srv = MetricsServer(args.metrics_port).start()
        log.plus(f"metrics on http://127.0.0.1:{metrics_srv.port}/")
    try:
        if args.mode == "minikeys":
            eng = _minikey_engine(args)
            found = eng.search(max_chunks=args.max_chunks or (1 << 30),
                               stop_on_first=not args.all, progress_every=progress,
                               checkpoint=ckmgr, max_seconds=args.max_seconds)
        elif args.mode == "bsgs" and not args.sharded:
            eng = _bsgs_engine(args, log)
            found = eng.search_scheduled(policy=args.policy, seed=args.seed,
                                         max_chunks=args.max_chunks,
                                         stop_on_first=not args.all,
                                         progress_every=progress, checkpoint=ckmgr,
                                         max_seconds=args.max_seconds)
        else:
            if args.mode == "bsgs":
                eng = _bsgs_engine(args, log)
            else:
                eng = _vanity_engine(args) if args.mode == "vanity" else _brute_engine(args, log)
            # --max-chunks counts chunks; the brute and sharded engines count
            # device steps
            max_steps = (None if args.max_chunks is None
                         else args.max_chunks * eng.p.steps_per_chunk)
            search = eng.search_sharded if args.sharded else eng.search
            found = search(max_steps=max_steps, stop_on_first=not args.all,
                           progress_every=progress, checkpoint=ckmgr,
                           max_seconds=args.max_seconds)
        log.plus(f"{eng.stats.human()} ({eng.stats.keys_covered} keys)")
        for f in found:
            write_found_key(f)
            log.result(f"FOUND {f.private_key:064x} -> {f.target}")
            if args.notify_cmd:
                _notify(args.notify_cmd, f, log)
        if not found:
            log.plus("no key found in range")
    finally:
        if metrics_srv is not None:
            metrics_srv.stop()
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
