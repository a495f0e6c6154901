"""The least-work model of a kernel: the benchmark's frozen yardstick.

A copy of the bound model of ``chip_smoke.py`` as it stood when the
benchmark was defined; the smoke test may change, this copy may not. The
kernels do 32-bit integer work. An H100 (compute capability 9.0) issues 64
32-bit integer add, multiply(-add), shift, compare or logic instructions a
clock an SM (CUDA C++ Programming Guide, arithmetic instruction
throughput), on 132 SMs at the clock nvidia-smi reports as
clocks.max.sm; HBM3 moves 3.35 TB/s. The instruction counts are those the
function needs at least, whatever the kernel's grouping (the walk's
inversion is one a launch), low where in doubt so that the bound stays a
bound. A kernel's roofline share is its bound over its measured time.
"""

from __future__ import annotations

INT32_PER_CLK_SM, N_SM, HBM_BYTES_PER_S = 64, 132, 3.35e12
MUL_OPS = 160  # fe_mul: 64 wide multiply-adds, 64 carry adds, 32 for the fold
SQR_OPS = 120  # a squaring: 36 wide multiply-adds, 36 carry adds, 16 to double, the fold
SUB_OPS = 16  # fe_sub / fe_add: 8 subtracts with borrow + the conditional p
# a^-1 by safegcd: 20 batches of 30 divsteps (~12 logic operations each)
# and the batch's matrix applied to d, e, f, g (~150)
INV_OPS = 20 * (30 * 12 + 150)
SHA_OPS = 64 * 14 + 48 * 10  # rounds + schedule
RMD_OPS = 160 * 5 + 20  # 2 lines x 80 steps at 5 a step, and the output
KECCAK_OPS = 24 * 190  # theta 90, rho 48, chi 50, iota 2 (32-bit halves)
HASH_OPS = {"hash160": SHA_OPS + RMD_OPS + 25, "hash160_u": 2 * SHA_OPS + RMD_OPS + 40,
            "keccak": KECCAK_OPS + 16}
MODE_HASHES = {"xpoint": [], "rmd160": ["hash160"] * 2, "eth": ["keccak"],
               "address_u": ["hash160_u"], "rmd160_both": ["hash160"] * 2 + ["hash160_u"]}


def walk_point_ops(points: int) -> float:
    """The affine walk's least work a point, with all `points` of a launch
    in one Montgomery batch: dx (with its zero test), dy, the batch's three
    products, lambda, lambda^2, x3, and the batch's one inversion shared."""
    return 2 * (SUB_OPS + 4) + 4 * MUL_OPS + SQR_OPS + 3 * SUB_OPS + INV_OPS / points


def k2_ops_bytes(R: int, U: int):
    """K2 (kh_walk_blocks) over R rows of U points: the walk of R*U points;
    reads R bases and U table points, writes 9 bytes a point (two key
    words and the flag)."""
    return walk_point_ops(R * U) * R * U, 64 * (R + U) + 9 * R * U


def k4_ops(mode: str, n_endo: int, T: int, TB: int, points: int) -> float:
    """K4's instructions for `points` points: the walk, y3 where the mode
    hashes it, the GLV products, each query's hash, byte swaps and T
    interval compares (5 each) and TB bucket reads (2)."""
    per = walk_point_ops(points)
    if mode in ("eth", "address_u", "rmd160_both"):
        per += MUL_OPS + 2 * SUB_OPS
    per += (n_endo - 1) * MUL_OPS
    for h in MODE_HASHES[mode]:
        per += n_endo * (HASH_OPS[h] + 2 + 5 * T + 2 * TB)
    if mode == "xpoint":
        per += n_endo * (5 * T + 2 * TB)
    return per * points


def k4_ops_bytes(mode: str, n_endo: int, T: int, TB: int, K: int, U: int):
    """K4 (kh_brute_walk_blocks) over K bases and U table points: reads the
    bases, the table, T intervals and TB lane rows; writes a hit word a
    point."""
    return k4_ops(mode, n_endo, T, TB, K * U), 64 * (K + U) + 16 * T + 512 * TB + 4 * K * U


def bound_ms(ops: float, nbytes: float, clock_mhz: float):
    """(least milliseconds, 'operations' or 'bytes')."""
    t_ops = ops / (INT32_PER_CLK_SM * N_SM * clock_mhz * 1e6)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
