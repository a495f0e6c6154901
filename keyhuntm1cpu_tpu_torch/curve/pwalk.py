"""The BSGS giant-step walk: advance chain (K1) and walk blocks (K2).

Port of keyhuntm1cpu_tpu/curve/pwalk.py. The chunk is split the same way:

- **K1 advance chain** (``advance_chain``): the K walk bases of each
  target, P, P+ADV, ..., P+(K-1)ADV, and the next state P+K*ADV. The JAX
  kernel walks them as a serial chain of Jacobian mixed adds; here ADV is
  a constant of the engine, so they are K independent affine adds
  P + j*ADV from a table of j*ADV (``adv_multiples``, built once by the
  engine) sharing one batched inversion.
- **K2 walk blocks** (``walk_blocks``): with the bases known, the
  T*K*U additions base_r + tab[u] are independent. Each emits the low 64
  bits of x3 (qlo = limb 0, qhi = limb 1) and flags dx == 0 lanes. Given
  the level-1 bitmap, K2 also probes each key it emits and writes the
  survivor mask (32 keys a word) that the BSGS chunk's level-1 stage
  compacts (filter/bitmap.mask_compact), so the chunk needs no probe
  kernel of its own.

Every wrapper runs its plain torch version (``*_ref``) for a CPU tensor
and launches its CUDA kernel (csrc/pwalk.cu) for a CUDA tensor; each
counts its kernel launches in ``<wrapper>.launches``.

Layouts (the JAX package's, without its 128-lane tiling): field elements
are limb-major int32 tensors holding u32 bits, ``(8, n)``. The ADV table
is ``(8, K)`` with column j - 1 = j*ADV; bases are ``(8, T*K)`` with
column ``t*K + s``; qlo/qhi/deg are ``(T*K, U)``; adv_degenerate is
``(T, K)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..field import fe
from ..filter import bitmap as bmp
from ..ref import ecref

def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need a contiguous int32 tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def table_to_limb_major(tab_bm: np.ndarray, device) -> torch.Tensor:
    """(U, 8) uint32 host table -> (8, U) int32 limb-major on `device`."""
    arr = fe.to_tiles(np.asarray(tab_bm, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# K1: advance chain
# ---------------------------------------------------------------------------


def adv_multiples(adv, K: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table of K1: j*ADV for j = 1..K as affine limb-major (8, K) int32
    x and y on `device` (column j - 1), computed exactly on the host with
    ref/ecref. adv is an affine point of python ints or the (8,) int32 limb
    tensors adv_x, adv_y (then one host copy). Engines build it once."""
    ax, ay = adv
    if isinstance(ax, torch.Tensor):
        ax, ay = (fe.limbs_to_int(fe.u32(t).cpu().numpy()) for t in (ax, ay))
    if K < 1 or not ecref.is_on_curve((ax, ay)):
        raise ValueError(f"adv_multiples needs K >= 1 and a point on the curve (K={K})")
    xs, ys = np.empty((K, 8), np.uint32), np.empty((K, 8), np.uint32)
    pt = (ax, ay)
    for j in range(K):
        xs[j], ys[j] = fe.int_to_limbs(pt[0]), fe.int_to_limbs(pt[1])
        pt = ecref.point_add(pt, (ax, ay))  # never infinity: ADV's order is N > K
    return table_to_limb_major(xs, device), table_to_limb_major(ys, device)


def _tree_inv(den: torch.Tensor) -> torch.Tensor:
    """Inverses of the (8, T, n) non-zero elements along the last axis by
    one product tree per row t (K1's block_batch_inv): n padded with ones
    to a power of two, pairwise products up to the root, ONE vectorised
    inversion of the T roots, then each child's inverse is its parent's
    times its sibling."""
    n = den.shape[2]
    width = 1 << (n - 1).bit_length()
    level = torch.cat([den, fe.one_like(den[:, :, :1]).expand(8, den.shape[1], width - n)], 2)
    levels = [level]
    while level.shape[2] > 1:
        level = fe.mul(level[:, :, 0::2], level[:, :, 1::2])
        levels.append(level)
    inv = fe.inv(level)
    for below in reversed(levels[:-1]):
        left, right = below[:, :, 0::2], below[:, :, 1::2]
        inv = torch.stack([fe.mul(inv, right), fe.mul(inv, left)], dim=3).reshape(below.shape)
    return inv[:, :, :n]


def advance_chain_ref(px, py, adv_x, adv_y, K: int, adv_tab=None):
    """Plain torch version of K1 (see advance_chain): the same T*K affine
    adds P_t + j*ADV with one batched inversion per target."""
    tab_x, tab_y = adv_tab if adv_tab is not None else adv_multiples((adv_x, adv_y), K,
                                                                      px.device)
    T = px.shape[1]
    p_x = fe.u32(px)[:, :, None].expand(8, T, K)
    p_y = fe.u32(py)[:, :, None].expand(8, T, K)
    q_x = fe.u32(tab_x)[:, None, :].expand(8, T, K)
    q_y = fe.u32(tab_y)[:, None, :].expand(8, T, K)
    den = fe.sub(q_x, p_x)
    num = fe.sub(q_y, p_y)
    zero = fe.is_zero(den)
    dbl = zero & fe.eq(q_y, p_y)  # P == j*ADV: tangent slope 3x^2 / 2y
    inf = zero & ~dbl  # P == -j*ADV: flagged, inverts 1
    x2 = fe.sqr(p_x)
    num = fe.select(dbl, fe.add(fe.dbl(x2), x2), num)
    den = fe.select(dbl, fe.dbl(p_y), fe.select(inf, fe.one_like(den), den))
    lam = fe.mul(num, _tree_inv(den))
    x3 = fe.sub(fe.sub(fe.sqr(lam), p_x), q_x)  # (8, T, K): P + ADV .. P + K*ADV
    y3 = fe.sub(fe.mul(lam, fe.sub(p_x, x3)), p_y)
    # walk-base order: base_0 = P, base_s = lane s; column t*K + s
    bx = fe.i32(torch.cat([p_x[:, :, :1], x3[:, :, : K - 1]], dim=2).reshape(8, T * K))
    by = fe.i32(torch.cat([p_y[:, :, :1], y3[:, :, : K - 1]], dim=2).reshape(8, T * K))
    return bx, by, fe.i32(x3[:, :, K - 1]), fe.i32(y3[:, :, K - 1]), inf


def advance_chain(px, py, adv_x, adv_y, K: int, adv_tab=None):
    """px/py: (8, T) int32 limbs, one affine chain start per target.
    adv_x/adv_y: (8,) affine ADV; adv_tab: its table (adv_multiples(ADV,
    K)), built here when None (a host copy: for tests and one-off calls;
    the search loops pass theirs). Returns walk bases (8, T*K) x2 (column
    t*K + s = P_t + s*ADV), next state (8, T) x2 = P_t + K*ADV, and
    adv_degenerate (T, K) bool: P_t + (s+1)*ADV is the point at infinity.

    Every lane is computed from P_t and the table, so a flagged lane's x/y
    are garbage but the lanes after it are true points. The JAX chain adds
    ADV serially and carries garbage past a flag; nothing downstream reads
    those lanes (BSGS rescans every step after the first flag and rebases,
    the brute decode cuts at the flag)."""
    T = px.shape[1] if px.dim() == 2 else -1
    for name, t, shape in (("px", px, (8, T)), ("py", py, (8, T)),
                           ("adv_x", adv_x, (8,)), ("adv_y", adv_y, (8,))):
        _check(name, t, shape)
    if K < 1 or T < 1:
        raise ValueError(f"advance_chain needs K >= 1 and T >= 1 (K={K}, T={T})")
    if adv_tab is None:
        adv_tab = adv_multiples((adv_x, adv_y), K, px.device)
    for name, t in zip(("adv_tab x", "adv_tab y"), adv_tab):
        _check(name, t, (8, K))
    if not _build.on_cuda(px, py, *adv_tab):
        return advance_chain_ref(px, py, adv_x, adv_y, K, adv_tab)
    dev = px.device
    bx = torch.empty((8, T * K), dtype=torch.int32, device=dev)
    by = torch.empty_like(bx)
    nx = torch.empty((8, T), dtype=torch.int32, device=dev)
    ny = torch.empty_like(nx)
    adeg = torch.empty((T, K), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (px, py, *adv_tab, bx, by, nx, ny, adeg)]
    _build.launch("kh_advance_chain", *ptrs, T, K, _build.stream(px))
    advance_chain.launches += 1
    return bx, by, nx, ny, adeg


advance_chain.launches = 0


# ---------------------------------------------------------------------------
# K2: walk blocks
# ---------------------------------------------------------------------------


def walk_blocks_ref(bases_x, bases_y, tab_x, tab_y, bitmap=None):
    """Plain torch version of K2 (see walk_blocks). One batched inversion
    over all rows (rows chained as Montgomery groups; past 256 rows, as
    many targets give, a group holds several rows, so the serial chain
    stays at most 256 products long); with a bitmap, its probe of the keys
    as the survivor mask (bitmap.survivor_mask_ref)."""
    R = bases_x.shape[1]
    bx, by = fe.u32(bases_x)[:, :, None], fe.u32(bases_y)[:, :, None]
    tx, ty = fe.u32(tab_x)[:, None, :], fe.u32(tab_y)[:, None, :]
    dx = fe.sub(tx, bx)  # (8, R, U)
    deg = fe.is_zero(dx)
    dx = fe.select(deg, fe.one_like(dx), dx)
    inv_dx = fe.montgomery_inv_groups(dx, n_groups=math.gcd(R, 256))
    lam = fe.mul(fe.sub(ty, by), inv_dx)
    x3 = fe.sub(fe.sub(fe.sqr(lam), bx), tx)
    qlo, qhi = fe.i32(x3[0]), fe.i32(x3[1])
    if bitmap is None:
        return qlo, qhi, deg
    return qlo, qhi, deg, bmp.survivor_mask_ref(bitmap, qhi, qlo)


def walk_blocks(bases_x, bases_y, tab_x, tab_y, bitmap=None):
    """bases: (8, R) int32 affine walk bases; tab: (8, U) int32 offsets.
    Returns qlo, qhi (R, U) int32 — limbs 0 and 1 of x(base_r + tab_u) —
    and deg (R, U) bool (dx == 0: the lane's x is invalid). Given a
    bitmap (a DeviceBitmap, the level-1 filter), also the survivor mask of
    its probe of every key, degenerate lanes' included, as
    bitmap.survivor_mask_ref has it: (R, ceil(U/32)) int32, from the same
    launch."""
    R = bases_x.shape[1] if bases_x.dim() == 2 else -1
    U = tab_x.shape[1] if tab_x.dim() == 2 else -1
    for name, t, shape in (("bases_x", bases_x, (8, R)), ("bases_y", bases_y, (8, R)),
                           ("tab_x", tab_x, (8, U)), ("tab_y", tab_y, (8, U))):
        _check(name, t, shape)
    if R < 1 or U < 1:
        raise ValueError(f"walk_blocks needs R >= 1 and U >= 1 (R={R}, U={U})")
    words = ()
    if bitmap is not None:
        bmp.check_filter(bitmap)
        words = (bitmap.words,)
    if not _build.on_cuda(bases_x, bases_y, tab_x, tab_y, *words):
        return walk_blocks_ref(bases_x, bases_y, tab_x, tab_y, bitmap)
    dev = bases_x.device
    qlo = torch.empty((R, U), dtype=torch.int32, device=dev)
    qhi = torch.empty_like(qlo)
    deg = torch.empty((R, U), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (bases_x, bases_y, tab_x, tab_y, qlo, qhi, deg)]
    if bitmap is None:
        _build.launch("kh_walk_blocks", *ptrs, None, None, R, U, 0, _build.stream(bases_x))
        out = qlo, qhi, deg
    else:
        mask = torch.empty((R, -(-U // 32)), dtype=torch.int32, device=dev)
        _build.launch("kh_walk_blocks", *ptrs, bitmap.words.data_ptr(), mask.data_ptr(), R, U,
                      bitmap.bits_log2, _build.stream(bases_x))
        out = qlo, qhi, deg, mask
    walk_blocks.launches += 1
    return out


walk_blocks.launches = 0


# ---------------------------------------------------------------------------
# Chunk: K1 + K2 for T targets
# ---------------------------------------------------------------------------


class ChunkMultiResult(NamedTuple):
    next_x: torch.Tensor  # (T, 8) int32 limbs
    next_y: torch.Tensor
    qhi: torch.Tensor  # (T*K, U) int32, row = t*K + s
    qlo: torch.Tensor
    degenerate: torch.Tensor  # (T*K, U) bool
    adv_degenerate: torch.Tensor  # (T, K) bool
    survivor_mask: Optional[torch.Tensor] = None  # (T*K, ceil(U/32)) int32, with a bitmap


def chunk_multi(px_bm, py_bm, tab_x_lm, tab_y_lm, adv_x, adv_y,
                K: int, U: int, T: int, adv_tab=None, bitmap=None) -> ChunkMultiResult:
    """px_bm/py_bm: (T, 8) walk base per target; tab_*_lm: (8, U);
    adv_*: (8,) and adv_tab its table (see advance_chain). All T*K bases
    come from one K1 launch; K2 walks all T*K rows in one launch and,
    given the level-1 bitmap, probes them (see walk_blocks)."""
    if tuple(px_bm.shape) != (T, 8) or tuple(tab_x_lm.shape) != (8, U):
        raise ValueError(f"chunk_multi: px {tuple(px_bm.shape)} / tab "
                         f"{tuple(tab_x_lm.shape)} do not match T={T}, U={U}")
    bx, by, nx, ny, adeg = advance_chain(
        px_bm.t().contiguous(), py_bm.t().contiguous(), adv_x, adv_y, K, adv_tab
    )
    qlo, qhi, deg, *mask = walk_blocks(bx, by, tab_x_lm, tab_y_lm, bitmap)
    return ChunkMultiResult(nx.t().contiguous(), ny.t().contiguous(),
                            qhi, qlo, deg, adeg, *mask)


pallas_chunk_multi = chunk_multi  # the JAX package's name for this function
