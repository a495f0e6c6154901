"""The walker group walk fused with the block advance (``walk_fused``).

Port of keyhuntm1cpu_tpu/curve/walk.py ``walk_fused``, the hot loop of the
large-target brute path. Each of W walkers sits at a center C_w; a step
computes C_w + u*S and C_w - u*S for u = 1..U (S the stride point, the
table holds u*S) and the next center C_w + ADV, with ONE batched inversion
of every denominator (the chunked Montgomery trick of fe.batch_inv_mod_p).
When C_w == ADV the advance is a doubling (its 1/(2*cy) rides in the same
batch); C_w == -ADV is flagged (``adv_degenerate``); a lane with
dx == 0 is flagged ``degenerate`` and its x is garbage.

On the card the step is three launches: ``walk_prefix`` (csrc/walk.cu:
one warp per chain forms the denominators and their prefix products by a
prefix scan), ``pinv.inv_batch`` of
the chain totals, ``walk_emit`` (csrc/walk.cu: one warp per chain peels
the inverses by a suffix scan and emits every output). The batch differs from the JAX one only in the advance lane:
1/(ADVx - cx) and 1/(2*cy) come from the inverse of their product, so one
thread owns both; the walker's second slot is a 1, which keeps the chain
width ceil(W*(U+2)/chain_len) that pinv sees. The inverses are exact, so
the outputs equal walk_fused's bit for bit. Each wrapper runs its plain
torch version for CPU tensors and counts its launches
(``<wrapper>.launches``).

Layouts (limb-major int32 holding u32 bits): centers (8, W), table
(8, U), ADV (8,). ``x_all`` is (n_endo, 8, W, npts) with npts = 2U+1
lanes per walker, +u (0..U-1), -u (U..2U-1) and the center (last), and
the GLV variants x*beta, x*beta^2 when n_endo = 3; the JAX fields
x_plus, x_minus (and y) are views of it. The walk is always symmetric
(the JAX ``symmetric=True``): the brute path is its only caller.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..field import fe, pinv
from ..ref import ecref
from .points import PointBatch


class FusedWalkResult(NamedTuple):
    x_plus: torch.Tensor  # (8, W, U) x of C + u*S
    x_minus: torch.Tensor  # (8, W, U) x of C - u*S
    y_plus: Optional[torch.Tensor]  # (8, W, U) when need_y
    y_minus: Optional[torch.Tensor]
    degenerate: torch.Tensor  # (W, U) bool: dx == 0, the lane's x is garbage
    adv_x: torch.Tensor  # (8, W) x of C + ADV
    adv_y: torch.Tensor  # (8, W)
    adv_degenerate: torch.Tensor  # (W,) bool: C == -ADV, adv_* invalid
    x_all: torch.Tensor  # (n_endo, 8, W, npts): +u, -u, center; GLV variants
    y_all: Optional[torch.Tensor]  # (8, W, npts) when need_y


def n_chains(W: int, U: int, chain_len: int) -> int:
    """Chains of the step's batch (the width pinv.inv_batch sees)."""
    return -(-W * (U + 2) // chain_len)


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need a contiguous int32 tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _check_inputs(cx, cy, tab_x, tab_y, adv_x, adv_y, chain_len: int):
    W = cx.shape[1] if cx.dim() == 2 else -1
    U = tab_x.shape[1] if tab_x.dim() == 2 else -1
    for name, t, shape in (("center x", cx, (8, W)), ("center y", cy, (8, W)),
                           ("tab_x", tab_x, (8, U)), ("tab_y", tab_y, (8, U)),
                           ("adv_x", adv_x, (8,)), ("adv_y", adv_y, (8,))):
        _check(name, t, shape)
    if W < 1 or U < 1 or chain_len < 1:
        raise ValueError(f"walk needs W, U, chain_len >= 1 (W={W}, U={U}, L={chain_len})")
    return W, U


def _safe(a: torch.Tensor) -> torch.Tensor:
    """a with zeros set to 1 (every zero denominator of the JAX batch)."""
    return fe.select(fe.is_zero(a), fe.one_like(a), a)


def _denominators(cx, cy, tab_x, tab_y, adv_x, adv_y):
    """The step's batch, int64 (8, W, U+2): tx_u - cx for the table lanes,
    (ADVx - cx) * 2cy for the advance lane and a 1, zeros set to 1 first."""
    W, U = cx.shape[1], tab_x.shape[1]
    cx64 = fe.u32(cx)[:, :, None]
    tx = torch.cat([fe.u32(tab_x), fe.u32(adv_x)[:, None]], dim=1)[:, None, :]
    dx = _safe(fe.sub(tx.expand(8, W, U + 1), cx64.expand(8, W, U + 1)))
    m = fe.mul(dx[:, :, U], _safe(fe.dbl(fe.u32(cy))))
    return torch.cat([dx[:, :, :U], m[:, :, None], fe.one_like(m)[:, :, None]], dim=2)


# ---------------------------------------------------------------------------
# walk_prefix: the denominators and the chains' prefix products
# ---------------------------------------------------------------------------


def walk_prefix_ref(cx, cy, tab_x, tab_y, adv_x, adv_y, chain_len: int):
    """Plain torch version of the kernel (see walk_prefix)."""
    dens = _denominators(cx, cy, tab_x, tab_y, adv_x, adv_y)
    _, pre = fe.chain_prefix(dens.reshape(8, -1), chain_len)
    return fe.i32(pre.reshape(8, -1)), fe.i32(pre[:, -1])


def walk_prefix(cx, cy, tab_x, tab_y, adv_x, adv_y, chain_len: int):
    """centers (8, W), table (8, U), ADV (8,) int32 limbs. Returns the
    prefix products (8, chain_len*C) (element l*C + c at column l*C + c)
    and the chain totals (8, C), C = n_chains(W, U, chain_len)."""
    W, U = _check_inputs(cx, cy, tab_x, tab_y, adv_x, adv_y, chain_len)
    if not _build.on_cuda(cx, cy, tab_x, tab_y, adv_x, adv_y):
        return walk_prefix_ref(cx, cy, tab_x, tab_y, adv_x, adv_y, chain_len)
    C = n_chains(W, U, chain_len)
    pre = torch.empty((8, chain_len * C), dtype=torch.int32, device=cx.device)
    totals = torch.empty((8, C), dtype=torch.int32, device=cx.device)
    ptrs = [t.data_ptr() for t in (cx, cy, tab_x, tab_y, adv_x, adv_y, pre, totals)]
    _build.launch("kh_walk_prefix", *ptrs, W, U, chain_len, C, _build.stream(cx))
    walk_prefix.launches += 1
    return pre, totals


walk_prefix.launches = 0


# ---------------------------------------------------------------------------
# walk_emit: the backward peel and every output of the step
# ---------------------------------------------------------------------------


def _beta_limbs(e: int, like: torch.Tensor) -> torch.Tensor:
    b = torch.from_numpy(fe.int_to_limbs(pow(ecref.BETA, e, ecref.P)).astype(np.int64))
    return b.to(like.device).reshape((8,) + (1,) * (like.dim() - 1)).expand(like.shape)


def walk_emit_ref(cx, cy, tab_x, tab_y, adv_x, adv_y, pre, inv_totals, chain_len: int,
                  n_endo: int = 1, need_y: bool = False):
    """Plain torch version of the kernel (see walk_emit)."""
    W, U = cx.shape[1], tab_x.shape[1]
    dens = _denominators(cx, cy, tab_x, tab_y, adv_x, adv_y)
    chains, _ = fe.chain_prefix(dens.reshape(8, -1), chain_len)
    invs = fe.chain_peel(chains, fe.u32(pre).reshape(chains.shape), fe.u32(inv_totals))
    invs = invs[:, : W * (U + 2)].reshape(8, W, U + 2)
    cx0, cy0 = fe.u32(cx), fe.u32(cy)
    shape = (8, W, U)
    c_x, c_y = cx0[:, :, None].expand(shape), cy0[:, :, None].expand(shape)
    tx, ty = fe.u32(tab_x)[:, None, :].expand(shape), fe.u32(tab_y)[:, None, :].expand(shape)
    inv_dx = invs[:, :, :U]

    def lane(num):
        lam = fe.mul(num, inv_dx)
        x3 = fe.sub(fe.sub(fe.sqr(lam), c_x), tx)
        return x3, (fe.sub(fe.mul(lam, fe.sub(c_x, x3)), c_y) if need_y else None)

    xs, ys = zip(lane(fe.sub(ty, c_y)), lane(fe.neg(fe.add(ty, c_y))))
    # the advance lane: inv = 1 / ((ADVx - cx) * 2cy), zero dx set to 1
    ax = fe.u32(adv_x)[:, None].expand(8, W)
    ay = fe.u32(adv_y)[:, None].expand(8, W)
    dxa = fe.sub(ax, cx0)
    dx_zero = fe.is_zero(dxa)
    dxa = fe.select(dx_zero, fe.one_like(dxa), dxa)
    two_cy = _safe(fe.dbl(cy0))
    inv_dx_a, inv_2y = fe.mul(invs[:, :, U], two_cy), fe.mul(invs[:, :, U], dxa)
    lam = fe.mul(fe.sub(ay, cy0), inv_dx_a)
    nx = fe.sub(fe.sub(fe.sqr(lam), cx0), ax)
    ny = fe.sub(fe.mul(lam, fe.sub(cx0, nx)), cy0)
    sq = fe.sqr(cx0)  # doubling fallback for C == ADV: lambda = 3 cx^2 / 2cy
    lam_d = fe.mul(fe.add(fe.dbl(sq), sq), inv_2y)
    xd = fe.sub(fe.sub(fe.sqr(lam_d), cx0), cx0)
    yd = fe.sub(fe.mul(lam_d, fe.sub(cx0, xd)), cy0)
    is_double = dx_zero & fe.eq(cy0, ay)
    x1 = torch.cat(list(xs) + [cx0[:, :, None]], dim=2)  # (8, W, npts)
    x_all = torch.stack([x1] + [fe.mul(x1, _beta_limbs(e, x1)) for e in range(1, n_endo)])
    y_all = torch.cat(list(ys) + [cy0[:, :, None]], dim=2) if need_y else None
    deg = fe.is_zero(fe.sub(tx, c_x))
    return (fe.i32(x_all), None if y_all is None else fe.i32(y_all), deg,
            fe.i32(fe.select(is_double, xd, nx)), fe.i32(fe.select(is_double, yd, ny)),
            dx_zero & ~is_double)


def walk_emit(cx, cy, tab_x, tab_y, adv_x, adv_y, pre, inv_totals, chain_len: int,
              n_endo: int = 1, need_y: bool = False):
    """Peel the step's inverses from the prefixes (walk_prefix) and the
    inverted chain totals (8, C), and emit: x (n_endo, 8, W, npts), y
    (8, W, npts) or None, degenerate (W, U) bool, the next centers (8, W)
    x2 and adv_degenerate (W,) bool (see the module docstring)."""
    W, U = _check_inputs(cx, cy, tab_x, tab_y, adv_x, adv_y, chain_len)
    C = n_chains(W, U, chain_len)
    _check("prefixes", pre, (8, chain_len * C))
    _check("inverted totals", inv_totals, (8, C))
    if n_endo not in (1, 3):
        raise ValueError(f"n_endo must be 1 or 3, got {n_endo}")
    args = (cx, cy, tab_x, tab_y, adv_x, adv_y, pre, inv_totals)
    if not _build.on_cuda(*args):
        return walk_emit_ref(*args, chain_len, n_endo, need_y)
    npts = 2 * U + 1
    dev = cx.device
    x = torch.empty((n_endo, 8, W, npts), dtype=torch.int32, device=dev)
    y = torch.empty((8, W, npts), dtype=torch.int32, device=dev) if need_y else None
    deg = torch.empty((W, U), dtype=torch.bool, device=dev)
    nx, ny = torch.empty_like(cx), torch.empty_like(cy)
    adeg = torch.empty((W,), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in args + (x,)]
    ptrs += [None if y is None else y.data_ptr()]
    ptrs += [t.data_ptr() for t in (deg, nx, ny, adeg)]
    _build.launch("kh_walk_emit", *ptrs, W, U, chain_len, C, n_endo, _build.stream(cx))
    walk_emit.launches += 1
    return x, y, deg, nx, ny, adeg


walk_emit.launches = 0


def walk_fused(center: PointBatch, table_x, table_y, adv_x, adv_y, need_y: bool = False,
               chain_len: int = 32, n_endo: int = 1) -> FusedWalkResult:
    """One walker step (walk.walk_fused): center (8, W) limbs, table (8, U)
    of u*S, ADV (8,). n_endo = 3 adds the GLV variants of every x to
    x_all. CPU tensors take the plain versions, CUDA tensors the kernels."""
    cx, cy = center.x, center.y
    pre, totals = walk_prefix(cx, cy, table_x, table_y, adv_x, adv_y, chain_len)
    x, y, deg, nx, ny, adeg = walk_emit(cx, cy, table_x, table_y, adv_x, adv_y, pre,
                                        pinv.inv_batch(totals), chain_len, n_endo, need_y)
    U = table_x.shape[1]
    minus = slice(U, 2 * U)
    return FusedWalkResult(
        x[0, :, :, :U], x[0, :, :, minus], y[:, :, :U] if need_y else None,
        y[:, :, minus] if need_y else None,
        deg, nx, ny, adeg, x, y)
