"""The BSGS giant-step walk: advance chain (K1) and walk blocks (K2).

Port of keyhuntm1cpu_tpu/curve/pwalk.py. The chunk is split the same way:

- **K1 advance chain** (``advance_chain``): the K walk bases of each
  target are a serial chain P, P+ADV, ..., P+(K-1)ADV. It runs in Jacobian
  coordinates (mixed adds, no inversions), then one batched inversion
  normalises all K points.
- **K2 walk blocks** (``walk_blocks``): with the bases known, the
  T*K*U additions base_r + tab[u] are independent. Each emits the low 64
  bits of x3 (qlo = limb 0, qhi = limb 1) and flags dx == 0 lanes.

Every wrapper runs its plain torch version (``*_ref``) for a CPU tensor
and launches its CUDA kernel (csrc/pwalk.cu) for a CUDA tensor; each
counts its kernel launches in ``<wrapper>.launches``.

Layouts (the JAX package's, without its 128-lane tiling): field elements
are limb-major int32 tensors holding u32 bits, ``(8, n)``. Bases are
``(8, T*K)`` with column ``t*K + s``; qlo/qhi/deg are ``(T*K, U)``;
adv_degenerate is ``(T, K)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..field import fe

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


def _mixed_add(X, Y, Z, qx, qy):
    """Jacobian P + affine Q (madd-2007-bl) with the doubling fallback
    (dbl-2009-l, a = 0) for P == Q, exactly as pwalk._mixed_add: returns
    (X3, Y3, Z3, inf) where inf flags P == -Q (the result is garbage)."""
    z2 = fe.sqr(Z)
    u2 = fe.mul(qx, z2)
    s2 = fe.mul(qy, fe.mul(Z, z2))
    h = fe.sub(u2, X)
    r = fe.sub(s2, Y)
    h_zero = fe.is_zero(h)
    is_dbl = h_zero & fe.eq(s2, Y)
    h = fe.select(h_zero, fe.one_like(h), h)
    hh = fe.sqr(h)
    v = fe.mul(X, hh)
    hhh = fe.mul(h, hh)
    x3 = fe.sub(fe.sub(fe.sqr(r), hhh), fe.dbl(v))
    y3 = fe.sub(fe.mul(r, fe.sub(v, x3)), fe.mul(Y, hhh))
    z3 = fe.mul(Z, h)
    a_ = fe.sqr(X)
    b_ = fe.sqr(Y)
    c_ = fe.sqr(b_)
    t = fe.sqr(fe.add(X, b_))
    d_ = fe.dbl(fe.sub(fe.sub(t, a_), c_))
    e_ = fe.add(fe.dbl(a_), a_)
    xd = fe.sub(fe.sqr(e_), fe.dbl(d_))
    yd = fe.sub(fe.mul(e_, fe.sub(d_, xd)), fe.dbl(fe.dbl(fe.dbl(c_))))
    zd = fe.dbl(fe.mul(Y, Z))
    x3 = fe.select(is_dbl, xd, x3)
    y3 = fe.select(is_dbl, yd, y3)
    z3 = fe.select(is_dbl, zd, z3)
    return x3, y3, z3, h_zero & ~is_dbl


def advance_chain_ref(px, py, adv_x, adv_y, K: int):
    """Plain torch version of K1 (see advance_chain)."""
    T = px.shape[1]
    X, Y = fe.u32(px), fe.u32(py)
    qx = fe.u32(adv_x)[:, None].expand(8, T)
    qy = fe.u32(adv_y)[:, None].expand(8, T)
    Z = fe.one_like(X)
    xs, ys, zs, degs = [], [], [], []
    for _ in range(K):
        X, Y, Z, hz = _mixed_add(X, Y, Z, qx, qy)
        degs.append(hz)
        # once degenerate, keep Z invertible (pwalk.py:111-112)
        Z = fe.select(fe.is_zero(Z), fe.one_like(Z), Z)
        xs.append(X)
        ys.append(Y)
        zs.append(Z)
    zinv = fe.montgomery_inv_groups(torch.stack(zs, dim=1), n_groups=K)
    zi2 = fe.sqr(zinv)
    cx = fe.mul(torch.stack(xs, dim=1), zi2)  # (8, K, T): P+ADV .. P+K*ADV
    cy = fe.mul(torch.stack(ys, dim=1), fe.mul(zinv, zi2))
    # walk-base order: base_0 = P, base_s = chain_{s-1}; column t*K + s
    bx = torch.cat([fe.u32(px)[:, None], cx[:, : K - 1]], dim=1)
    by = torch.cat([fe.u32(py)[:, None], cy[:, : K - 1]], dim=1)
    bx = fe.i32(bx.permute(0, 2, 1).reshape(8, T * K))
    by = fe.i32(by.permute(0, 2, 1).reshape(8, T * K))
    adeg = torch.stack(degs, dim=1)  # (T, K)
    return bx, by, fe.i32(cx[:, K - 1]), fe.i32(cy[:, K - 1]), adeg


def advance_chain(px, py, adv_x, adv_y, K: int):
    """px/py: (8, T) int32 limbs, one affine chain start per target.
    adv_x/adv_y: (8,) affine ADV. Returns walk bases (8, T*K) x2 (column
    t*K + s = P_t + s*ADV), next state (8, T) x2 = P_t + K*ADV, and
    adv_degenerate (T, K) bool (step s+1 hit P == -ADV)."""
    T = px.shape[1] if px.dim() == 2 else -1
    for name, t, shape in (("px", px, (8, T)), ("py", py, (8, T)),
                           ("adv_x", adv_x, (8,)), ("adv_y", adv_y, (8,))):
        _check(name, t, shape)
    if K < 1 or T < 1:
        raise ValueError(f"advance_chain needs K >= 1 and T >= 1 (K={K}, T={T})")
    if not _build.on_cuda(px, py, adv_x, adv_y):
        return advance_chain_ref(px, py, adv_x, adv_y, K)
    dev = px.device
    bx = torch.empty((8, T * K), dtype=torch.int32, device=dev)
    by = torch.empty_like(bx)
    nx = torch.empty((8, T), dtype=torch.int32, device=dev)
    ny = torch.empty_like(nx)
    adeg = torch.empty((T, K), dtype=torch.bool, device=dev)
    scratch = torch.empty((4, T * K, 8), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (px, py, adv_x, adv_y, bx, by, nx, ny, adeg, scratch)]
    _build.launch("kh_advance_chain", *ptrs, T, K, _build.stream(px))
    advance_chain.launches += 1
    return bx, by, nx, ny, adeg


advance_chain.launches = 0


# ---------------------------------------------------------------------------
# K2: walk blocks
# ---------------------------------------------------------------------------


def walk_blocks_ref(bases_x, bases_y, tab_x, tab_y):
    """Plain torch version of K2 (see walk_blocks). One batched inversion
    over all rows (rows chained as Montgomery groups)."""
    R = bases_x.shape[1]
    bx, by = fe.u32(bases_x)[:, :, None], fe.u32(bases_y)[:, :, None]
    tx, ty = fe.u32(tab_x)[:, None, :], fe.u32(tab_y)[:, None, :]
    dx = fe.sub(tx, bx)  # (8, R, U)
    deg = fe.is_zero(dx)
    dx = fe.select(deg, fe.one_like(dx), dx)
    inv_dx = fe.montgomery_inv_groups(dx, n_groups=R)
    lam = fe.mul(fe.sub(ty, by), inv_dx)
    x3 = fe.sub(fe.sub(fe.sqr(lam), bx), tx)
    return fe.i32(x3[0]), fe.i32(x3[1]), deg


def walk_blocks(bases_x, bases_y, tab_x, tab_y):
    """bases: (8, R) int32 affine walk bases; tab: (8, U) int32 offsets.
    Returns qlo, qhi (R, U) int32 — limbs 0 and 1 of x(base_r + tab_u) —
    and deg (R, U) bool (dx == 0: the lane's x is invalid)."""
    R = bases_x.shape[1] if bases_x.dim() == 2 else -1
    U = tab_x.shape[1] if tab_x.dim() == 2 else -1
    for name, t, shape in (("bases_x", bases_x, (8, R)), ("bases_y", bases_y, (8, R)),
                           ("tab_x", tab_x, (8, U)), ("tab_y", tab_y, (8, U))):
        _check(name, t, shape)
    if R < 1 or U < 1:
        raise ValueError(f"walk_blocks needs R >= 1 and U >= 1 (R={R}, U={U})")
    if not _build.on_cuda(bases_x, bases_y, tab_x, tab_y):
        return walk_blocks_ref(bases_x, bases_y, tab_x, tab_y)
    dev = bases_x.device
    qlo = torch.empty((R, U), dtype=torch.int32, device=dev)
    qhi = torch.empty_like(qlo)
    deg = torch.empty((R, U), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (bases_x, bases_y, tab_x, tab_y, qlo, qhi, deg)]
    _build.launch("kh_walk_blocks", *ptrs, R, U, _build.stream(bases_x))
    walk_blocks.launches += 1
    return qlo, qhi, deg


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


def chunk_multi(px_bm, py_bm, tab_x_lm, tab_y_lm, adv_x, adv_y,
                K: int, U: int, T: int) -> ChunkMultiResult:
    """px_bm/py_bm: (T, 8) walk base per target; tab_*_lm: (8, U);
    adv_*: (8,). All T chains share one K1 launch (a thread each); K2
    walks all T*K rows in one launch."""
    if tuple(px_bm.shape) != (T, 8) or tuple(tab_x_lm.shape) != (8, U):
        raise ValueError(f"chunk_multi: px {tuple(px_bm.shape)} / tab "
                         f"{tuple(tab_x_lm.shape)} do not match T={T}, U={U}")
    bx, by, nx, ny, adeg = advance_chain(
        px_bm.t().contiguous(), py_bm.t().contiguous(), adv_x, adv_y, K
    )
    qlo, qhi, deg = walk_blocks(bx, by, tab_x_lm, tab_y_lm)
    return ChunkMultiResult(nx.t().contiguous(), ny.t().contiguous(),
                            qhi, qlo, deg, adeg)


pallas_chunk_multi = chunk_multi  # the JAX package's name for this function
