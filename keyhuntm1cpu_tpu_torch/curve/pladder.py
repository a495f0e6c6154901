"""Scalar-mult ladder (K6): k*G for arbitrary 256-bit scalars.

Port of keyhuntm1cpu_tpu/curve/pladder.py. Byte w of k selects the window
table point gtable[w][byte] = (byte * 2^(8w)) * G (curve/tables.gtable_np);
the accumulator starts at infinity, a zero byte keeps it, the first
non-zero byte loads its point and every later one is a Jacobian + affine
mixed add without a doubling fallback: an h == 0 lane (doubling or
cancellation mid-ladder) sets h = 1, carries on and is flagged irregular,
for the caller's exact host check (probability ~2^-250 per random scalar,
but k = N is one). Then Z is normalised to affine.

``scalar_mult_tiles`` runs ``scalar_mult_ref`` (the ``_ladder_blocks`` math
on field/fe.py) for CPU tensors and K6 of csrc/ladder.cu for CUDA tensors.
K6 is two launches, counted as one K6 launch in
``scalar_mult_tiles.launches``: the ladder with SPLIT lanes per scalar,
each over 32/SPLIT contiguous windows, whose partial sums merge by
Jacobian + Jacobian adds (to Jacobian), then one inversion per group of
scalars (to affine). Its plain version in its own order is
``scalar_mult_split_ref``.
Both ladders are exact on every lane they leave unflagged; they may flag
different degenerate lanes (the caller checks flagged lanes exactly). The
TPU's one-hot int8 MXU table gather and window-major slab layout have no
counterpart: the kernel reads the table directly. Layouts: k, x, y
limb-major (8, V) int32; tables (32, 256, 8) int32 (u32 bits).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..field import fe
from ..ref import ecref
from .tables import gtable_np

# K6's lanes per scalar: csrc/ladder.cu's kLadderSplit, chosen with its other
# compile-time shapes by scripts/torch_ladder_shapes.py on the card
SPLIT = 2


def gtable_tensors(device):
    """The window tables (curve/tables.gtable_np) as (32, 256, 8) int32 on
    `device`."""
    return tuple(torch.from_numpy(t.view(np.int32)).to(device) for t in gtable_np())


def _madd_flag(X, Y, Z, qx, qy):
    """Jacobian P + affine Q (madd-2007-bl), h == 0 lanes flagged, h := 1."""
    z2 = fe.sqr(Z)
    u2 = fe.mul(qx, z2)
    s2 = fe.mul(qy, fe.mul(Z, z2))
    h = fe.sub(u2, X)
    r = fe.sub(s2, Y)
    h_zero = fe.is_zero(h)
    h = fe.select(h_zero, fe.one_like(h), h)
    hh = fe.sqr(h)
    v = fe.mul(X, hh)
    hhh = fe.mul(h, hh)
    x3 = fe.sub(fe.sub(fe.sqr(r), hhh), fe.dbl(v))
    y3 = fe.sub(fe.mul(r, fe.sub(v, x3)), fe.mul(Y, hhh))
    z3 = fe.mul(Z, h)
    return x3, y3, z3, h_zero


def _jadd_flag(X1, Y1, Z1, X2, Y2, Z2):
    """Jacobian P1 + P2 (add-2007-bl), h == 0 lanes flagged, h := 1."""
    z1z1, z2z2 = fe.sqr(Z1), fe.sqr(Z2)
    u1, u2 = fe.mul(X1, z2z2), fe.mul(X2, z1z1)
    s1 = fe.mul(Y1, fe.mul(Z2, z2z2))
    s2 = fe.mul(Y2, fe.mul(Z1, z1z1))
    h = fe.sub(u2, u1)
    h_zero = fe.is_zero(h)
    h = fe.select(h_zero, fe.one_like(h), h)
    i = fe.sqr(fe.dbl(h))
    j = fe.mul(h, i)
    r = fe.dbl(fe.sub(s2, s1))
    v = fe.mul(u1, i)
    x3 = fe.sub(fe.sub(fe.sqr(r), j), fe.dbl(v))
    y3 = fe.sub(fe.mul(r, fe.sub(v, x3)), fe.dbl(fe.mul(s1, j)))
    z3 = fe.mul(fe.sub(fe.sub(fe.sqr(fe.add(Z1, Z2)), z1z1), z2z2), h)
    return x3, y3, z3, h_zero


def scalar_mult_ref(k: torch.Tensor, gtx: torch.Tensor, gty: torch.Tensor):
    """Plain torch version of K6 (see scalar_mult_tiles)."""
    kk = fe.u32(k)
    gx, gy = fe.u32(gtx), fe.u32(gty)
    X = torch.zeros_like(kk)
    Y = torch.zeros_like(kk)
    Z = fe.one_like(kk)
    one = fe.one_like(kk)
    inf = torch.ones(kk.shape[1:], dtype=torch.bool, device=k.device)
    irr = torch.zeros_like(inf)
    for w in range(32):
        byte = (kk[w // 4] >> (8 * (w % 4))) & 0xFF
        qx, qy = gx[w][byte].t(), gy[w][byte].t()
        q_inf = byte == 0
        x3, y3, z3, hz = _madd_flag(X, Y, Z, qx, qy)
        irr = irr | (hz & ~inf & ~q_inf)
        X = fe.select(q_inf, X, fe.select(inf, qx, x3))
        Y = fe.select(q_inf, Y, fe.select(inf, qy, y3))
        Z = fe.select(q_inf, Z, fe.select(inf, one, z3))
        inf = inf & q_inf
    z_safe = fe.select(fe.is_zero(Z) | inf, one, Z)
    zi = fe.inv(z_safe)  # per lane here; the kernel shares one per block
    zi2 = fe.sqr(zi)
    return (fe.i32(fe.mul(X, zi2)), fe.i32(fe.mul(Y, fe.mul(zi, zi2))), inf, irr)


def scalar_mult_split_ref(k: torch.Tensor, gtx: torch.Tensor, gty: torch.Tensor,
                          split: int):
    """Plain torch version of K6 in the kernels' order: `split` lanes per
    scalar, lane s running the sequential ladder (scalar_mult_ref's) over
    windows s*32/split .. (s+1)*32/split - 1 from infinity; then log2(split)
    levels of merges, where lanes s and s ^ m both take lower + upper
    (_jadd_flag; an infinite partial passes through, h == 0 flags); then
    to affine (one exact inverse per scalar, as the kernel's shared one)."""
    if split not in (1, 2, 4, 8):
        raise ValueError(f"split must be 1, 2, 4 or 8, got {split}")
    kk = fe.u32(k)
    gx, gy = fe.u32(gtx), fe.u32(gty)
    V, nw = kk.shape[1], 32 // split
    lanes = torch.arange(split, device=k.device)
    X = kk.new_zeros((8, split, V))
    Y = torch.zeros_like(X)
    Z = fe.one_like(X)
    one = fe.one_like(X)
    inf = torch.ones((split, V), dtype=torch.bool, device=k.device)
    irr = torch.zeros_like(inf)
    for t in range(nw):
        w = lanes * nw + t  # lane s's window at step t
        byte = (kk[w // 4] >> (8 * (w % 4))[:, None]) & 0xFF  # (split, V)
        qx = gx[w[:, None], byte].permute(2, 0, 1)
        qy = gy[w[:, None], byte].permute(2, 0, 1)
        q_inf = byte == 0
        x3, y3, z3, hz = _madd_flag(X, Y, Z, qx, qy)
        irr = irr | (hz & ~inf & ~q_inf)
        X = fe.select(q_inf, X, fe.select(inf, qx, x3))
        Y = fe.select(q_inf, Y, fe.select(inf, qy, y3))
        Z = fe.select(q_inf, Z, fe.select(inf, one, z3))
        inf = inf & q_inf
    m = 1
    while m < split:
        lo, hi = lanes & ~m, lanes | m  # each lane's pair, lower and upper
        i1, i2 = inf[lo], inf[hi]
        x3, y3, z3, hz = _jadd_flag(X[:, lo], Y[:, lo], Z[:, lo], X[:, hi], Y[:, hi], Z[:, hi])
        X = fe.select(i1, X[:, hi], fe.select(i2, X[:, lo], x3))
        Y = fe.select(i1, Y[:, hi], fe.select(i2, Y[:, lo], y3))
        Z = fe.select(i1, Z[:, hi], fe.select(i2, Z[:, lo], z3))
        irr = irr[lo] | irr[hi] | (hz & ~i1 & ~i2)
        inf = i1 & i2
        m <<= 1
    X, Y, Z, inf, irr = X[:, 0], Y[:, 0], Z[:, 0], inf[0], irr[0]
    z_safe = fe.select(fe.is_zero(Z) | inf, one[:, 0], Z)
    zi = fe.inv(z_safe)
    zi2 = fe.sqr(zi)
    return (fe.i32(fe.mul(X, zi2)), fe.i32(fe.mul(Y, fe.mul(zi, zi2))), inf, irr)


def scalar_mult_tiles(k: torch.Tensor, gtx: torch.Tensor, gty: torch.Tensor):
    """Batched k*G. k: (8, V) int32 scalar limbs (any 256-bit value);
    gtx/gty: (32, 256, 8) int32 window tables (gtable_tensors). Returns
    (x, y, inf, irregular): affine (8, V) int32 limbs, (V,) bool flags.
    inf lanes (k == 0) carry x = y = 0; irregular lanes are not trusted."""
    V = k.shape[1] if k.dim() == 2 else 0
    if k.dtype != torch.int32 or not k.is_contiguous() or tuple(k.shape) != (8, V) or V < 1:
        raise ValueError(f"k: need contiguous int32 (8, V) limbs, got {k.dtype} "
                         f"{tuple(k.shape)}")
    for name, t in (("gtx", gtx), ("gty", gty)):
        if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != (32, 256, 8):
            raise ValueError(f"{name}: need a contiguous int32 (32, 256, 8) table")
    if not _build.on_cuda(k, gtx, gty):
        return scalar_mult_ref(k, gtx, gty)
    dev, st = k.device, _build.stream(k)
    jac = torch.empty((3, 8, V), dtype=torch.int32, device=dev)
    x = torch.empty((8, V), dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    inf = torch.empty(V, dtype=torch.bool, device=dev)
    irr = torch.empty_like(inf)
    _build.launch("kh_ladder_jac", k.data_ptr(), gtx.data_ptr(), gty.data_ptr(), jac.data_ptr(),
                  inf.data_ptr(), irr.data_ptr(), V, st)
    _build.launch("kh_ladder_affine", jac.data_ptr(), inf.data_ptr(), x.data_ptr(),
                  y.data_ptr(), V, st)
    scalar_mult_tiles.launches += 1
    return x, y, inf, irr


scalar_mult_tiles.launches = 0


def scalar_mult_points(ks, gtx: torch.Tensor, gty: torch.Tensor):
    """k*G for each python int of ks (reduced mod N) as ecref points (None
    for infinity): one scalar_mult_tiles call on the tables' device, its
    irregular lanes recomputed exactly by ecref. The engines' batched
    host check of candidate keys."""
    ks = [k % ecref.N for k in ks]
    k = torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in ks], axis=1).view(np.int32))
    x, y, inf, irr = (t.cpu().numpy() for t in scalar_mult_tiles(k.to(gtx.device), gtx, gty))
    x, y = x.view(np.uint32), y.view(np.uint32)
    return [ecref.scalar_mult(v) if irr[j] else None if inf[j]
            else (fe.limbs_to_int(x[:, j]), fe.limbs_to_int(y[:, j]))
            for j, v in enumerate(ks)]
