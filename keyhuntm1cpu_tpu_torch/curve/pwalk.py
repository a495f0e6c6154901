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
- **The paired walk** (``pair_tables``): every caller's table is a step
  table (u+1)*S, so on the card, where U % 64 == 0, K1 also computes each
  row's centre base + c*S (c = (U+1)/2 mod n, a half step) and K2 walks
  the row's columns as U/2 pairs centre +- (d + 1/2)*S that share one dx
  and one inverse: 2.5 field products and a squaring a point against 4 and
  a squaring. Its words are K2's, word for word. An engine builds the
  step table, ADV's table and the pair tables in one call (``walk_tables``),
  so that they agree.

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
from . import tables

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


def centre_offsets(step, U: int, adv, K: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's table of the paired walk's centres: j*ADV + c*S for j = 0..K-1,
    c = (U + 1)/2 mod n (S = step and ADV = adv, affine points of python
    ints), affine limb-major (8, K) int32 x and y on `device` (column j),
    computed exactly on the host with ref/ecref."""
    c = (U + 1) * ((ecref.N + 1) // 2) % ecref.N
    xs, ys = np.empty((K, 8), np.uint32), np.empty((K, 8), np.uint32)
    pt = ecref.scalar_mult(c, step)
    for j in range(K):
        if pt is None:
            raise ValueError(f"centre offset {j} is the point at infinity (U={U})")
        xs[j], ys[j] = fe.int_to_limbs(pt[0]), fe.int_to_limbs(pt[1])
        pt = ecref.point_add(pt, adv)
    return table_to_limb_major(xs, device), table_to_limb_major(ys, device)


class PairTables(NamedTuple):
    """The paired walk's tables on the card (see pair_tables)."""
    pair_x: torch.Tensor  # (8, U/2): (d + 1/2)*S, tables.pair_table
    pair_y: torch.Tensor
    centre_x: torch.Tensor  # (8, K): j*ADV + c*S, centre_offsets
    centre_y: torch.Tensor


def pair_tables(step, U: int, adv, K: int, device) -> Optional[PairTables]:
    """The paired walk's tables for the step table (u + 1)*S, u < U
    (tables.step_table(step, U)), and ADV = adv (affine points of python
    ints), for chunk_multi: K1 then computes each row's centre C = base +
    c*S, c = (U + 1)/2 mod n, and K2 walks its columns U/2 + d and U/2 - 1 -
    d as the pair C +- (d + 1/2)*S, d < U/2. None where K2 walks a point a
    thread: U not a multiple of 64 (there a warp's 32 pairs fill a whole
    survivor-mask word on each side) or off the card (the plain versions
    walk every point). Engines build it once, beside adv_multiples."""
    device = torch.device(device)
    if U % 64 or device.type != "cuda":
        return None
    hx, hy = tables.pair_table(step, U // 2)
    return PairTables(table_to_limb_major(hx, device), table_to_limb_major(hy, device),
                      *centre_offsets(step, U, adv, K, device))


class WalkTables(NamedTuple):
    """A BSGS walk's constants on one device, built together by walk_tables
    so that the pair tables agree with the step table and ADV."""
    tab_x: torch.Tensor  # (8, U): the step table (u + 1)*S
    tab_y: torch.Tensor
    adv_x: torch.Tensor  # (8,): ADV
    adv_y: torch.Tensor
    adv_tab: Tuple[torch.Tensor, torch.Tensor]  # (8, K) x2: adv_multiples(ADV, K)
    pair_tab: Optional[PairTables]  # pair_tables(S, U, ADV, K)

    @property
    def U(self) -> int:
        return self.tab_x.shape[1]

    @property
    def K(self) -> int:
        return self.adv_tab[0].shape[1]

    def to(self, device) -> "WalkTables":
        """The same tables on `device` (no copy where they are)."""
        move = lambda ts: tuple(t.to(device) for t in ts)
        return WalkTables(*move(self[:4]), move(self.adv_tab),
                          None if self.pair_tab is None else PairTables(*move(self.pair_tab)))


def walk_tables(step, U: int, adv, K: int, device) -> WalkTables:
    """The constants of a walk by the step table (u + 1)*S, u < U (S =
    step), with ADV = adv and K bases a target a chunk (affine points of
    python ints), on `device`: what chunk_multi takes besides the bases.
    Engines build it once."""
    limbs = lambda v: torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(device)
    tx, ty = tables.step_table(step, U)
    return WalkTables(table_to_limb_major(tx, device), table_to_limb_major(ty, device),
                      limbs(adv[0]), limbs(adv[1]), adv_multiples(adv, K, device),
                      pair_tables(step, U, adv, K, device))


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


def advance_chain_ref(px, py, adv_x, adv_y, K: int, adv_tab=None, centre_tab=None):
    """Plain torch version of K1 (see advance_chain): the same T*K affine
    adds P_t + j*ADV, and with centre_tab the T*K centres P_t + ctab_s, with
    one batched inversion per target."""
    tab_x, tab_y = adv_tab if adv_tab is not None else adv_multiples((adv_x, adv_y), K,
                                                                      px.device)
    if centre_tab is not None:  # lanes K..2K-1: the centres
        tab_x, tab_y = (torch.cat([a, c], 1) for a, c in zip((tab_x, tab_y), centre_tab))
    T, L = px.shape[1], tab_x.shape[1]
    p_x = fe.u32(px)[:, :, None].expand(8, T, L)
    p_y = fe.u32(py)[:, :, None].expand(8, T, L)
    q_x = fe.u32(tab_x)[:, None, :].expand(8, T, L)
    q_y = fe.u32(tab_y)[:, None, :].expand(8, T, L)
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
    out = bx, by, fe.i32(x3[:, :, K - 1]), fe.i32(y3[:, :, K - 1]), inf[:, :K]
    if centre_tab is None:
        return out
    # a centre is not base_s + c*S where it is infinity, base s is (lane s
    # flagged) or P is off the curve (a garbage walk state)
    seven = torch.tensor(fe.int_to_limbs(7).astype(np.int64), device=px.device)[:, None]
    p_x, p_y = fe.u32(px), fe.u32(py)
    off = ~fe.eq(fe.sqr(p_y), fe.add(fe.mul(fe.sqr(p_x), p_x), seven))
    base_inf = torch.cat([torch.zeros_like(inf[:, :1]), inf[:, : K - 1]], 1)
    cflag = inf[:, K:] | base_inf | off[:, None]
    return out + (fe.i32(x3[:, :, K:].reshape(8, T * K)),
                  fe.i32(y3[:, :, K:].reshape(8, T * K)), cflag.reshape(T * K))


def advance_chain(px, py, adv_x, adv_y, K: int, adv_tab=None, centre_tab=None):
    """px/py: (8, T) int32 limbs, one affine chain start per target.
    adv_x/adv_y: (8,) affine ADV; adv_tab: its table (adv_multiples(ADV,
    K)), built here when None (a host copy: for tests and one-off calls;
    the search loops pass theirs). Returns walk bases (8, T*K) x2 (column
    t*K + s = P_t + s*ADV), next state (8, T) x2 = P_t + K*ADV, and
    adv_degenerate (T, K) bool: P_t + (s+1)*ADV is the point at infinity.
    Given centre_tab (the paired walk's centre_offsets, (8, K) x and y),
    also the centres (8, T*K) x2, P_t + centre_tab_s = base + c*S, and their
    flags (T*K,) bool (the centre, or base s, at infinity, or P_t off the
    curve: K2 walks a flagged row a point at a time), from the same launch.

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
    for name, t in zip(("adv_tab x", "adv_tab y", "centre_tab x", "centre_tab y"),
                       (*adv_tab, *(centre_tab or ()))):
        _check(name, t, (8, K))
    if not _build.on_cuda(px, py, *adv_tab, *(centre_tab or ())):
        return advance_chain_ref(px, py, adv_x, adv_y, K, adv_tab, centre_tab)
    dev = px.device
    bx = torch.empty((8, T * K), dtype=torch.int32, device=dev)
    by = torch.empty_like(bx)
    nx = torch.empty((8, T), dtype=torch.int32, device=dev)
    ny = torch.empty_like(nx)
    adeg = torch.empty((T, K), dtype=torch.bool, device=dev)
    out = bx, by, nx, ny, adeg
    centres = [None] * 5
    if centre_tab is not None:
        out += (torch.empty_like(bx), torch.empty_like(bx),
                torch.empty((T * K,), dtype=torch.bool, device=dev))
        centres = [*centre_tab, *out[5:]]
    ptrs = [t.data_ptr() for t in (px, py, *adv_tab, *out[:5])]
    ptrs += [None if t is None else t.data_ptr() for t in centres]
    _build.launch("kh_advance_chain", *ptrs, T, K, _build.stream(px))
    advance_chain.launches += 1
    return out


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


def walk_blocks(bases_x, bases_y, tab_x, tab_y, bitmap=None, pairs=None):
    """bases: (8, R) int32 affine walk bases; tab: (8, U) int32 offsets.
    Returns qlo, qhi (R, U) int32 — limbs 0 and 1 of x(base_r + tab_u) —
    and deg (R, U) bool (dx == 0: the lane's x is invalid). Given a
    bitmap (a DeviceBitmap, the level-1 filter), also the survivor mask of
    its probe of every key, degenerate lanes' included, as
    bitmap.survivor_mask_ref has it: (R, ceil(U/32)) int32, from the same
    launch. pairs (the paired walk, U % 64 == 0; see pair_tables): (pair_x,
    pair_y, centre_x, centre_y, centre_flags), tab the step table (u + 1)*S,
    the pair table (8, U/2) of the same S, the rows' centres base_r + c*S
    (8, R) and their flags (R,) bool as K1 gives them (advance_chain with
    centre_tab); on the card K2 then walks the pairs, with the same words.
    The plain version walks every point from the bases."""
    R = bases_x.shape[1] if bases_x.dim() == 2 else -1
    U = tab_x.shape[1] if tab_x.dim() == 2 else -1
    checks = [("bases_x", bases_x, (8, R)), ("bases_y", bases_y, (8, R)),
              ("tab_x", tab_x, (8, U)), ("tab_y", tab_y, (8, U))]
    if pairs is not None:
        if U % 64:
            raise ValueError(f"the paired walk needs U % 64 == 0 (U={U})")
        checks += [("pair_x", pairs[0], (8, U // 2)), ("pair_y", pairs[1], (8, U // 2)),
                   ("centre_x", pairs[2], (8, R)), ("centre_y", pairs[3], (8, R))]
        if pairs[4].dtype != torch.bool or tuple(pairs[4].shape) != (R,):
            raise ValueError(f"centre_flags: need a bool tensor of shape ({R},)")
    for name, t, shape in checks:
        _check(name, t, shape)
    if R < 1 or U < 1:
        raise ValueError(f"walk_blocks needs R >= 1 and U >= 1 (R={R}, U={U})")
    words = ()
    if bitmap is not None:
        bmp.check_filter(bitmap)
        words = (bitmap.words,)
    if not _build.on_cuda(bases_x, bases_y, tab_x, tab_y, *words, *(pairs or ())):
        return walk_blocks_ref(bases_x, bases_y, tab_x, tab_y, bitmap)
    dev = bases_x.device
    qlo = torch.empty((R, U), dtype=torch.int32, device=dev)
    qhi = torch.empty_like(qlo)
    deg = torch.empty((R, U), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (bases_x, bases_y, tab_x, tab_y, qlo, qhi, deg)]
    out = qlo, qhi, deg
    if bitmap is None:
        ptrs += [None, None]
    else:
        out += (torch.empty((R, -(-U // 32)), dtype=torch.int32, device=dev),)
        ptrs += [bitmap.words.data_ptr(), out[3].data_ptr()]
    ptrs += [None] * 5 if pairs is None else [t.data_ptr() for t in pairs]
    _build.launch("kh_walk_blocks", *ptrs, R, U, 0 if bitmap is None else bitmap.bits_log2,
                  _build.stream(bases_x))
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
    paired: bool = False  # K2 walked pairs


def chunk_multi(px_bm, py_bm, tab_x_lm, tab_y_lm, adv_x, adv_y,
                K: int, U: int, T: int, adv_tab=None, bitmap=None,
                pair_tab=None) -> ChunkMultiResult:
    """px_bm/py_bm: (T, 8) walk base per target; tab_*_lm: (8, U), the step
    table (u + 1)*S; adv_*: (8,) and adv_tab its table (see advance_chain).
    All T*K bases come from one K1 launch; K2 walks all T*K rows in one
    launch and, given the level-1 bitmap, probes them (see walk_blocks).
    pair_tab: pair_tables(S, U, ADV, K) of the same S and ADV (walk_tables
    builds them together), None where it is (then, and off the card, K2
    walks a point a thread); given it on the card, the K1 launch also
    computes the rows' centres and K2 walks pairs (result.paired)."""
    if tuple(px_bm.shape) != (T, 8) or tuple(tab_x_lm.shape) != (8, U):
        raise ValueError(f"chunk_multi: px {tuple(px_bm.shape)} / tab "
                         f"{tuple(tab_x_lm.shape)} do not match T={T}, U={U}")
    paired = pair_tab is not None and _build.on_cuda(px_bm)
    bx, by, nx, ny, adeg, *centres = advance_chain(
        px_bm.t().contiguous(), py_bm.t().contiguous(), adv_x, adv_y, K, adv_tab,
        pair_tab[2:] if paired else None
    )
    pairs = (*pair_tab[:2], *centres) if paired else None
    qlo, qhi, deg, *mask = walk_blocks(bx, by, tab_x_lm, tab_y_lm, bitmap, pairs)
    return ChunkMultiResult(nx.t().contiguous(), ny.t().contiguous(),
                            qhi, qlo, deg, adeg, mask[0] if mask else None, paired)


pallas_chunk_multi = chunk_multi  # the JAX package's name for this function
