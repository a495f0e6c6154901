"""CUDA kernels K1-K8 (K3 in each form), the minikey compaction and key
derivation, pinv, the Keccak ETH
hash, the probe, K2 with the level-1 probe and the compaction of its
survivor mask (against K2 alone and kh_probe_compact, word for word, at
the BSGS cell's shape and a ragged one; a chunk of five launches against
the unfused composition; the compaction at its tile edges; K2's own field
arithmetic on adversarial columns: x3 below 2^32 + 977, dy = 0, lambda =
p - 1, dx = p - 1, 1 and 0; the paired walk and K1's centre lanes, with
the rare lanes of tests/pair_walk_model.py planted, at the cell's and the
build's shapes, and the walk's choice of it by shape), the BSGS
chunk's bloom2 stage and summary (at the main
path's C1 = 34,816, C2 = 1,536, 256 rows of U = 16,384, a 2^28-key table
and 2^32- and 2^35-bit blooms, on the cases of tests/bsgs_cascade_cases.py,
and at its tile edges and row layouts; the compact kernels' shared
scratch reused by 1,000 launches on two streams; the brute compaction
launched three times in a row and on two streams beside the probe),
the two walker walk kernels, the walker step's lookup
and summary, the fused brute chunk's compaction and summary
(keyhuntm1cpu_tpu_torch/csrc) vs their plain torch versions on the card,
at small odd sizes (partial blocks; K4 at ragged row groups and column
blocks, the compaction on the cases of tests/brute_compact_cases.py and at
the main path's K = 256, U = 16384; K6 at V not a multiple of its
inversion group, walk_prefix and walk_emit at several chain
lengths), and the engines (the
brute walker path, vanity and the scheduled BSGS orders included) on CUDA
vs the engines on the CPU, and the legacy export's X(j*G) by K6
(utils/legacy.baby_x_bytes) vs the host walk. K6's other
compile-time shapes are held to their plain version by
scripts/torch_ladder_shapes.py.
Needs an NVIDIA GPU and nvcc; skipped without a GPU. Run on the card with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
Integer arithmetic: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu_torch.curve import pbrute, pladder, pwalk, tables, walk  # noqa: E402
from keyhuntm1cpu_tpu_torch.curve.points import point_batch_from_ints  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import brute, bsgs, minikeys  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe, pinv  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as st  # noqa: E402
from keyhuntm1cpu_tpu_torch.hash import phash, pminikey  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402
import bsgs_cascade_cases  # noqa: E402
import pair_walk_model  # noqa: E402
import walker_lookup_cases  # noqa: E402
from brute_compact_cases import CASES, make_case  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _limbs(v):
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())


def _pts(pts):
    return (torch.stack([_limbs(p[0]) for p in pts]).t().contiguous(),
            torch.stack([_limbs(p[1]) for p in pts]).t().contiguous())


def test_advance_chain_kernel_matches_plain(dev):
    advk, K = 1000, 64
    adv = ecref.scalar_mult(advk)
    ks = [advk, 12345, ecref.N - 3 * advk] + [777 * i + 5 for i in range(13)]
    px, py = _pts([ecref.scalar_mult(k) for k in ks])
    args = (px, py, _limbs(adv[0]), _limbs(adv[1]))
    want = pwalk.advance_chain_ref(*args, K)
    got = pwalk.advance_chain(*(a.to(dev) for a in args), K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("T,K", [(1, 1), (3, 7), (1, 256), (2, 300), (130, 16), (1, 1024)])
def test_advance_chain_kernel_planted_lanes(dev, T, K):
    """K1 with P == j*ADV (doubling lanes) and P == -j*ADV (flagged) planted
    at the first, middle and last lane, one tile and several."""
    advk = 0xA5A5 * 4096
    adv = ecref.scalar_mult(advk)
    ks = [0xC0FFEE + 7919 * t for t in range(T)]
    plants = [(0, K), (T - 1, -(K // 2 + 1)), (T // 2, 1), (min(2, T - 1), -K)]
    for t, j in plants:
        ks[t] = j * advk % ecref.N
    px, py = _pts([ecref.scalar_mult(k) for k in ks])
    args = (px, py, _limbs(adv[0]), _limbs(adv[1]))
    tab = pwalk.adv_multiples(adv, K, "cpu")
    want = pwalk.advance_chain_ref(*args, K, tab)
    n0 = pwalk.advance_chain.launches
    got = pwalk.advance_chain(*(a.to(dev) for a in args), K, tuple(t.to(dev) for t in tab))
    torch.cuda.synchronize()
    assert pwalk.advance_chain.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    flagged = {(t, -j - 1) for t, j in plants if j < 0 and ks[t] == (j * advk) % ecref.N}
    assert {tuple(f) for f in want[4].nonzero().tolist()} == flagged


def test_walk_blocks_kernel_block_edges(dev):
    """K2 at ragged R and U with dx == 0 at the first and last thread of a
    block (64, 128 or 256 threads) and in the last, ragged row."""
    R, U = 70, 300
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(7), U)
    rows = [ecref.scalar_mult(100 + 3 * r) for r in range(R)]
    plants = [(0, 0), (31, 127), (32, 128), (45, 63), (46, 64), (63, 255), (64, 256),
              (R - 1, U - 1)]
    for n, (r, u) in enumerate(plants):
        pt = ecref.scalar_mult(7 * (u + 1))
        rows[r] = pt if n % 2 else ecref.point_neg(pt)
    bx, by = _pts(rows)
    tx = pwalk.table_to_limb_major(tab_x, "cpu")
    ty = pwalk.table_to_limb_major(tab_y, "cpu")
    want = pwalk.walk_blocks_ref(bx, by, tx, ty)
    n0 = pwalk.walk_blocks.launches
    got = pwalk.walk_blocks(bx.to(dev), by.to(dev), tx.to(dev), ty.to(dev))
    torch.cuda.synchronize()
    assert pwalk.walk_blocks.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert all(bool(want[2][r, u]) for r, u in plants)


@pytest.mark.parametrize("R,U", [(45, 1000), (32, 128), (64, 7)])
def test_walk_blocks_kernel_matches_plain(dev, R, U):
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(7), U)
    rows = [ecref.scalar_mult(100 + 3 * r) for r in range(R)]
    rows[2] = ecref.scalar_mult(7 * 5)  # dx == 0 at u = 4
    rows[30] = ecref.point_neg(ecref.scalar_mult(7 * 6))  # dx == 0 at u = 5
    bx, by = _pts(rows)
    tx = pwalk.table_to_limb_major(tab_x, "cpu")
    ty = pwalk.table_to_limb_major(tab_y, "cpu")
    want = pwalk.walk_blocks_ref(bx, by, tx, ty)
    got = pwalk.walk_blocks(bx.to(dev), by.to(dev), tx.to(dev), ty.to(dev))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _k2_inputs(shape, dev):
    """(bases x, y, table x, y, level-1 bitmap) on the card: the BSGS cell's
    K2 (R = 256 bases from K1 at K = 256, U = 16,384 columns of S =
    -(2^29)G, a 2^35-bit bitmap of m = 2^28's density, 2^-7) or a small
    one (R = 70, U = 300: ragged row groups and columns, dx == 0 lanes at
    block edges; 2^20 bits, ~1/4 of them set)."""
    g = torch.Generator(device=dev).manual_seed(len(shape))
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    if shape == "cell":
        R, U, bits, ands = 256, 16384, 35, 7
        s_pt = ecref.point_neg(ecref.scalar_mult(1 << 29))
        tab_x, tab_y = tables.step_table(s_pt, U)
        adv = ecref.point_neg(ecref.scalar_mult(U << 29))
        px, py = _pts([ecref.scalar_mult(0x7CCE5EFDACCF6808)])
        bx, by, _, _, _ = pwalk.advance_chain(px.to(dev), py.to(dev), _limbs(adv[0]).to(dev),
                                              _limbs(adv[1]).to(dev), R,
                                              pwalk.adv_multiples(adv, R, dev))
    else:
        R, U, bits, ands = 70, 300, 20, 2
        tab_x, tab_y = tables.step_table(ecref.scalar_mult(7), U)
        rows = [ecref.scalar_mult(100 + 3 * r) for r in range(R)]
        for n, (r, u) in enumerate([(0, 0), (31, 127), (32, 128), (63, 255), (64, 256),
                                    (R - 1, U - 1)]):
            pt = ecref.scalar_mult(7 * (u + 1))
            rows[r] = pt if n % 2 else ecref.point_neg(pt)
        bx, by = (t.to(dev) for t in _pts(rows))
    words = rnd(1 << (bits - 5))
    for _ in range(ands - 1):
        words &= rnd(1 << (bits - 5))
    return (bx, by, pwalk.table_to_limb_major(tab_x, dev), pwalk.table_to_limb_major(tab_y, dev),
            bmp.DeviceBitmap(words, bits))


@pytest.mark.parametrize("shape", ["cell", "small"])
def test_walk_blocks_probe_matches_the_unfused_pair(dev, shape):
    """K2 with the level-1 probe plus kh_mask_compact against K2 alone plus
    kh_probe_compact, word for word, with C1 above, at and below the
    survivors (the cell's C1 = 34,816 among them): one K2 launch each; the
    fused launch's qlo, qhi, deg bit for bit K2 alone's, its mask the plain
    version's (bitmap.survivor_mask_ref); at the small shape K2 alone and
    the fused K2 also equal walk_blocks_ref's."""
    bx, by, tx, ty, bm = _k2_inputs(shape, dev)
    alone = pwalk.walk_blocks(bx, by, tx, ty)
    n0 = pwalk.walk_blocks.launches
    fused = pwalk.walk_blocks(bx, by, tx, ty, bm)
    torch.cuda.synchronize()
    assert pwalk.walk_blocks.launches == n0 + 1 and len(alone) == 3
    for a, b in zip(fused[:3], alone):
        assert torch.equal(a, b)
    qhi, qlo = alone[1].reshape(-1), alone[0].reshape(-1)
    assert torch.equal(fused[3], bmp.survivor_mask_ref(bm, alone[1], alone[0]))
    if shape == "small":
        want = pwalk.walk_blocks_ref(*(t.cpu() for t in (bx, by, tx, ty)),
                                     bmp.DeviceBitmap(bm.words.cpu(), bm.bits_log2))
        for a, b in zip(fused, want):
            assert torch.equal(a.cpu(), b)
        assert bool(alone[2].any())
    n1 = int(bmp.probe_compact(bm, qhi, qlo, 0).n)
    m0 = bmp.mask_compact.launches
    for C in sorted({n1 + 100, n1, n1 // 2, 34816}):
        got = bmp.mask_compact(fused[3], qhi, qlo, C)
        want = bmp.probe_compact(bm, qhi, qlo, C)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bmp.mask_compact.launches == m0 + len({n1 + 100, n1, n1 // 2, 34816})
    assert n1 > 0


def _curve_point(x):
    """(x, y) on the curve for an x that has one, else None."""
    y = pow(x**3 + 7, (ecref.P + 1) // 4, ecref.P)
    return (x, y) if y * y % ecref.P == (x**3 + 7) % ecref.P else None


def _plant_adversarial(tab, U):
    """[(row base, column u, what)] for K2's field arithmetic: x3 below
    2^32 + 977 (base = R - T_u, R of small x), dy = 0 (base (beta tX, tY)),
    lambda = p - 1 (the third point of the line through T_u of slope -1),
    dx = p - 1 and dx = 1 (bX = tX + 1, tX - 1 where a point has that x),
    dx = 0 (T_u, -T_u) at the first and last column of a block and of the
    table."""
    p = ecref.P
    col = lambda u: (fe.limbs_to_int(tab[0][u]), fe.limbs_to_int(tab[1][u]))
    small = next(pt for pt in map(_curve_point, range(1, 200)) if pt)
    beta = pow(3, (p - 1) // 3, p)
    plants = [(ecref.point_add(small, ecref.point_neg(col(U // 3))), U // 3, "x3_small"),
              ((beta * col(U // 5)[0] % p, col(U // 5)[1]), U // 5, "dy_0")]
    lam = p - 1
    for u in range(U):
        tx, ty = col(u)
        s = (lam * lam - tx) % p
        q = (2 * lam * lam * tx - 2 * lam * ty - tx * s) % p
        disc = (s * s - 4 * q) % p
        r = pow(disc, (p + 1) // 4, p)
        if r * r % p == disc:
            x2 = (s + r) * pow(2, p - 2, p) % p
            plants.append(((x2, (lam * (x2 - tx) + ty) % p), u, "lambda_p_1"))
            break
    for dxv, what in ((p - 1, "dx_p_1"), (1, "dx_1")):
        for u in range(U - 1, -1, -1):
            pt = _curve_point((col(u)[0] - dxv) % p)
            if pt:
                plants.append((pt, u, what))
                break
    for n, u in enumerate(sorted({0, min(127, U - 1), min(128, U - 1), U - 1})):
        plants.append((col(u) if n % 2 else ecref.point_neg(col(u)), u, "dx_0"))
    return plants


@pytest.mark.parametrize("shape", ["cell", "ragged"])
def test_walk_blocks_adversarial_columns(dev, shape):
    """K2 (with the level-1 probe) word for word against walk_blocks_ref
    (qlo, qhi, deg, the survivor mask) and against ecref at the columns
    planted by _plant_adversarial, one plant a row: at the BSGS cell's R =
    256, U = 16,384 and 2^35 bits, and at R = 70, U = 300 (ragged row groups
    and columns) with 2^20 bits. The x3 planted below 2^32 + 977 is where a
    value left unreduced would emit other low words."""
    bx, by, tx, ty, bm = _k2_inputs("cell" if shape == "cell" else "small", dev)
    R, U = bx.shape[1], tx.shape[1]
    tab = (tx.t().contiguous().cpu().numpy().view(np.uint32),
           ty.t().contiguous().cpu().numpy().view(np.uint32))
    plants = _plant_adversarial(tab, U)
    assert {w for _, _, w in plants} >= {"x3_small", "dy_0", "dx_p_1", "dx_1", "dx_0"}
    rows = list(range(1, R, max(1, R // (len(plants) + 1))))[:len(plants)]
    for r, (pt, _, _) in zip(rows, plants):
        bx[:, r] = _limbs(pt[0]).to(dev)
        by[:, r] = _limbs(pt[1]).to(dev)
    got = pwalk.walk_blocks(bx, by, tx, ty, bm)
    want = pwalk.walk_blocks_ref(bx, by, tx, ty, bm)  # plain torch on the card
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    qlo, qhi, deg = (t.cpu() for t in got[:3])
    for r, (pt, u, what) in zip(rows, plants):
        t_u = (fe.limbs_to_int(tab[0][u]), fe.limbs_to_int(tab[1][u]))
        if what == "dx_0":
            assert bool(deg[r, u])
            continue
        x3 = ecref.point_add(pt, t_u)[0]
        assert not bool(deg[r, u])
        assert (int(qlo[r, u]) & 0xFFFFFFFF, int(qhi[r, u]) & 0xFFFFFFFF) == (
            x3 & 0xFFFFFFFF, (x3 >> 32) & 0xFFFFFFFF), what
        if what == "x3_small":
            assert x3 < 2**32 + 977


def _pair_shape(shape):
    """(R, U, S, bitmap bits) of K2 at the BSGS cell's shape (256 rows of
    16,384 columns of S = -(2^29)G, the level-1 probe of 2^35 bits) or the
    baby build's (128 rows of 4,096 columns of G, no probe)."""
    if shape == "cell":
        return 256, 16384, ecref.point_neg(ecref.scalar_mult(1 << 29)), 35
    return 128, 4096, ecref.G, 0


def _paired_inputs(shape, case, dev):
    """The paired K2's inputs on the card with tests/pair_walk_model.py's
    plants for `case`, 24 rows down (across the 32-row groups): bases,
    centres and flags from K1 with its centre lanes (K = R bases of one
    target), a planted row's centre base + c*S by ecref, flagged where that
    is infinity or the base is off the curve. Returns (bases x, y, table x,
    y, bitmap or None, pairs for walk_blocks)."""
    R, U, S, bits = _pair_shape(shape)
    adv = ecref.scalar_mult(U, S)
    tab_x, tab_y = tables.step_table(S, U)
    pt = pwalk.pair_tables(S, U, adv, R, dev)
    px, py = _pts([ecref.scalar_mult(0x7CCE5EFDACCF6808)])
    bx, by, _, _, _, cx, cy, cflag = pwalk.advance_chain(
        px.to(dev), py.to(dev), _limbs(adv[0]).to(dev), _limbs(adv[1]).to(dev), R,
        pwalk.adv_multiples(adv, R, dev), pt[2:])
    tab = [(fe.limbs_to_int(x), fe.limbs_to_int(y)) for x, y in zip(tab_x, tab_y)]
    cS = ecref.scalar_mult(pair_walk_model.centre_scalar(U), S)
    for r, b in pair_walk_model.plants(case, U, tab, S).items():
        r += 24
        bx[:, r], by[:, r] = _limbs(b[0]).to(dev), _limbs(b[1]).to(dev)
        cen = ecref.point_add(b, cS) if ecref.is_on_curve(b) else None
        if cen is not None:
            cx[:, r], cy[:, r] = _limbs(cen[0]).to(dev), _limbs(cen[1]).to(dev)
        cflag[r] = cen is None
    bm = None
    if bits:
        g = torch.Generator(device=dev).manual_seed(bits)
        words = torch.randint(-2**31, 2**31, (1 << (bits - 5),), dtype=torch.int32,
                              device=dev, generator=g)
        for _ in range(6):  # m = 2^28's density, 2^-7
            words &= torch.randint(-2**31, 2**31, (1 << (bits - 5),), dtype=torch.int32,
                                   device=dev, generator=g)
        bm = bmp.DeviceBitmap(words, bits)
    return (bx, by, pwalk.table_to_limb_major(tab_x, dev), pwalk.table_to_limb_major(tab_y, dev),
            bm, (pt.pair_x, pt.pair_y, cx, cy, cflag))


@pytest.mark.parametrize("case", ["plain", "plus_minus", "pair_dx_zero", "centre", "off_curve",
                                  "fe_edges"])
@pytest.mark.parametrize("shape", ["cell", "build"])
def test_walk_pairs_kernel_rare_lanes(dev, shape, case):
    """The paired K2 word for word against walk_blocks_ref (qlo, qhi, deg and,
    at the cell's shape, the survivor mask of the level-1 probe), with the
    rare lanes planted (pair_walk_model.plants): base = +-tab_u at both
    columns of a pair and at a block's first and last pair, a pair with dx
    == 0 on each side, base = +-c*S, bases off the curve, x3 below 2^32 +
    977 and dy == 0; one launch."""
    bx, by, tx, ty, bm, pairs = _paired_inputs(shape, case, dev)
    n0 = pwalk.walk_blocks.launches
    got = pwalk.walk_blocks(bx, by, tx, ty, bm, pairs)
    torch.cuda.synchronize()
    assert pwalk.walk_blocks.launches == n0 + 1
    want = pwalk.walk_blocks_ref(bx, by, tx, ty, bm)  # plain torch on the card
    assert len(got) == len(want) == (3 if bm is None else 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if case == "plus_minus":
        assert int(got[2].sum()) == 12


@pytest.mark.parametrize("U,T,K", [(16384, 1, 256), (16384, 2, 64), (4096, 1, 128),
                                   (300, 1, 16)])
def test_chunk_walks_pairs_where_the_shape_allows(dev, U, T, K):
    """chunk_multi with the engine's pair tables: the paired walk at U =
    16,384 (the cell's K2, with the probe, and T = 2's row layout) and 4,096
    (the build's), a point a thread at U = 300 (pair_tables is None there);
    either way every output equals today's kernel's, word for word."""
    S = ecref.point_neg(ecref.scalar_mult(1 << 29))
    adv = ecref.scalar_mult(U, S)
    tab_x, tab_y = tables.step_table(S, U)
    tx, ty = pwalk.table_to_limb_major(tab_x, dev), pwalk.table_to_limb_major(tab_y, dev)
    px, py = (t.t().contiguous().to(dev) for t in _pts(
        [ecref.scalar_mult(0x5EED0000 + 977 * t) for t in range(T)]))
    pt = pwalk.pair_tables(S, U, adv, K, dev)
    assert (pt is not None) == (U % 64 == 0)
    g = torch.Generator(device=dev).manual_seed(U)
    words = torch.randint(-2**31, 2**31, (1 << 15,), dtype=torch.int32, device=dev, generator=g)
    bm = bmp.DeviceBitmap(words & torch.randint(-2**31, 2**31, (1 << 15,), dtype=torch.int32,
                                                device=dev, generator=g), 20)
    args = (px, py, tx, ty, _limbs(adv[0]).to(dev), _limbs(adv[1]).to(dev))
    tab = pwalk.adv_multiples(adv, K, dev)
    got = pwalk.chunk_multi(*args, K=K, U=U, T=T, adv_tab=tab, bitmap=bm, pair_tab=pt)
    want = pwalk.chunk_multi(*args, K=K, U=U, T=T, adv_tab=tab, bitmap=bm)
    torch.cuda.synchronize()
    assert got.paired == (pt is not None) and not want.paired
    for a, b in zip(got[:7], want[:7]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,K", [(1, 256), (3, 7), (2, 300), (4, 16), (130, 16)])
def test_advance_chain_centre_lanes(dev, T, K):
    """K1 with the centre lanes against its plain version, all eight outputs
    word for word, and every unflagged centre against base_s + c*S by
    ecref; planted: P = -ctab_s (the centre at infinity), P = -j*ADV (base j
    at infinity), P = ctab_s (a doubling centre) and P off the curve (every
    row flagged), one tile and several; the bases as without the centres."""
    U = 16384
    S = ecref.point_neg(ecref.scalar_mult(1 << 29))
    adv = ecref.scalar_mult(U, S)
    ctab = pwalk.centre_offsets(S, U, adv, K, "cpu")
    col = lambda j: (fe.limbs_to_int(ctab[0][:, j].numpy().view(np.uint32)),
                     fe.limbs_to_int(ctab[1][:, j].numpy().view(np.uint32)))
    pts = [ecref.scalar_mult(0xC0FFEE + 7919 * t) for t in range(T)]
    off = ecref.scalar_mult(4242)
    plants = {}  # target: (P, its flagged rows); a later plant takes a shared target
    plants[min(1, T - 1)] = ((off[0], (off[1] + 1) % ecref.P), set(range(K)))
    plants[T // 2] = (col(0), set())
    plants[T - 1] = (ecref.scalar_mult((K // 2) * U << 29), {K // 2})  # P = -(K/2)*ADV
    plants[0] = (ecref.point_neg(col(K - 1)), {K - 1})
    for t, (p, _) in plants.items():
        pts[t] = p
    px, py = _pts(pts)
    args = (px, py, _limbs(adv[0]), _limbs(adv[1]))
    tab = pwalk.adv_multiples(adv, K, "cpu")
    want = pwalk.advance_chain_ref(*args, K, tab, ctab)
    n0 = pwalk.advance_chain.launches
    got = pwalk.advance_chain(*(a.to(dev) for a in args), K, tuple(t.to(dev) for t in tab),
                              tuple(t.to(dev) for t in ctab))
    torch.cuda.synchronize()
    assert pwalk.advance_chain.launches == n0 + 1 and len(got) == 8
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got[:5], pwalk.advance_chain(*(a.to(dev) for a in args), K,
                                                 tuple(t.to(dev) for t in tab))):
        assert torch.equal(g, w)
    bx, by, _, _, _, cx, cy, cflag = (t.cpu() for t in got)
    flags = {(t, s) for t in range(T) for s in range(K) if cflag[t * K + s]}
    assert flags == {(t, s) for t, (_, rows) in plants.items() for s in rows}
    cS = ecref.scalar_mult(pair_walk_model.centre_scalar(U), S)
    pt = lambda x, y, c: (fe.limbs_to_int(x[:, c].numpy().view(np.uint32)),
                          fe.limbs_to_int(y[:, c].numpy().view(np.uint32)))
    for t in range(T):
        for s in range(K):
            if (t, s) not in flags:
                assert pt(cx, cy, t * K + s) == ecref.point_add(pt(bx, by, t * K + s), cS)


def test_device_chunk_paired_matches_cpu_and_counts(dev):
    """test_device_chunk_cuda_matches_cpu's chunk (U = 4096, K = 8, T = 3, a
    dx == 0 lane and a P == -ADV advance planted) with the engine's pair
    tables, so K2 walks pairs, equals the CPU's chunk word for word; a
    search on the card counts every chunk it dispatched in
    paired_walk_chunks, as probe_fused_chunks does (the planted advance
    rebases the walk: more than it decodes), and the CPU's search none."""
    from keyhuntm1cpu_tpu_torch.core.metrics import get_metrics

    U, K, m, a = 4096, 8, 1 << 12, 0xA00000

    def center(step, u):
        return a + m + (step * U + u - 1) * 2 * m

    ks = [a + 12345, center(1, 5), center(K - 1, U)]
    pubs = [ecref.scalar_mult(k) for k in ks]
    params = bsgs.BSGSParams(m=m, block_u=U, steps_per_chunk=K, build_block=128,
                             bits_log2=20, cascade2="on")
    got = bsgs.BSGSEngine(pubs, a, a + 4 * K * U * 2 * m, params, device=dev)
    want = bsgs.BSGSEngine(pubs, a, a + 4 * K * U * 2 * m, params, device="cpu")
    assert got.pair_tab is not None and want.pair_tab is None
    outs = []
    for eng in (got, want):
        px, py = eng._initial_base(0)
        outs.append(bsgs.chunk_impl(px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y,
                                    eng.bitmap, eng.table, eng.bloom2, U=U, K=K, T=3,
                                    C1=eng.C1, C2=eng.C2, adv_tab=eng.adv_tab,
                                    pair_tab=eng.pair_tab))
    torch.cuda.synchronize()
    for g, w in zip(*outs):
        assert torch.equal(g.cpu(), w)
    for eng, paired in ((got, True), (want, False)):
        found = sorted(f.private_key for f in eng.search(stop_on_first=False))
        assert found == ks
        rec = get_metrics().last_call("search")
        n, fused = (rec["counters"].get(k, 0) for k in ("paired_walk_chunks",
                                                        "probe_fused_chunks"))
        assert n == (fused if paired else 0) and fused >= rec["chunks_decoded"] > 0


@pytest.mark.parametrize("rows,U", [(255, 32), (256, 32), (257, 32), (1, 20), (170, 48),
                                    (513, 16)])
def test_mask_compact_kernel_tile_edges(dev, rows, U):
    """kh_mask_compact against mask_compact_ref at mask words one below, at
    and one above its 256-word tile (rows of one word), one ragged word,
    170 rows of two words (48 columns) and 513 rows of a half word; ~1/4 of
    the live bits set, the ragged ones clear (as K2 writes them); C past,
    at and below the survivors, and 0."""
    g = torch.Generator(device=dev).manual_seed(rows * U)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    W = -(-U // 32)
    live = torch.tensor([(1 << min(32, U - 32 * w)) - 1 for w in range(W)],
                        dtype=torch.int64, device=dev)
    mask = fe.i32(fe.u32(rnd(rows * W) & rnd(rows * W)).reshape(rows, W) & live)
    qhi, qlo = rnd(rows * U), rnd(rows * U)
    n = int(bmp.mask_compact_ref(mask, qhi, qlo, 0).n)
    for C in (n + 3, n, n // 2, 0):
        got = bmp.mask_compact(mask, qhi, qlo, C)
        want = bmp.mask_compact_ref(mask, qhi, qlo, C)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert _scratch_clean()


@pytest.mark.parametrize("resolve", ["device", "host"])
def test_fused_chunk_matches_the_unfused_composition(dev, resolve):
    """A chunk through chunk_impl(_host) (K1, K2 with the probe, the mask
    compaction, the bloom2 stage, the summary: five launches, no
    kh_probe_compact) equals the same chunk composed with K2 alone and
    kh_probe_compact, word for word, at m = 2^12, U = 4096, K = 8, T = 3,
    a key planted in the chunk."""
    from keyhuntm1cpu_tpu_torch import _build

    U, K, m, a = 4096, 8, 1 << 12, 0xA00000
    ks = [a + 12345, a + m + (U + 4) * 2 * m, a + 7 * m + 5]
    params = bsgs.BSGSParams(m=m, block_u=U, steps_per_chunk=K, build_block=128,
                             bits_log2=20, cascade2="on", resolve=resolve)
    eng = bsgs.BSGSEngine([ecref.scalar_mult(k) for k in ks], a, a + 4 * K * U * 2 * m, params,
                          device=dev)
    px, py = eng._initial_base(0)
    shape = dict(U=U, K=K, T=3, C1=eng.C1, C2=eng.C2, adv_tab=eng.adv_tab)
    consts = (px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, eng.bitmap)
    before = _build.launch_counts()
    if resolve == "host":
        got = bsgs.chunk_impl_host(*consts, eng.bloom2, **shape)
    else:
        got = bsgs.chunk_impl(*consts, eng.table, eng.bloom2, **shape)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    summary = "chunk_summary_host" if resolve == "host" else "chunk_summary"
    assert launched == dict.fromkeys(("advance_chain", "walk_blocks", "mask_compact",
                                      "bloom2_compact", summary), 1)
    res, deg, adv = bsgs._chunk_walk(px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, U, K,
                                     3, eng.adv_tab)
    qhi, qlo = res.qhi.reshape(-1), res.qlo.reshape(-1)
    fs = bmp.filtered_survivors(eng.bitmap, qhi, qlo, eng.C2, bm2=eng.bloom2,
                                stage1_max=eng.C1)
    if resolve == "host":
        want = bsgs.chunk_summary_host(*fs, deg, adv, (deg, adv))
    else:
        want = bsgs.chunk_summary(eng.table, *fs, deg, adv, (deg, adv))
    for g, w in zip(got, (res.next_x, res.next_y, want)):
        assert torch.equal(g, w)
    assert int((got[2][: eng.C2] < 3 * K * U).sum()) >= 1  # the planted key's match


@pytest.mark.parametrize("bits,b2bits", [(24, 22), (35, 33)])
def test_insert_keys_kernel_matches_plain(dev, bits, b2bits):
    rng = np.random.default_rng(7)
    n = 1 << 20
    qhi = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    qlo = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    n_keep = n - 77777  # the streaming build's last step keeps a prefix
    w1, w2 = bmp.empty_filter(bits, dev), bmp.empty_filter(b2bits, dev)
    r1, r2 = w1.clone(), w2.clone()
    n0 = bmp.insert_keys.launches
    bmp.insert_keys(w1, bits, w2, b2bits, qhi, qlo, n_keep)
    bmp.insert_keys_ref(r1, bits, r2, b2bits, qhi, qlo, n_keep)
    torch.cuda.synchronize()
    assert bmp.insert_keys.launches == n0 + 1
    assert torch.equal(w1, r1) and torch.equal(w2, r2)


@pytest.mark.parametrize("form", ["bitmap_only", "bad_counter", "bad_no_keys", "ragged"])
def test_insert_keys_kernel_forms_match_plain(dev, form):
    """K3's other forms against its plain version: the bitmap alone (a
    brute target set, duplicates included, 2^34 bits), the degeneracy
    counter with degenerate lanes planted inside and past the kept prefix
    and at warp edges, the counter with no key kept (the advance flags
    alone), and a key count that is not a multiple of a warp."""
    rng = np.random.default_rng(len(form))
    n = {"ragged": 1000003}.get(form, 1 << 19)
    hi = rng.integers(-2**31, 2**31, n).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, n).astype(np.int32)
    hi[-100:], lo[-100:] = hi[:100], lo[:100]  # duplicate keys
    qhi, qlo = torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)
    bits, b2bits = (34, 0) if form == "bitmap_only" else (24, 23)
    n_keep = {"bad_counter": n - 4097, "bad_no_keys": 0}.get(form, n)
    w1 = bmp.empty_filter(bits, dev)
    w2 = None if form == "bitmap_only" else bmp.empty_filter(b2bits, dev)
    flags = ()
    if form.startswith("bad"):
        deg = np.zeros(n, bool)
        deg[[0, 31, 32, 63, 1000, n_keep - 1, n_keep, n - 1]] = True
        deg[rng.choice(n, 300, replace=False)] = True
        adeg = rng.random(128) < 0.1
        flags = (torch.from_numpy(deg).to(dev), torch.from_numpy(adeg).to(dev),
                 torch.full((), 3, dtype=torch.int64, device=dev))
    want = [t.clone() for t in (w1, w2) + flags[2:] if t is not None]
    bmp.insert_keys(w1, bits, w2, b2bits, qhi, qlo, n_keep, *flags)
    bmp.insert_keys_ref(want[0], bits, want[1] if w2 is not None else None, b2bits, qhi, qlo,
                        n_keep, *flags[:2], *want[2:])
    torch.cuda.synchronize()
    got = [t for t in (w1, w2) + flags[2:] if t is not None]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if flags:
        assert int(flags[2]) == 3 + int(deg[:n_keep].sum()) + int(adeg.sum())
    if form == "bitmap_only":
        ts_hi, ts_lo = hi.view(np.uint32), lo.view(np.uint32)
        host = bmp.build_bitmap(ts_hi, ts_lo, bits)  # the host build on the CPU
        card = bmp.build_bitmap(ts_hi, ts_lo, bits, dev)
        torch.cuda.synchronize()
        assert torch.equal(card.words, w1) and torch.equal(card.words.cpu(), host.words)


def test_engine_cuda_matches_cpu(dev, tmp_path):
    ks = [0xA12345, 0xA54321, 0xAFEDCB]
    pubs = [ecref.scalar_mult(k) for k in ks]
    params = bsgs.BSGSParams(m=1 << 12, block_u=256, steps_per_chunk=8,
                             build_block=128, bits_log2=24, bloom2_bits=17,
                             resolve="host", table_cache=str(tmp_path))
    got = bsgs.BSGSEngine(pubs, 0xA00000, 0xB00000, params, device=dev)
    want = bsgs.BSGSEngine(pubs, 0xA00000, 0xB00000, params, device="cpu",
                           host_table=got.host_table)
    assert torch.equal(got.bitmap.words.cpu(), want.bitmap.words)
    assert torch.equal(got.bloom2.words.cpu(), want.bloom2.words)
    found = sorted(f.private_key for f in got.search(stop_on_first=False))
    assert found == sorted(ks)


@pytest.mark.parametrize("b2bits", [16, 32, 33])
def test_insert_keys_kernel_bloom2_only_matches_plain(dev, b2bits):
    """K3's bloom-only form (a device table's bloom2, 2^32 bits at m = 2^28)
    against its plain version and the bloom of the two-filter form."""
    rng = np.random.default_rng(b2bits)
    n = 1 << 20
    qhi = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    qlo = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    w2, r2, both = (bmp.empty_filter(b2bits, dev) for _ in range(3))
    n0 = bmp.insert_keys.launches
    bmp.insert_keys(None, 0, w2, b2bits, qhi, qlo, n - 5)
    assert bmp.insert_keys.launches == n0 + 1
    bmp.insert_keys_ref(None, 0, r2, b2bits, qhi, qlo, n - 5)
    bmp.insert_keys(bmp.empty_filter(20, dev), 20, both, b2bits, qhi, qlo, n - 5)
    torch.cuda.synchronize()
    assert torch.equal(w2, r2) and torch.equal(w2, both)


def test_baby_table_cuda_matches_cpu(dev):
    """The device-resolve table built on the card (native seed, K1/K2 walk
    in 4 steps with a kept prefix, one stable sort) equals the CPU build at
    m = 2^16, and so do the bitmap and bloom2 K3 builds from it."""
    params = bsgs.BSGSParams(m=1 << 16, block_u=256, steps_per_chunk=8, build_block=128)
    got = bsgs.BSGSEngine([ecref.G], 1, 2, params, device=dev)
    want = bsgs.BSGSEngine([ecref.G], 1, 2, params, device="cpu")
    torch.cuda.synchronize()
    assert torch.equal(got.table.key.cpu(), want.table.key)
    assert torch.equal(got.table.idx.cpu(), want.table.idx)
    assert torch.equal(got.bitmap.words.cpu(), want.bitmap.words)
    b2, b2_cpu = bmp.build_bloom2_device(got.table), bmp.build_bloom2_device(want.table)
    assert torch.equal(b2.words.cpu(), b2_cpu.words)


@pytest.mark.parametrize("ones", [False, True], ids=["bloom2", "all_pass_overflow"])
def test_device_chunk_cuda_matches_cpu(dev, ones):
    """One device-resolve chunk (K1, K2, the fused probe, the bloom2 stage,
    the exact search, the summary) on the card equals the same chunk on the
    CPU at m = 2^12, U = 4096, K = 8, T = 3 (a dx == 0 lane and a P == -ADV
    advance planted), and the engines find the same keys."""
    U, K, m, a = 4096, 8, 1 << 12, 0xA00000

    def center(step, u):
        return a + m + (step * U + u - 1) * 2 * m

    ks = [a + 12345, center(1, 5), center(K - 1, U)]
    pubs = [ecref.scalar_mult(k) for k in ks]
    params = bsgs.BSGSParams(m=m, block_u=U, steps_per_chunk=K, build_block=128,
                             bits_log2=20, cascade2="on")
    got = bsgs.BSGSEngine(pubs, a, a + 4 * K * U * 2 * m, params, device=dev)
    want = bsgs.BSGSEngine(pubs, a, a + 4 * K * U * 2 * m, params, device="cpu")
    filters = [got.bitmap, got.bloom2, want.bitmap, want.bloom2]
    C1, C2 = got.C1, got.C2
    if ones:
        filters = [f._replace(words=torch.full_like(f.words, -1)) for f in filters]
        C1, C2 = 1024, 256
    outs = []
    for eng, (bm, b2) in ((got, filters[:2]), (want, filters[2:])):
        px, py = eng._initial_base(0)
        outs.append(bsgs.chunk_impl(px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, bm,
                                    eng.table, b2, U=U, K=K, T=3, C1=C1, C2=C2,
                                    adv_tab=eng.adv_tab))
    torch.cuda.synchronize()
    for g, w in zip(*outs):
        assert torch.equal(g.cpu(), w)
    if not ones:
        f_got = sorted(f.private_key for f in got.search(stop_on_first=False))
        assert f_got == sorted(f.private_key for f in want.search(stop_on_first=False)) == ks


def _artifact(mode, pt):
    if mode == "xpoint":
        return pt[0].to_bytes(32, "big")
    if mode == "eth":
        return hashref.pubkey_to_eth_address(pt)
    return hashref.pubkey_to_hash160(pt, compressed=mode == "rmd160")


def _cmp64(mode, raw):
    return (int.from_bytes(raw, "big") & ((1 << 64) - 1) if mode == "xpoint"
            else int.from_bytes(raw[:8], "big"))


@pytest.mark.parametrize("mode,n_endo,bucketed", [
    (m, 1, False) for m in pbrute.MODES] + [
    ("rmd160", 3, False), ("xpoint", 3, False), ("rmd160", 1, True), ("xpoint", 3, True)])
def test_brute_walk_kernel_matches_plain(dev, mode, n_endo, bucketed):
    K, U = 37, 1000  # K not a multiple of the row group, U not of 128
    tab_x, tab_y = tables.step_table(ecref.G, U)
    b0 = 1 << 40
    rows = [ecref.scalar_mult(b0 + s * U) for s in range(K)]
    rows[2] = ecref.scalar_mult(5)  # dx == 0 at u = 4
    rows[30] = ecref.point_neg(ecref.scalar_mult(6))  # dx == 0 at u = 5
    bx, by = _pts(rows)
    keys = [b0 + 1, b0 + 9 * U + 500, b0 + 36 * U + U]
    vals = [_cmp64(mode, _artifact(mode, ecref.scalar_mult(k))) for k in keys]
    vals.append(_cmp64(mode, _artifact(
        mode, ecref.scalar_mult(ecref.LAMBDA * (b0 + 4 * U + 7) % ecref.N))))
    rng = np.random.default_rng(5)
    vals += [int(v) for v in rng.integers(0, 2**63, 600 if bucketed else 20)]
    if bucketed:
        tgt = pbrute.pack_intervals([1], [0])
        btab = pbrute.pack_buckets(vals)
    else:
        tgt, btab = pbrute.pack_intervals(vals, vals), np.zeros((8, 128), np.uint32)
    args = [bx, by, pwalk.table_to_limb_major(tab_x, "cpu"),
            pwalk.table_to_limb_major(tab_y, "cpu"),
            torch.from_numpy(tgt.view(np.int32)), torch.from_numpy(btab.view(np.int32))]
    tb = btab.shape[0] if bucketed else 0
    want = pbrute.brute_walk_blocks_ref(*args, mode, n_endo, tb)
    n0 = pbrute.brute_walk_blocks.launches
    got = pbrute.brute_walk_blocks(*(a.to(dev) for a in args), mode, n_endo, tb)
    torch.cuda.synchronize()
    assert pbrute.brute_walk_blocks.launches == n0 + 1
    assert torch.equal(got.cpu(), want)
    assert int(want[2, 4]) == pbrute.HIT_DEGENERATE and int(want[30, 5]) == pbrute.HIT_DEGENERATE
    assert int(want[0, 0]) and int(want[9, 499]) and int(want[36, U - 1])


@pytest.mark.parametrize("K", [33, 65])
@pytest.mark.parametrize("mode,n_endo", [("rmd160", 1), ("xpoint", 1), ("eth", 1),
                                         ("xpoint", 3)])
def test_brute_walk_kernel_ragged_blocks(dev, mode, n_endo, K):
    """K4 at K past a multiple of its row group (33 rows: one ragged group
    of 64 or a group of 32 and one row; 65 rows: one row past 64) and
    U = 1000 (the last block of columns 488 wide at 512 threads, 104 at
    128), with dx == 0 lanes at the edges of row groups and column blocks:
    every thread of a block reaches the shared inversion, and a
    degenerate or idle lane enters it as 1."""
    U = 1000
    tab_x, tab_y = tables.step_table(ecref.G, U)
    b0 = 1 << 41
    rows = [ecref.scalar_mult(b0 + s * U) for s in range(K)]
    # row s = (u + 1)*G or its negation: dx == 0 at column u (first and last
    # rows of row groups, first and last columns of column blocks)
    plants = ([(0, 0), (27, 896), (30, 511), (31, 127), (32, 999)] if K == 33 else
              [(0, 0), (31, 127), (32, 128), (40, 511), (41, 512), (63, 255), (64, 999)])
    for s, u in plants:
        pt = ecref.scalar_mult(u + 1)
        rows[s] = pt if s % 2 else ecref.point_neg(pt)
    bx, by = _pts(rows)
    hit_at = [(1, 0), (2, 128), (K - 4, 999)]  # key(s, u) = b0 + s*U + u + 1
    keys = [b0 + s * U + u + 1 for s, u in hit_at]
    vals = [_cmp64(mode, _artifact(mode, ecref.scalar_mult(k))) for k in keys]
    vals += [int(v) for v in np.random.default_rng(K).integers(0, 2**63, 13)]
    tgt = pbrute.pack_intervals(vals, vals)
    args = [bx, by, pwalk.table_to_limb_major(tab_x, "cpu"),
            pwalk.table_to_limb_major(tab_y, "cpu"), torch.from_numpy(tgt.view(np.int32)),
            torch.zeros((8, 128), dtype=torch.int32)]
    args = [a.to(dev) for a in args]
    want = pbrute.brute_walk_blocks_ref(*args, mode, n_endo, 0).cpu()  # on the card: fast
    got = pbrute.brute_walk_blocks(*args, mode, n_endo, 0)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert all(int(want[s, u]) == pbrute.HIT_DEGENERATE for s, u in plants)
    assert all(int(want[s, u]) for s, u in hit_at)


@pytest.mark.parametrize("shape", [(16, 256, 64), (8, 384, 300), (256, 16384, 1024)],
                         ids=["K16_U256_C64", "K8_U384_C300", "K256_U16384_C1024"])
@pytest.mark.parametrize("case", CASES)
def test_compact_hits_kernel_matches_plain(dev, case, shape):
    K, U, C = shape
    hits, adeg = make_case(case, K, U, C, seed=CASES.index(case))
    th, ta = torch.from_numpy(hits.view(np.int32)), torch.from_numpy(adeg)
    want = pbrute.compact_hits_ref(th, ta, C)
    n0 = pbrute.compact_hits.launches
    gh, ga = th.to(dev), ta.to(dev)
    # 1, 2 and 3 launches in a row: each finds its ticket zeroed by the one before
    got = [pbrute.compact_hits(gh, ga, C) for _ in range(3)]
    torch.cuda.synchronize()
    assert pbrute.compact_hits.launches == n0 + 3
    for g in got:
        assert torch.equal(g.cpu(), want)
    assert _scratch_clean()


def test_compact_hits_two_streams_beside_probe_compact(dev):
    """kh_compact_hits on every case of tests/brute_compact_cases.py (the
    row overflow included) at K = 16, U = 256, C = 64, 300 launches taking
    turns on two streams, each stream's launches interleaved with
    kh_probe_compact's (the two kernels keep separate scratch pairs, each
    a stream); every result equal to its plain version's, every next
    scratch clean after."""
    K, U, C = 16, 256, 64
    cases = []
    for i, case in enumerate(CASES):
        hits, adeg = make_case(case, K, U, C, seed=i)
        th, ta = torch.from_numpy(hits.view(np.int32)), torch.from_numpy(adeg)
        cases.append((th.to(dev), ta.to(dev), pbrute.compact_hits_ref(th, ta, C)))
    g = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    bm = bmp.DeviceBitmap(rnd(1 << 15) & rnd(1 << 15), 20)
    q = (rnd(1025), rnd(1025))
    want_p = bmp.probe_compact_ref(bm, *q, 256)
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize()
    n0 = pbrute.compact_hits.launches
    runs, probes = [], []
    for i in range(300):
        with torch.cuda.stream(streams[i % 2]):
            h, a, want = cases[i % len(cases)]
            runs.append((pbrute.compact_hits(h, a, C), want))
            if i % 3 == 1:
                probes.append(bmp.probe_compact(bm, *q, 256))
    torch.cuda.synchronize()
    assert pbrute.compact_hits.launches == n0 + 300
    for got, want in runs:
        assert torch.equal(got.cpu(), want)
    for got in probes:
        for a, b in zip(got, want_p):
            assert torch.equal(a, b)
    assert _scratch_clean()


@pytest.mark.parametrize("mode", ["rmd160", "eth"])
def test_brute_engine_cuda_matches_cpu(dev, mode):
    keys = list(range(1, 33))
    kind = "eth" if mode == "eth" else "hash160"
    ts = TargetSet(kind=kind, raw=[_artifact(mode, ecref.scalar_mult(k)) for k in keys],
                   labels=[str(k) for k in keys])
    params = brute.BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64)
    got = brute.BruteEngine(ts, 1, 4097, mode=mode, params=params, device=dev).search()
    want = brute.BruteEngine(ts, 1, 4097, mode=mode, params=params, device="cpu").search()
    assert sorted(f.private_key for f in got) == sorted(f.private_key for f in want) == keys


CUSTOM = minikeys._B58[29:] + minikeys._B58[:29]


def _minikey_bases():
    eng = minikeys.MinikeyEngine(TargetSet(kind="hash160", raw=[b"\x01" * 20], labels=["t"]),
                                 prefix="SkeyhuntCUDA", device="cpu")
    return eng._base_words("SkeyhuntCUDA11112")


@pytest.mark.parametrize("alphabet", [minikeys._B58, CUSTOM], ids=["canonical", "custom"])
def test_minikey_valid_and_keys_kernels_match_plain(dev, alphabet):
    B, base = 3 * 1024, 58 ** 5 - 3 * 1024  # the last block of the counter span
    w22, w23 = _minikey_bases()
    want = pminikey.minikey_valid_ref(base, w23, B, alphabet)
    n0 = pminikey.minikey_valid.launches
    got = pminikey.minikey_valid(base, w23.to(dev), B, alphabet)
    torch.cuda.synchronize()
    assert pminikey.minikey_valid.launches == n0 + 1
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 0
    V = 37
    want_k = pminikey.compact_keys_ref(want, V, base, w22, B, alphabet)
    got_k = pminikey.compact_keys(got, V, base, w22.to(dev), B, alphabet)
    torch.cuda.synchronize()
    for g, w in zip(got_k, want_k):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", ["tile_edge", "none_valid", "past_V", "dense_rounds",
                                  "ragged_B", "unaligned", "main_shape"])
def test_compact_keys_kernel_matches_plain(dev, case):
    """kh_minikey_compact_keys against compact_keys_ref: valid lanes on both
    sides of tile edges, no valid lane (every slot a fill slot), more
    valid lanes than V, a dense mask (many rounds of hashing within a
    tile), B not a multiple of the tile, a mask not 16-byte aligned (the
    byte loads), and the main path's B = 2^23, V = 34,816; each launched
    twice (the scratch is zeroed per launch)."""
    tile = pminikey._tile()
    rng = np.random.default_rng(len(case))
    B = {"ragged_B": 2 * tile + 12345, "main_shape": 1 << 23,
         "dense_rounds": 3 * tile + 5}.get(case, 4 * tile)
    valid = rng.random(B + 1) < 1 / 256
    if case == "tile_edge":
        for e in range(tile, B, tile):
            valid[[e - 1, e, e + 1]] = True
    if case == "none_valid":
        valid[:] = False
    if case == "dense_rounds":
        valid[:] = True
        valid[rng.choice(B, B // 3, replace=False)] = False
    mask = torch.from_numpy(valid).to(dev)
    mask = mask[1:] if case == "unaligned" else mask[:B]
    n = int(mask.sum())
    V = {"past_V": n // 2, "dense_rounds": 3000, "none_valid": 999,
         "main_shape": minikeys.valid_budget(B)}.get(case, n + 100)
    w22, _ = _minikey_bases()
    base = 58 ** 5 - B - 10
    want = pminikey.compact_keys_ref(mask.cpu(), V, base, w22, B, minikeys._B58)
    n0 = pminikey.compact_keys.launches
    for _ in range(2):
        got = pminikey.compact_keys(mask, V, base, w22.to(dev), B, minikeys._B58)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert pminikey.compact_keys.launches == n0 + 2
    assert int(got[0]) == n and (n > V) == (case in ("past_V", "dense_rounds"))


def test_scalar_mult_and_hash_kernels_match_plain(dev):
    rng = np.random.default_rng(12)
    ks = [0, 1, 2, ecref.N - 1, ecref.N, 2 ** 256 - 1,
          0x00FF00000000FF000000000000AB0000000000CD0000000000000000000100]
    ks += [int.from_bytes(rng.bytes(32), "big") for _ in range(37 - len(ks))]
    k = torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in ks]).T.copy().view(np.int32))
    gtx, gty = pladder.gtable_tensors("cpu")
    want = pladder.scalar_mult_split_ref(k, gtx, gty, pladder.SPLIT)
    n0 = pladder.scalar_mult_tiles.launches
    got = pladder.scalar_mult_tiles(k.to(dev), gtx.to(dev), gty.to(dev))
    torch.cuda.synchronize()
    assert pladder.scalar_mult_tiles.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want[2][0]) and bool(want[3][4])  # k = 0: infinity; k = N: irregular
    x, y = want[0], want[1]
    for g, w in zip(phash.hash160_x2_from_batch(x.to(dev)), phash.hash160_x2_ref(x)):
        assert torch.equal(g[0].cpu(), w[0]) and torch.equal(g[1].cpu(), w[1])
    for g, w in zip(phash.hash160_u_from_batch(x.to(dev), y.to(dev)), phash.hash160_u_ref(x, y)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("V", [300, 1000])
def test_scalar_mult_kernel_shapes_match_split_ref(dev, V):
    """K6 at V not a multiple of its inversion group (128 scalars) equal to
    its plain version in its own order, k = 0 and k = N planted."""
    rng = np.random.default_rng(V)
    ks = [int.from_bytes(rng.bytes(32), "big") for _ in range(V)]
    ks[0], ks[V // 2], ks[-1] = 0, ecref.N, 2 ** 256 - 1
    k = torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in ks]).T.copy().view(np.int32))
    gtx, gty = pladder.gtable_tensors("cpu")
    want = pladder.scalar_mult_split_ref(k, gtx, gty, pladder.SPLIT)
    got = pladder.scalar_mult_tiles(k.to(dev), gtx.to(dev), gty.to(dev))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want[2][0]) and bool(want[3][V // 2])


def test_minikey_engine_cuda_matches_cpu(dev):
    prefix = "SkeyhuntCUDA"
    c = 0
    while True:
        s = prefix + minikeys._b58_digits(0, 5) + minikeys._b58_digits(c, 5)
        if hashref.sha256((s + "?").encode())[0] == 0:
            break
        c += 1
    key = int.from_bytes(hashref.sha256(s.encode()), "big")
    ts = TargetSet(kind="hash160", raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(key), False)],
                   labels=["planted"])
    params = minikeys.MinikeyParams(batch=4096, valid_max=128)
    got = minikeys.MinikeyEngine(ts, prefix=prefix, params=params, device=dev).search(max_chunks=2)
    want = minikeys.MinikeyEngine(ts, prefix=prefix, params=params, device="cpu").search(
        max_chunks=2)
    assert [f.private_key for f in got] == [f.private_key for f in want] == [key]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1025, 65536])
def test_inv_batch_kernel_matches_plain(dev, n):
    """pinv (one thread a column, fixed-count divsteps) at widths around a
    warp and the walker step's 1,025, zeros planted at warp and block
    edges (0 -> 0), every column equal to the plain version."""
    rng = np.random.default_rng(21 + n)
    vals = [int.from_bytes(rng.bytes(32), "big") % fe.P_INT for _ in range(n)]
    for j in (0, 31, 32, 127, 128, 500, 1024, n - 1):
        if j < n and j != 3:
            vals[j] = 0
    if n > 3:
        vals[3] = 1
    a = torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in vals]).T.copy().view(np.int32))
    n0 = pinv.inv_batch.launches
    got = pinv.inv_batch(a.to(dev))
    torch.cuda.synchronize()
    assert pinv.inv_batch.launches == n0 + 1
    assert torch.equal(got.cpu(), pinv.inv_batch_ref(a.to(dev)).cpu())
    g = got.cpu().numpy().view(np.uint32)
    for j in range(min(n, 40)):
        want = pow(vals[j], fe.P_INT - 2, fe.P_INT) if vals[j] else 0
        assert fe.limbs_to_int(g[:, j]) == want


def test_keccak_eth_kernel_matches_plain(dev):
    xs, ys = tables.step_table(ecref.scalar_mult(0xE7E7), 1000)
    x = torch.from_numpy(np.ascontiguousarray(xs.T).view(np.int32))
    y = torch.from_numpy(np.ascontiguousarray(ys.T).view(np.int32))
    n0 = phash.keccak_eth_from_batch.launches
    got = phash.keccak_eth_from_batch(x.to(dev), y.to(dev))
    torch.cuda.synchronize()
    assert phash.keccak_eth_from_batch.launches == n0 + 1
    for g, w in zip(got, phash.keccak_eth_ref(x, y)):
        assert torch.equal(g.cpu(), w)
    d = hashref.pubkey_to_eth_address(ecref.scalar_mult(0xE7E7))
    assert int(got[0][0]) & 0xFFFFFFFF == int.from_bytes(d[0:4], "little")


@pytest.mark.parametrize("bits", [20, 32, 35])
def test_probe_kernels_match_plain(dev, bits):
    rng = np.random.default_rng(bits)
    n = 100003
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    qhi, qlo = (torch.from_numpy(v.view(np.int32)).to(dev) for v in (hi, lo))
    words = bmp.empty_filter(bits, dev)
    n_keep = int(0.3 * n)
    bmp.insert_keys(words, bits, words, bits, qhi, qlo, n_keep)  # members in both forms
    n1, n2 = bmp.probe.launches, bmp.probe_bloom2.launches
    got1 = bmp.probe(bmp.DeviceBitmap(words, bits), qhi, qlo)
    got2 = bmp.probe_bloom2(bmp.DeviceBloom2(words, bits), qhi, qlo)
    torch.cuda.synchronize()
    assert (bmp.probe.launches, bmp.probe_bloom2.launches) == (n1 + 1, n2 + 1)
    assert torch.equal(got1, bmp.probe_ref(bmp.DeviceBitmap(words, bits), qhi, qlo))
    assert torch.equal(got2, bmp.probe_bloom2_ref(bmp.DeviceBloom2(words, bits), qhi, qlo))
    assert bool(got1[:n_keep].all()) and bool(got2[:n_keep].all())


@pytest.mark.parametrize("regime", ["below", "at", "past"])
@pytest.mark.parametrize("B", [1, 255, 131088, 4194304])
def test_probe_compact_kernel_matches_plain(dev, B, regime):
    """The fused probe + ordered compaction against probe_compact_ref:
    survivors below, at and past the budget C; B = 255 from unaligned
    views (the kernel's scalar key loads), B = 4,194,304 against a 2^35-bit
    filter (the BSGS level-1 shape); one probe launch a call."""
    bits = 35 if B == 4194304 else 24
    g = torch.Generator(device=dev).manual_seed(B)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    words = rnd(1 << (bits - 5)) & rnd(1 << (bits - 5)) & rnd(1 << (bits - 5))  # density 1/8
    bm = bmp.DeviceBitmap(words, bits)
    off = 1 if B == 255 else 0
    qhi, qlo = rnd(B + off)[off:], rnd(B + off)[off:]
    n = int(bmp.probe_compact_ref(bm, qhi, qlo, 0).n)
    C = {"below": n + 100, "at": n, "past": n // 2}[regime]
    launches = bmp.probe.launches
    got = bmp.probe_compact(bm, qhi, qlo, C)
    torch.cuda.synchronize()
    assert bmp.probe.launches == launches + 1
    want = bmp.probe_compact_ref(bm, qhi, qlo, C)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got.n) == n


@pytest.mark.parametrize("shape", ["host", "device", "ragged"])
@pytest.mark.parametrize("case", bsgs_cascade_cases.STAGE_CASES)
def test_bloom2_compact_kernel_matches_plain(dev, case, shape):
    """kh_bloom2_compact against bloom2_compact_ref: the main path's C1 =
    34,816 stage-1 survivors of B = 4,194,304 queries compacted to C2 =
    1,536 against a 2^35-bit (host resolve's) and a 2^32-bit (a device
    table's) bloom2 of density 1/4 (about 1/16 pass: padding at half a
    stage 1, a C2 overflow at a full one); C1 = 1,000 from unaligned views
    (the scalar loads); one launch a call."""
    C1, C2, B, bits = {"host": (34816, 1536, 4194304, 35), "device": (34816, 1536, 4194304, 32),
                       "ragged": (1000, 100, 5000, 20)}[shape]
    g = torch.Generator(device=dev).manual_seed(C1 + bits)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    b2 = bmp.DeviceBloom2(rnd(1 << (bits - 5)) & rnd(1 << (bits - 5)), bits)
    pos1, qh1, ql1, n1 = bsgs_cascade_cases.stage1(case, C1, B)
    off = 1 if shape == "ragged" else 0
    on_dev = lambda a: torch.from_numpy(np.concatenate([a[:off], a]).view(np.int32)).to(dev)[off:]
    stage1 = bmp.ProbeCompact(on_dev(pos1), on_dev(qh1), on_dev(ql1),
                              torch.tensor(n1, dtype=torch.int32, device=dev))
    launches = bmp.bloom2_compact.launches
    got = bmp.bloom2_compact(b2, stage1, B, C2)
    torch.cuda.synchronize()
    assert bmp.bloom2_compact.launches == launches + 1
    want = bmp.bloom2_compact_ref(b2, stage1, B, C2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n2 = int(want.n)
    assert (n2 == 0) == (case == "none")
    if shape != "ragged":  # ~1,088 survivors of half a stage 1, ~2,176 of a full one
        assert (n2 > C2) == (case in ("full", "over"))


@pytest.mark.parametrize("edge", list(bsgs_cascade_cases.TILE_EDGES))
def test_bloom2_compact_kernel_tile_edges(dev, edge):
    """kh_bloom2_compact against bloom2_compact_ref at C1 one below, at and
    one above a tile boundary and in a single tile, into C2 = C1 and into
    C2 = 64 (an overflow)."""
    g = torch.Generator(device=dev).manual_seed(7)
    bits = 20
    b2 = bmp.DeviceBloom2(torch.randint(-2**31, 2**31, (1 << (bits - 5),), dtype=torch.int32,
                                        device=dev, generator=g), bits)
    B = 5000
    pos1, qh1, ql1, n1 = bsgs_cascade_cases.edge_stage1(edge, B)
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)
    stage1 = bmp.ProbeCompact(t(pos1), t(qh1), t(ql1),
                              torch.tensor(n1, dtype=torch.int32, device=dev))
    for C2 in (pos1.shape[0], 64):
        got = bmp.bloom2_compact(b2, stage1, B, C2)
        want = bmp.bloom2_compact_ref(b2, stage1, B, C2)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert 0 < int(want.n) < n1


def _scratch_clean():
    """Every stream's next scratch is clean (the last launch cleared it):
    the probe's all zero, the brute compaction's ticket zero."""
    return (all(int(buf[turn].abs().sum()) == 0 for buf, turn in bmp._COMPACT.pairs.values())
            and all(int(buf[turn][0]) == 0 for buf, turn in pbrute._COMPACT.pairs.values()))


def test_compact_scratch_reuse_two_streams(dev):
    """1,000 launches back to back on the compact kernels' scratches,
    taking turns on two streams (each stream's own pair, reused launch
    after launch with no memset): the bloom2 stage at C1 between tile
    boundaries (255 to 513 and 34,816) and, every fifth launch, the level-1
    form at B around its tile (1,023 to 1,025); each result equal to the
    plain version's, and every stream's next scratch zero at the end."""
    g = torch.Generator(device=dev).manual_seed(9)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    b2 = bmp.DeviceBloom2(rnd(1 << 15), 20)
    bm = bmp.DeviceBitmap(rnd(1 << 15) & rnd(1 << 15), 20)
    B = 40000
    stages, level1 = [], []
    for C1 in (255, 256, 257, 511, 512, 513, 34816):
        pos = torch.sort(torch.randperm(B, device=dev, generator=g)[:C1]).values.int()
        s1 = bmp.ProbeCompact(pos, rnd(C1), rnd(C1),
                              torch.tensor(C1, dtype=torch.int32, device=dev))
        stages.append((s1, bmp.bloom2_compact_ref(b2, s1, B, C1 // 3)))
    for n in (1023, 1024, 1025):
        q = (rnd(n), rnd(n))
        level1.append((q, bmp.probe_compact_ref(bm, *q, n // 4)))
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize()
    launches = bmp.bloom2_compact.launches + bmp.probe.launches
    runs = []
    for i in range(1000):
        with torch.cuda.stream(streams[i % 2]):
            if i % 5 == 4:
                q, want = level1[i % len(level1)]
                runs.append((bmp.probe_compact(bm, *q, want.pos.shape[0]), want))
            else:
                s1, want = stages[i % len(stages)]
                runs.append((bmp.bloom2_compact(b2, s1, B, want.pos.shape[0]), want))
    torch.cuda.synchronize()
    assert bmp.bloom2_compact.launches + bmp.probe.launches == launches + 1000
    for got, want in runs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert _scratch_clean()


@pytest.mark.parametrize("resolve", ["device", "host"])
@pytest.mark.parametrize("shape", list(bsgs_cascade_cases.SUMMARY_SHAPES))
def test_chunk_summary_kernel_shapes(dev, shape, resolve):
    """kh_bsgs_summary against chunk_summary_ref at the row role's edges
    (R not a multiple of the rows a block takes, U = 1,000, U = 1, rows
    one byte past an aligned start) over a 1,000-key table."""
    R, U, C = bsgs_cascade_cases.SUMMARY_SHAPES[shape]
    keys, idx = bsgs_cascade_cases.table_keys(1000)
    table = st.build_sorted_table((keys >> np.uint64(32)).astype(np.uint32),
                                  keys.astype(np.uint32), idx, device=dev)
    deg, adv = bsgs_cascade_cases.flags("mixed", R, U)
    hits = np.concatenate([keys[:-2:5], keys[-1:]])  # the last one duplicated: found2
    pos, qhi, qlo, n = bsgs_cascade_cases.survivors("mixed", C, deg, adv, hits)
    t = lambda a: torch.from_numpy(np.asarray(a).view(np.int32) if np.asarray(a).dtype
                                   == np.uint32 else np.asarray(a)).to(dev)
    off = 1 if shape == "unaligned" else 0
    buf = torch.zeros((R * U + off,), dtype=torch.bool, device=dev)
    tdeg = buf[off:].view(R, U)
    tdeg.copy_(t(deg))
    tadv = t(adv)
    cand = (t(pos), t(qhi), t(qlo), torch.tensor(n, dtype=torch.int32, device=dev))
    tab = table if resolve == "device" else None
    fn = bsgs.chunk_summary_host if tab is None else (lambda *a: bsgs.chunk_summary(table, *a))
    got = fn(*cand, tdeg, tadv, (tdeg, tadv))
    want = bsgs.chunk_summary_ref(tab, *cand, tdeg, tadv, (tdeg, tadv))
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def main_table(dev):
    """A 2^28-key sorted table on the card (its last key twice: found2) and
    4,097 of its keys as uint64 (the duplicated one last)."""
    m = 1 << 28
    g = torch.Generator(device=dev).manual_seed(28)
    half = lambda: torch.randint(-2**31, 2**31, (m,), dtype=torch.int32, device=dev,
                                 generator=g).to(torch.int64)
    key = torch.sort((half() << 32) | (half() & 0xFFFFFFFF)).values
    key[-1] = key[-2]
    pick = torch.cat([torch.randint(0, m - 2, (4096,), device=dev, generator=g),
                      torch.tensor([m - 1], device=dev)])
    hits = key[pick].cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)
    table = st.SortedXTable(key, torch.arange(1, m + 1, dtype=torch.int32, device=dev))
    yield table, hits
    del table, key
    torch.cuda.empty_cache()


@pytest.mark.parametrize("form", ["device", "host", "no_rows", "no_candidates", "small"])
@pytest.mark.parametrize("case", bsgs_cascade_cases.SUMMARY_CASES)
def test_chunk_summary_kernel_matches_plain(dev, main_table, case, form):
    """kh_bsgs_summary against chunk_summary_ref at the main path's C2 =
    1,536 survivors over T*K = 256 rows of U = 16,384 lanes and a 2^28-key
    table, in device and host resolve; the ring's two forms (no rows; no
    candidates, written into the tail of a row); and at U = 1,000 (rows not
    16-byte aligned) with a 1-key table; one launch a call."""
    R, U, C = (12, 1000, 300) if form == "small" else (256, 16384, 1536)
    table, hits = main_table
    if form == "small":
        table = st.SortedXTable(table.key[-1:].clone(), table.idx[-1:].clone())
        hits = hits[-1:]
    deg, adv = bsgs_cascade_cases.flags(case, R, U)
    pos, qhi, qlo, n = bsgs_cascade_cases.survivors(case, C, deg, adv, hits)
    t = lambda a: torch.from_numpy(np.asarray(a).view(np.int32) if np.asarray(a).dtype
                                   == np.uint32 else np.asarray(a)).to(dev)
    tdeg, tadv = t(deg), t(adv)
    cand = (t(pos), t(qhi), t(qlo), torch.tensor(n, dtype=torch.int32, device=dev))
    rows, tab = (tdeg, tadv), table
    if form == "host":
        tab = None
    elif form == "no_rows":
        rows = None
    elif form == "no_candidates":
        cand = tuple(x[:0] for x in cand[:3]) + cand[3:]
    fn = bsgs.chunk_summary_host if tab is None else (lambda *a, **k: bsgs.chunk_summary(
        table, *a, **k))
    counter = bsgs.chunk_summary_host if tab is None else bsgs.chunk_summary
    launches = counter.launches
    got = fn(*cand, tdeg, tadv, rows)
    width = got.shape[0]
    out = torch.full((width + 5,), -7, dtype=torch.int32, device=dev)
    fn(*cand, tdeg, tadv, rows, out=out[5:])
    torch.cuda.synchronize()
    assert counter.launches == launches + 2
    want = bsgs.chunk_summary_ref(tab, *cand, tdeg, tadv, rows)
    assert torch.equal(got, want) and torch.equal(out[5:], want) and (out[:5] == -7).all()
    assert torch.equal(tdeg.cpu(), torch.from_numpy(deg))
    if form == "device" and case == "mixed":
        w = want.cpu().numpy()
        assert (w[:C] < R * U).any() and (w[2 * C: 3 * C] > 0).any()


@pytest.mark.parametrize("W,U,L", [(7, 1000, 32), (3, 64, 7)])
def test_walk_kernels_match_plain(dev, W, U, L):
    stride = 5
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(stride), U)
    adv_k = (2 * U + 1) * stride
    keys = [adv_k, ecref.N - adv_k, stride * 9, ecref.N - stride * 2, 10 ** 9, 77, 123456]
    c = point_batch_from_ints([ecref.scalar_mult(k) for k in keys[:W]])
    adv = ecref.scalar_mult(adv_k)
    cpu = (c.x, c.y, pwalk.table_to_limb_major(tab_x, "cpu"),
           pwalk.table_to_limb_major(tab_y, "cpu"), _limbs(adv[0]), _limbs(adv[1]))
    gpu = tuple(t.to(dev) for t in cpu)
    n0, n1, n2 = walk.walk_prefix.launches, walk.walk_emit.launches, pinv.inv_batch.launches
    pre, tot = walk.walk_prefix(*gpu, L)
    want_pre, want_tot = walk.walk_prefix_ref(*cpu, L)
    torch.cuda.synchronize()
    assert torch.equal(pre.cpu(), want_pre) and torch.equal(tot.cpu(), want_tot)
    inv_tot = pinv.inv_batch(tot)
    for n_endo, need_y in ((1, False), (3, True)):
        got = walk.walk_emit(*gpu, pre, inv_tot, L, n_endo, need_y)
        want = walk.walk_emit_ref(*cpu, want_pre, inv_tot.cpu(), L, n_endo, need_y)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None) and (g is None or torch.equal(g.cpu(), w))
    assert (walk.walk_prefix.launches, walk.walk_emit.launches) == (n0 + 1, n1 + 2)
    assert pinv.inv_batch.launches == n2 + 1
    res = walk.walk_fused(type(c)(*gpu[:2], None), *gpu[2:], need_y=True, chain_len=L)
    ref = walk.walk_fused(type(c)(*cpu[:2], None), *cpu[2:], need_y=True, chain_len=L)
    torch.cuda.synchronize()
    for g, w in zip(res, ref):
        assert torch.equal(g.cpu(), w)
    assert ref.adv_degenerate.tolist()[:3] == [False, True, False][:W]
    assert bool(ref.degenerate[2, 8]) if W > 2 else True


@pytest.mark.parametrize("L", [7, 32, 33, 64])
def test_walk_emit_kernel_chain_lengths(dev, L):
    """walk_emit (a warp per chain, segments of 32 from the top) at chain
    lengths below, at, just past and twice one segment, need_y off and on,
    n_endo = 3, equal to its plain version."""
    W, U, stride = 3, 500, 3
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(stride), U)
    adv_k = (2 * U + 1) * stride
    c = point_batch_from_ints([ecref.scalar_mult(k) for k in (adv_k, stride * 4, 10 ** 12)])
    adv = ecref.scalar_mult(adv_k)
    cpu = (c.x, c.y, pwalk.table_to_limb_major(tab_x, "cpu"),
           pwalk.table_to_limb_major(tab_y, "cpu"), _limbs(adv[0]), _limbs(adv[1]))
    gpu = tuple(t.to(dev) for t in cpu)
    pre, tot = walk.walk_prefix_ref(*cpu, L)
    inv_tot = pinv.inv_batch_ref(tot)
    for need_y in (False, True):
        got = walk.walk_emit(*gpu, pre.to(dev), inv_tot.to(dev), L, 3, need_y)
        want = walk.walk_emit_ref(*cpu, pre, inv_tot, L, 3, need_y)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None) and (g is None or torch.equal(g.cpu(), w))
    assert bool(want[2][1, 3]) and not bool(want[5][0])  # dx == 0 at u = 4; C == ADV doubles


@pytest.mark.parametrize("L", [7, 32, 33, 64, 65])
def test_walk_prefix_kernel_chain_lengths(dev, L):
    """walk_prefix (a warp per chain, segments of 32 from the bottom) at
    chain lengths below, at, just past and twice one segment, and past
    two; W*(U+2) = 535 is no multiple of L and the chain count C (77, 17,
    17, 9, 9) no multiple of a block's 4 warps. Centers at ADV (the
    advance lane's product), -ADV and 9S (dx == 0 at u = 9)."""
    W, U, stride = 5, 105, 7
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(stride), U)
    adv_k = (2 * U + 1) * stride
    keys = [adv_k, ecref.N - adv_k, 9 * stride, 10 ** 15, 31337]
    c = point_batch_from_ints([ecref.scalar_mult(k) for k in keys])
    adv = ecref.scalar_mult(adv_k)
    cpu = (c.x, c.y, pwalk.table_to_limb_major(tab_x, "cpu"),
           pwalk.table_to_limb_major(tab_y, "cpu"), _limbs(adv[0]), _limbs(adv[1]))
    C = walk.n_chains(W, U, L)
    assert (W * (U + 2)) % L and C % 4
    n0 = walk.walk_prefix.launches
    pre, tot = walk.walk_prefix(*(t.to(dev) for t in cpu), L)
    want_pre, want_tot = walk.walk_prefix_ref(*cpu, L)
    torch.cuda.synchronize()
    assert walk.walk_prefix.launches == n0 + 1
    assert torch.equal(pre.cpu(), want_pre) and torch.equal(tot.cpu(), want_tot)


@pytest.mark.parametrize("case", walker_lookup_cases.CASES + ["smoke"])
def test_lookup_summary_kernel_matches_plain(dev, case):
    """kh_lookup_summary against lookup_summary_ref on the cases of
    tests/walker_lookup_cases.py (found2, a key above the table, m = 1,
    padding, degenerate hits, a walker without flags, overflow, more
    walkers and survivors than the block's warps and threads) and at
    chip_smoke.py's shape (C = 256, W = 8, U = 4096, 2^22 keys), both
    into a fresh row and into a row of a summary."""
    d = walker_lookup_cases.make_case(case)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())
    table = st.build_sorted_table(d["hi"], d["lo"], d["idx"])
    cpu = (torch.from_numpy(d["pos"]), i32(d["qhi"]), i32(d["qlo"]),
           torch.tensor(d["n"], dtype=torch.int32), torch.from_numpy(d["deg"]),
           torch.from_numpy(d["adeg"]))
    want = st.lookup_summary_ref(table, *cpu, d["total"])
    gtab = st.SortedXTable(table.key.to(dev), table.idx.to(dev))
    gpu = tuple(t.to(dev) for t in cpu)
    n0 = st.lookup_summary.launches
    got = st.lookup_summary(gtab, *gpu, d["total"])
    out = torch.full((3, want.shape[0]), -1, dtype=torch.int32, device=dev)
    st.lookup_summary(gtab, *gpu, d["total"], out=out[1])
    torch.cuda.synchronize()
    assert st.lookup_summary.launches == n0 + 2
    assert torch.equal(got.cpu(), want) and torch.equal(out[1].cpu(), want)
    assert (out[0] == -1).all() and (out[2] == -1).all()
    assert torch.equal(st.lookup_summary_ref(gtab, *gpu, d["total"]).cpu(), want)


@pytest.mark.parametrize("mode", ["rmd160", "eth", "xpoint"])
def test_brute_walker_engine_cuda_matches_cpu(dev, mode):
    keys = list(range(1, 33))
    kind = {"eth": "eth", "xpoint": "xpoint"}.get(mode, "hash160")
    ts = TargetSet(kind=kind, raw=[_artifact(mode, ecref.scalar_mult(k)) for k in keys],
                   labels=[str(k) for k in keys])
    params = brute.BruteParams(walkers=2, block_u=200, steps_per_chunk=3, chain_len=16,
                               compare_max=0, bucket_max=0, endo=mode == "xpoint")
    got = brute.BruteEngine(ts, 1, 4097, mode=mode, params=params, device=dev)
    want = brute.BruteEngine(ts, 1, 4097, mode=mode, params=params, device="cpu")
    assert got._walker and want._walker
    c = got._centers_for_bases(got._sequential_bases(0))
    n0, n1 = walk.walk_emit.launches, st.lookup_summary.launches
    gx, gy, gs = got._walker_chunk(c.x, c.y)
    wx, wy, ws = want._walker_chunk(c.x.cpu(), c.y.cpu())
    torch.cuda.synchronize()
    assert (walk.walk_emit.launches, st.lookup_summary.launches) == (n0 + 3, n1 + 3)
    assert torch.equal(gs.cpu(), ws) and torch.equal(gx.cpu(), wx) and torch.equal(gy.cpu(), wy)
    found = sorted(f.private_key for f in got.search())
    assert found == sorted(f.private_key for f in want.search()) == keys


def test_scalar_mult_points_on_a_side_stream_match_ecref(dev):
    """The engines' batched host check: K6 on a stream of its own, edge
    scalars (0, N, N - 1) among 41-bit and 256-bit keys."""
    gx, gy = pladder.gtable_tensors(dev)
    ks = [0, 1, ecref.N - 1, ecref.N, (1 << 40) + 12345, (1 << 255) + 7, 0xFF00FF]
    with torch.cuda.stream(torch.cuda.Stream(dev, priority=-1)):
        got = pladder.scalar_mult_points(ks, gx, gy)
    assert got == [ecref.scalar_mult(k) if k % ecref.N else None for k in ks]


def test_vanity_engine_cuda_matches_cpu(dev):
    """Key 777's prefix beside keys 1..32 over [1, 4097): the interval hits
    checked through the K6 batch on the card, by ecref on the CPU."""
    from keyhuntm1cpu_tpu_torch.engine.vanity import vanity_intervals

    prefix = hashref.pubkey_to_address(ecref.scalar_mult(777))[:5]
    keys = list(range(1, 33))
    ts = TargetSet(kind="hash160", raw=[_artifact("rmd160", ecref.scalar_mult(k)) for k in keys],
                   labels=[str(k) for k in keys])
    params = brute.BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64)
    kw = dict(mode="rmd160", params=params, intervals=vanity_intervals(prefix),
              prefixes=[prefix])
    n0 = pladder.scalar_mult_tiles.launches
    got = brute.BruteEngine(ts, 1, 4097, device=dev, **kw).search()
    assert pladder.scalar_mult_tiles.launches > n0
    want = brute.BruteEngine(ts, 1, 4097, device="cpu", **kw).search()
    assert sorted((f.private_key, f.target) for f in got) == sorted(
        (f.private_key, f.target) for f in want)
    assert set(keys) | {777} <= {f.private_key for f in got}


@pytest.mark.parametrize("policy", ["sequential", "backward", "both", "random", "dance"])
def test_search_scheduled_cuda_matches_cpu(dev, tmp_path, policy):
    """Every range order on the card finds what the CPU engine finds and
    covers the same keys; the host-table bases equal _initial_base."""
    ks = [0xA12345, 0xAFEDCB, 0xBF1234, 0x11F0000]
    pubs = [ecref.scalar_mult(k) for k in ks]
    params = bsgs.BSGSParams(m=1 << 12, block_u=64, steps_per_chunk=2, build_block=128,
                             bits_log2=24, bloom2_bits=17, resolve="host",
                             table_cache=str(tmp_path))
    got = bsgs.BSGSEngine(pubs, 0xA00000, 0x1200000, params, device=dev)
    want = bsgs.BSGSEngine(pubs, 0xA00000, 0x1200000, params, device="cpu",
                           host_table=got.host_table)
    assert len(got.chunk_order()) == 8
    bases = got._scheduled_bases(list(range(8)))
    for c in range(8):
        wx, wy = want._initial_base(c * 2)
        assert torch.equal(bases[c][0].cpu(), wx) and torch.equal(bases[c][1].cpu(), wy)
    f_got = got.search_scheduled(policy, seed=5, stop_on_first=False)
    f_want = want.search_scheduled(policy, seed=5, stop_on_first=False)
    assert sorted(f.private_key for f in f_got) == sorted(f.private_key for f in f_want) == ks
    assert got.stats.keys_covered == want.stats.keys_covered


def test_baby_x_bytes_by_k6_equal_the_host_walk(dev):
    """utils/legacy.baby_x_bytes on the card (K6 in batches of
    X32_BATCH, rows assembled on the card) equals the host walk at m = 2^12,
    and at a batch width that leaves a partial last batch."""
    from keyhuntm1cpu_tpu_torch.utils import legacy

    m = 1 << 12
    before = pladder.scalar_mult_tiles.launches
    got = legacy.baby_x_bytes(m, dev)
    assert pladder.scalar_mult_tiles.launches == before + 1
    want = legacy.baby_x_bytes(m, "cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(legacy.x32_by_ladder(m, dev, batch=1000), want)


def test_kernels_launch_on_the_tensors_device(dev):
    """K1 and the fused probe on cuda:1 while cuda:0 is current: the
    launch makes the tensors' device current (their stream and pointers
    belong to it), and the results equal the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    advk, K = 1000, 64
    adv = ecref.scalar_mult(advk)
    px, py = _pts([ecref.scalar_mult(777 * i + 5) for i in range(16)])
    args = (px, py, _limbs(adv[0]), _limbs(adv[1]))
    g = torch.Generator().manual_seed(1)
    words = torch.randint(-2**31, 2**31, (1 << 19,), dtype=torch.int32, generator=g)
    qhi, qlo = (torch.randint(-2**31, 2**31, (100003,), dtype=torch.int32, generator=g)
                for _ in range(2))
    bm = bmp.DeviceBitmap(words, 24)
    with torch.cuda.device(0):
        got = pwalk.advance_chain(*(a.to(d1) for a in args), K)
        bm1 = bmp.DeviceBitmap(words.to(d1), 24)
        pc = bmp.probe_compact(bm1, qhi.to(d1), qlo.to(d1), 4096)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(d1)
    for a, b in zip(got, pwalk.advance_chain_ref(*args, K)):
        assert a.device == d1 and torch.equal(a.cpu(), b)
    for a, b in zip(pc, bmp.probe_compact_ref(bm, qhi, qlo, 4096)):
        assert a.device == d1 and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("engine", ["range", "table-all_gather", "table-ring", "brute"])
def test_sharded_engines_cuda_match_cpu(dev, engine):
    """The sharded engines over 4 shards (distinct cards where there are
    several, else cuda:0 four times) find what they find on 4 CPU shards."""
    import dataclasses

    from keyhuntm1cpu_tpu_torch.parallel import (ShardedBruteEngine, ShardedBSGSEngine,
                                                 ShardedTableBSGSEngine, default_devices)

    cards = default_devices("cuda", 4)
    cpus = [torch.device("cpu")] * 4
    found = {}
    if engine == "brute":
        keys = [0x90000 + 100, 0x90000 + 8192 + 5, 0x90000 + 3 * 4096 + 4000]
        ts = TargetSet(kind="hash160", raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(k))
                                            for k in keys], labels=[hex(k) for k in keys])
        bp = brute.BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64)
        for name, devs in (("cuda", cards), ("cpu", cpus)):
            eng = ShardedBruteEngine(ts, 0x90000, 0x90000 + (1 << 14), params=bp, devices=devs)
            found[name] = sorted(f.private_key for f in eng.search_sharded())
    else:
        p = bsgs.BSGSParams(m=512, block_u=16, steps_per_chunk=8, build_block=128,
                            table_comm=engine.split("-")[-1])
        a = 0x500000
        keys = [a + 123, a + 2**18 + 777, a + 2**19 - 5]
        pubs = [ecref.scalar_mult(k) for k in keys]
        cls = ShardedBSGSEngine if engine == "range" else ShardedTableBSGSEngine
        for name, devs in (("cuda", cards), ("cpu", cpus)):
            table = bsgs.build_baby_table(p.m, p.build_block, devs[0])
            eng = cls(pubs, a, a + 2**19, dataclasses.replace(p), table=table, devices=devs)
            found[name] = sorted(f.private_key for f in eng.search_sharded(stop_on_first=False))
    assert found["cuda"] == found["cpu"] == sorted(keys)
