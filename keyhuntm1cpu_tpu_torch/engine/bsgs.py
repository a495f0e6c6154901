"""Baby-Step Giant-Step engine on PyTorch + CUDA, in both resolve modes.

Port of keyhuntm1cpu_tpu/engine/bsgs.py, with its five range orders and
position checkpoints (``search_scheduled``). Index algebra is the JAX
package's:

- stride = 2m. Centers c_i = a + m + i*stride tile the range [a, b).
- The baby keys are trunc64(x(j*G)), j = 1..m. Where the exact table
  lives is ``BSGSParams.resolve``:
  - "device" (the default, as in the JAX package): the sorted table
    (key -> j, filter/sorted_table.py) is built on the card by the same
    K1/K2 walk as the filter build and one stable device sort
    (``build_baby_table``), or loaded from a table file (``load_table``);
    a direct-address bitmap over it (K3) and, when the expected level-1
    survivors call for it (``cascade2``), a k=2 hashed bloom ("bloom2",
    shared by every engine over the same table, ``_bloom2_for_table``);
  - "host": the card keeps only the bitmap and the bloom2, streamed from
    the walk by K3 without m-sized planes; the exact table lives on the
    host (filter/host_table.py, built by the native library).
- Giant walk: P(t, i) = Q_t - c_i*G. One chunk walks K steps of U centers
  for all T targets (curve/pwalk.py: advance chain K1 + walk blocks K2,
  which probes the level-1 bitmap as it emits the keys), runs the rest of
  the cascade (filter/bitmap.py) and returns ONE int32 summary of
  3*C2 + 3*T*K + 1 words: survivor positions, then (device) their baby
  indices j at the table's lower bound and its successor, or (host) their
  64-bit keys, the per-row degenerate summary and the (poisoned) survivor
  count.
- The host takes j from the summary (device) or resolves the survivors'
  keys with np.searchsorted (host), verifies k = c +- j exactly with
  ref/ecref, and rescans a step exactly when the cascade overflowed or
  the walk state became invalid.

Every giant step covers `stride` keys, so keys/s = steps/s * U * stride.
Targets ride K1's lanes, any number of them: a chunk holds T*K*U query
words, so K shrinks past CHUNK_WORD_CAP / (T*U).

Range orders (``chunk_order``: sequential, backward, both, random, dance)
permute the chunks of K steps; every order runs engine/pipeline.py's loop
by the one base rule of ``_BSGSPlan``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..core.checkpoint import fingerprint
from ..core.log import get_logger
from ..core.metrics import count, current_call, span, spanned
from ..curve import pwalk
from ..field import fe
from ..filter import bitmap as bmp
from ..filter import host_table as ht
from ..filter import sorted_table as st
from ..ref import ecref
from . import pipeline
from .common import FoundKey, SearchStats, verify_candidate_scalar

BUILD_BLOCKS = 128  # baby blocks of build_block keys per streaming-build step
CHUNK_WORD_CAP = 1 << 27  # bound on T*K*U query words per chunk


def resolve_m(m_babies: "int | None" = None, n_value: "int | None" = None,
              k_factor: int = 1) -> int:
    """Reference BSGS table sizing: m = sqrt(N)*k, N defaulting to 2^44 and
    required to be a perfect square; an explicit m_babies overrides."""
    if m_babies is not None:
        return m_babies
    n_val = n_value if n_value is not None else (1 << 44)
    r = math.isqrt(n_val)
    if r * r != n_val:
        raise ValueError(
            f"-n value 0x{n_val:x} must have an exact integer square root"
        )
    return r * max(1, k_factor)


@dataclass(frozen=True)
class BSGSParams:
    """keyhuntm1cpu_tpu's BSGSParams without its TPU knobs (pallas,
    pallas_sb, chain_len, probe_mode, cand_max)."""

    m: int = 1 << 20  # baby steps
    block_u: int = 1024  # giant centers per device step (U)
    steps_per_chunk: int = 16  # K: device steps per chunk
    build_block: int = 4096  # baby keys per walk row in the table and filter builds
    chunk_cand_max: int = 1024  # floor of the cascade budgets C1, C2
    bits_log2: Optional[int] = None  # bitmap size (None: see _filter_sizes)
    cascade2: str = "auto"  # device resolve: the bloom2 stage "auto" (expected
    # level-1 survivors a chunk > 1024), "on" or "off"
    pipeline_depth: int = 8  # chunks in flight ahead of host decode
    resolve: str = "device"  # "device": the sorted table on the card;
    # "host": the card holds the two filters, the host the exact table
    bloom2_bits: Optional[int] = None  # host-resolve bloom2 size (None: see _filter_sizes)
    table_cache: Optional[str] = None  # host-table cache dir override
    table_comm: str = "all_gather"  # ShardedTableBSGSEngine's schedule: every
    # prober probes all D shards' queries at once ("all_gather"), or one
    # shard's block a hop for D hops ("ring")


_BLOOM2_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_BLOOM2_LOCK = threading.Lock()


def _bloom2_for_table(table: st.SortedXTable) -> bmp.DeviceBloom2:
    """The bloom2 of a device table, built once (bsgs._bloom2_for_table):
    an LRU of two keyed by the identity of the table's key tensor, which
    it holds, so the id is not reused while the entry lives. Locked: the
    server's handler threads build engines over one resident table
    concurrently."""
    k = id(table.key)
    with _BLOOM2_LOCK:
        ent = _BLOOM2_CACHE.get(k)
        if ent is not None and ent[0] is table.key:
            _BLOOM2_CACHE.move_to_end(k)  # LRU: the resident table stays
            return ent[1]
    with span("table_build"):
        b2 = bmp.build_bloom2_device(table)
    with _BLOOM2_LOCK:
        _BLOOM2_CACHE[k] = (table.key, b2)
        while len(_BLOOM2_CACHE) > 2:
            _BLOOM2_CACHE.popitem(last=False)
    return b2


def filter_build_step(px, py, walk, words1, bits_log2: int, words2, b2bits: int,
                      n_keep: int, bad):
    """One step of the streaming filter build: K1 and K2 walk K*ub baby keys
    from the base (px, py) ((1, 8) limbs) by the walk's tables (walk, a
    pwalk.WalkTables of K = walk.K steps of ub = walk.U keys); K3 ORs the
    first n_keep into both filters and adds the kept lanes' degenerate flags
    and the advance flags to `bad` (a () int64 tensor). Three device
    operations. Returns the next base."""
    res = _walk_step(px, py, walk)
    bmp.insert_keys(words1, bits_log2, words2, b2bits, res.qhi.reshape(-1),
                    res.qlo.reshape(-1), n_keep, res.degenerate.reshape(-1),
                    res.adv_degenerate.reshape(-1), bad)
    return res.next_x, res.next_y


_ImmediateHit = pipeline.BaseIsKey


def _limbs(v: int, device) -> torch.Tensor:
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32)).to(device)


def _jac_madd(X1: int, Y1: int, Z1: int, x2: int, y2: int):
    """Jacobian (X1, Y1, Z1) + affine (x2, y2) over F_p (madd-2007-bl; Z1
    == 0 is the point at infinity). None where h == 0 (a doubling or a sum
    at infinity), which the caller settles with ecref."""
    P = ecref.P
    if Z1 == 0:
        return x2, y2, 1
    z1z1 = Z1 * Z1 % P
    h = (x2 * z1z1 - X1) % P
    if h == 0:
        return None
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    r = 2 * (y2 * Z1 * z1z1 - Y1) % P
    v = X1 * i % P
    X3 = (r * r - j - 2 * v) % P
    return X3, (r * (v - X3) - 2 * Y1 * j) % P, ((Z1 + h) ** 2 - z1z1 - hh) % P


def _batch_inv(vals: Sequence[int]) -> List[int]:
    """Inverses mod p of non-zero vals with one exponentiation (Montgomery)."""
    P = ecref.P
    pre, acc = [], 1
    for v in vals:
        acc = acc * v % P
        pre.append(acc)
    inv = pow(acc, -1, P) if vals else 1
    out = [0] * len(vals)
    for n in range(len(vals) - 1, -1, -1):
        out[n] = inv * pre[n - 1] % P if n else inv
        inv = inv * vals[n] % P
    return out


def _chunk_walk(px, py, tab_x, tab_y, adv_x, adv_y, U: int, K: int, T: int, adv_tab,
                bitmap=None, pair_tab=None):
    """K1 + K2 of a chunk: (walk result, its (T*K, U) degenerate flags, the
    (T*K,) advance flags). An advance flag marks lane U - 1 of its row too
    (ADV = U*S = tab[U-1]): the summary kernel folds it in. Given the
    level-1 bitmap, K2 probes the keys too (the result's survivor_mask);
    given the pair tables (pwalk.pair_tables), K2 walks pairs on the card,
    counted in paired_walk_chunks."""
    res = pwalk.chunk_multi(px, py, tab_x, tab_y, adv_x, adv_y, K=K, U=U, T=T,
                            adv_tab=adv_tab, bitmap=bitmap, pair_tab=pair_tab)
    if res.paired:
        count("paired_walk_chunks")
    return res, res.degenerate, res.adv_degenerate.reshape(-1)


def _chunk_cascade(px, py, tab_x, tab_y, adv_x, adv_y, bitmap, bloom2, U, K, T, C1, C2,
                   adv_tab, pair_tab):
    """The walk and the cascade of a chunk: K1, K2 with the level-1 probe,
    the compaction of its survivor mask, the bloom2 stage (without bloom2:
    the mask compacted to C2). Counted in probe_fused_chunks. Returns
    (walk result, survivors, degenerate flags, advance flags)."""
    res, deg, adv_flat = _chunk_walk(px, py, tab_x, tab_y, adv_x, adv_y, U, K, T, adv_tab,
                                     bitmap, pair_tab)
    fs = bmp.filtered_survivors(bitmap, res.qhi.reshape(-1), res.qlo.reshape(-1), C2,
                                bm2=bloom2, stage1_max=C1, mask=res.survivor_mask)
    count("probe_fused_chunks")
    return res, fs, deg, adv_flat


def chunk_summary_ref(table, pos, qhi, qlo, n, deg, adv, rows) -> torch.Tensor:
    """Plain torch version of the summary kernel (see chunk_summary; table
    None: chunk_summary_host): the lane U - 1 fix-up, the live mask, the
    candidate words, the per-row words and the count, as
    bsgs._pallas_chunk_impl(_host) pack them."""
    B, U = deg.numel(), deg.shape[1]
    safe = pos.clamp(max=B - 1).long()
    dead = deg.reshape(-1)[safe] | ((safe % U == U - 1) & adv[safe // U])
    live = (pos < B) & ~dead
    if table is None:
        words = [torch.where(live, pos, B), qhi, qlo]
    else:
        r = st.lookup(table, qhi, qlo)
        words = [torch.where((r.found | r.found2) & live, pos, B),
                 torch.where(r.found & live, r.idx, 0), torch.where(r.found2 & live, r.idx2, 0)]
    if rows is not None:
        rdeg, radv = rows
        rdeg = rdeg.clone()
        rdeg[:, U - 1] |= radv
        deg8 = rdeg.to(torch.uint8)
        words += [deg8.sum(dim=1, dtype=torch.int32), deg8.argmax(dim=1).to(torch.int32),
                  radv.to(torch.int32)]
    return torch.cat([w.to(torch.int32) for w in words] + [n.reshape(1)])


def _chunk_summary(table, pos, qhi, qlo, n, deg, adv, rows, out, counter) -> torch.Tensor:
    C = pos.shape[0] if pos.dim() == 1 else -1
    Rc, U = deg.shape if deg.dim() == 2 else (-1, -1)
    checks = [("pos", pos, torch.int32, (C,)), ("qhi", qhi, torch.int32, (C,)),
              ("qlo", qlo, torch.int32, (C,)), ("n", n, torch.int32, ()),
              ("deg", deg, torch.bool, (Rc, U)), ("adv", adv, torch.bool, (Rc,))]
    R = 0
    if rows is not None:
        R = rows[0].shape[0] if rows[0].dim() == 2 else -1
        checks += [("row deg", rows[0], torch.bool, (R, U)), ("row adv", rows[1], torch.bool, (R,))]
    m = 0
    if table is not None:
        m = table.key.shape[0]
        checks += [("table key", table.key, torch.int64, (m,)),
                   ("table idx", table.idx, torch.int32, (m,))]
    for name, t, dtype, shape in checks:
        st._check(name, t, dtype, shape)
    B = Rc * U
    if min(Rc, U) < 1 or B >= 1 << 31 or (table is not None and m < 1):
        raise ValueError(f"chunk summary needs Rc, U >= 1, Rc*U < 2^31 and a non-empty table "
                         f"(Rc={Rc}, U={U}, m={m})")
    width = 3 * C + 3 * R + 1
    if out is not None:
        st._check("out", out, torch.int32, (width,))
    tensors = [t for _, t, _, _ in checks] + ([] if out is None else [out])
    if not _build.on_cuda(*tensors):
        got = chunk_summary_ref(table, pos, qhi, qlo, n, deg, adv, rows)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty((width,), dtype=torch.int32, device=pos.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    key, idx = (None, None) if table is None else table
    rdeg, radv = (None, None) if rows is None else rows
    _build.launch("kh_bsgs_summary", *(ptr(t) for t in (pos, qhi, qlo, n, key, idx, deg, adv,
                                                         rdeg, radv, out)),
                  m, B, C, R, U, _build.stream(pos))
    counter.launches += 1
    return out


def chunk_summary(table: st.SortedXTable, pos: torch.Tensor, qhi: torch.Tensor,
                  qlo: torch.Tensor, n: torch.Tensor, deg: torch.Tensor, adv: torch.Tensor,
                  rows=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The device-resolve chunk summary (bsgs._pallas_chunk_impl after its
    cascade) from the cascade's C survivors: pos (C,) int32 positions in
    the B = Rc*U queries (B = padding), their key words qhi, qlo (C,) int32
    and their count n () int32. deg (Rc, U) bool: the queries' degenerate
    flags; adv (Rc,) bool: a row's advance flag, which marks its lane
    U - 1 too. rows: (deg (R, U), adv (R,)) of the summary rows, or
    None for none. Returns (3C + 3R + 1,) int32, written into `out` when
    given: the live survivors' positions (B elsewhere), the table payload j
    at their key's lower bound and at its successor (0 where that entry
    does not match or the lane is not live), per row its set flags, the
    first of them (0 when none) and its advance flag (lane U - 1 or'ed with
    it), then n. One launch of csrc/lookup.cu kh_bsgs_summary on the card,
    counted in chunk_summary.launches."""
    return _chunk_summary(table, pos, qhi, qlo, n, deg, adv, rows, out, chunk_summary)


def chunk_summary_host(pos: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                       n: torch.Tensor, deg: torch.Tensor, adv: torch.Tensor, rows=None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The host-resolve chunk summary (bsgs._pallas_chunk_impl_host after
    its cascade): as chunk_summary without a table, the survivors' key
    words qhi, qlo in place of the payloads (unchanged, padding included).
    The same kernel, counted in chunk_summary_host.launches."""
    return _chunk_summary(None, pos, qhi, qlo, n, deg, adv, rows, out, chunk_summary_host)


chunk_summary.launches = 0
chunk_summary_host.launches = 0


def chunk_impl_host(px, py, tab_x, tab_y, adv_x, adv_y, bitmap, bloom2,
                    *, U: int, K: int, T: int, C1: int, C2: int, adv_tab=None, pair_tab=None):
    """One host-resolve chunk (bsgs._pallas_chunk_impl_host): walk, cascade,
    packed summary. Returns (next_x, next_y, summary (3*C2+3*T*K+1,) int32):
    survivor positions (B = T*K*U where none), their key words qhi, qlo.
    adv_tab: pwalk.adv_multiples(ADV, K), built per call when None;
    pair_tab: pwalk.pair_tables(S, U, ADV, K) (None: a point a thread). On the
    card: K1, K2 with the level-1 probe, the compaction of its survivor
    mask, the bloom2 stage and the summary. No host sync: the summary stays
    on the device until the caller copies it."""
    res, fs, deg, adv_flat = _chunk_cascade(px, py, tab_x, tab_y, adv_x, adv_y, bitmap, bloom2,
                                            U, K, T, C1, C2, adv_tab, pair_tab)
    return res.next_x, res.next_y, chunk_summary_host(*fs, deg, adv_flat, (deg, adv_flat))


def chunk_impl(px, py, tab_x, tab_y, adv_x, adv_y, bitmap, table, bloom2,
               *, U: int, K: int, T: int, C1: int, C2: int, adv_tab=None, pair_tab=None):
    """One device-resolve chunk (bsgs._pallas_chunk_impl): walk, cascade
    (with the bloom2 stage unless bloom2 is None), the exact search of the
    C2 survivors in the sorted baby table, packed summary. Returns (next_x,
    next_y, summary (3*C2+3*T*K+1,) int32): survivor positions (B = T*K*U
    where no live match), the baby index j at the table's lower bound and
    at its successor (0 where that entry does not match), then as
    chunk_impl_host. On the card: K1, K2 with the level-1 probe, the
    compaction of its survivor mask, the bloom2 stage and the summary with
    the search. No host sync."""
    res, fs, deg, adv_flat = _chunk_cascade(px, py, tab_x, tab_y, adv_x, adv_y, bitmap, bloom2,
                                            U, K, T, C1, C2, adv_tab, pair_tab)
    return res.next_x, res.next_y, chunk_summary(table, *fs, deg, adv_flat, (deg, adv_flat))


def device_budgets(n_queries: int, m: int, bits_log2: int,
                   p: BSGSParams) -> Tuple[int, int, bool]:
    """(C1, C2, use2) of device resolve for n_queries against m keys in a
    2^bits_log2-bit bitmap, the JAX engine's budgets exactly: C1 from the
    expected level-1 survivors (n_queries*m/2^bits; mean + 8*sqrt(mean) +
    512 past 4096, else 4*mean), floored at p.chunk_cand_max; the bloom2
    stage when p.cascade2 is "on", or "auto" and more than 1024 survivors
    are expected, then C2 from max(64, expected/32), else C2 = C1."""
    expected = n_queries * m // (1 << bits_log2)
    need = (expected + 8 * int(expected ** 0.5) + 512 if expected >= 4096
            else 4 * expected)
    C1 = max(p.chunk_cand_max, ((need + 511) // 512) * 512)
    if not (p.cascade2 == "on" or (p.cascade2 == "auto" and expected > 1024)):
        return C1, C1, False
    exp2 = max(64, expected // 32)  # bloom2 fp <= 1/64, and slack
    return C1, max(p.chunk_cand_max,
                   ((exp2 + 8 * int(exp2 ** 0.5) + 511) // 512) * 512), True


def write_table(path: str, table: st.SortedXTable) -> None:
    """Write a baby table as the JAX package's table file: npz with
    version, m and the uint32 planes hi, lo, idx (sorted), and the sha256
    of hi + lo + idx."""
    hi, lo, idx = st.table_planes(table)
    digest = hashlib.sha256(hi.tobytes() + lo.tobytes() + idx.tobytes()).digest()
    np.savez(path, version=np.int64(1), m=np.int64(len(hi)), hi=hi, lo=lo, idx=idx,
             checksum=np.frombuffer(digest, dtype=np.uint8))


def _walk_step(px, py, walk):
    """K1 + K2 of one target (px, py) ((1, 8) limbs) by the walk's tables
    (a pwalk.WalkTables): pwalk.chunk_multi's result."""
    return pwalk.chunk_multi(px, py, *walk[:4], K=walk.K, U=walk.U, T=1, adv_tab=walk.adv_tab,
                             pair_tab=walk.pair_tab)


def _baby_walk(m: int, ub: int, dev, step_fn) -> None:
    """Baby keys j = 2*ub + 1..m on `dev`: K1/K2 walk BUILD_BLOCKS blocks of
    ub keys a step from base (2*ub)*G with ADV = ub*G. step_fn(px, py,
    walk, start, n_keep, bad) runs one step over keys start + 1..start +
    n_keep (the first n_keep of its lanes; walk is the pwalk.WalkTables of
    the step, for _walk_step), adds the kept lanes'
    degenerate flags and the advance flags to `bad` (a () int64 tensor) and
    returns the next base. Base (2*ub)*G is degeneracy-free (a lane would
    need t*ub == +-u, u <= ub); `bad` is checked once per slice of
    KEYHUNT_STREAM_SLICE steps. Key indices are python ints / int64, so any
    m works."""
    rest = m - 2 * ub
    if rest <= 0:
        return
    K = min(BUILD_BLOCKS, -(-rest // ub))
    walk = pwalk.walk_tables(ecref.G, ub, ecref.scalar_mult(ub), K, dev)
    base = ecref.scalar_mult(2 * ub)
    px, py = _limbs(base[0], dev)[None], _limbs(base[1], dev)[None]
    KU = K * ub
    n_iter = -(-rest // KU)
    slice_iters = max(1, int(os.environ.get("KEYHUNT_STREAM_SLICE", 256)))
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.time()
    for it in range(n_iter):
        # key j = 2*ub + it*KU + lane + 1 <= m: the step keeps a prefix
        px, py = step_fn(px, py, walk, 2 * ub + it * KU, min(KU, rest - it * KU), bad)
        if (it + 1) % slice_iters == 0 or it + 1 == n_iter:
            if int(bad) != 0:
                raise RuntimeError("degenerate walk lane in the baby walk "
                                   "(impossible for base >= 2*ub*G)")
            if n_iter > slice_iters:
                print(f"[build] baby walk {it + 1}/{n_iter} steps "
                      f"({time.time() - t0:.1f}s)", flush=True)


def _seed_keys(n: int, dev):
    """(hi, lo) int32 tensors on `dev` of keys j = 1..n (the native exact walk)."""
    seed = ht.native_keys_range(1, n)
    return (torch.from_numpy((seed >> np.uint64(32)).astype(np.uint32).view(np.int32)).to(dev),
            torch.from_numpy(seed.astype(np.uint32).view(np.int32)).to(dev))


@spanned("table_build")
def build_baby_table(m: int, build_block: int, dev) -> st.SortedXTable:
    """The device-resolve baby table (bsgs.build_baby_table): trunc64(x(j*G))
    with payload j, j = 1..m, on `dev`. Keys 1..2*build_block from the
    native walk, the rest by the K1/K2 walk of the filter build
    (_baby_walk), each step's keys written in j order into one m-long key
    tensor; then one stable sort (ties, truncation collisions, keep j
    ascending, as the JAX package's stable sort does)."""
    key = torch.empty((m,), dtype=torch.int64, device=dev)
    n_seed = min(2 * build_block, m)
    st.write_keys(key, 0, *_seed_keys(n_seed, dev))

    def step(px, py, walk, start, n_keep, bad):
        res = _walk_step(px, py, walk)
        st.write_keys(key, start, res.qhi.reshape(-1)[:n_keep], res.qlo.reshape(-1)[:n_keep])
        bad += res.degenerate.reshape(-1)[:n_keep].sum() + res.adv_degenerate.sum()
        return res.next_x, res.next_y

    _baby_walk(m, build_block, dev, step)
    return st.sort_keys(key)


class BSGSEngine:
    """Single-device BSGS search, device- or host-resolve (params.resolve)."""

    @spanned("engine_init")
    def __init__(self, pubkeys: Sequence[Tuple[int, int]], range_start: int,
                 range_end: int, params: BSGSParams = BSGSParams(),
                 device="cuda", host_table: "ht.HostTable | None" = None,
                 bitmap: "bmp.DeviceBitmap | None" = None,
                 bloom2: "bmp.DeviceBloom2 | None" = None,
                 table: "st.SortedXTable | None" = None):
        """table (device resolve) or host_table, bitmap and bloom2 (host
        resolve) are built when not given; a device-resolve engine takes
        its bloom2 from _bloom2_for_table."""
        if not (1 <= range_start < range_end <= ecref.N):
            raise ValueError("bad range")
        if params.resolve not in ("device", "host"):
            raise ValueError("resolve must be 'device' or 'host'")
        if params.cascade2 not in ("auto", "on", "off"):
            raise ValueError("cascade2 must be 'auto', 'on' or 'off'")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.targets = list(pubkeys)
        self.a = range_start
        self.b = range_end
        self.p = params
        self.stats = SearchStats()
        m = params.m
        self.stride = 2 * m
        n_centers = max(1, math.ceil((self.b - self.a) / self.stride))
        self.n_steps = math.ceil(n_centers / params.block_u)

        U = params.block_u

        self.table = self.host_table = None
        if params.resolve == "device":
            if table is None:
                table = build_baby_table(m, params.build_block, self.device)
            if table.key.shape != (m,) or table.key.device.type != self.device.type:
                raise ValueError(f"table of {tuple(table.key.shape)} keys on "
                                 f"{table.key.device} does not match m={m} on {self.device}")
            self.table = table
            # shareable by every engine over the same table
            self.bitmap = (bitmap if bitmap is not None
                           else bmp.build_bitmap_device(table, params.bits_log2))
        else:
            if host_table is None:
                host_table = ht.ensure_host_table(
                    m, params.table_cache or ht.DEFAULT_CACHE_DIR)
            if host_table.m != m:
                raise ValueError(f"host table m={host_table.m} != params.m={m}")
            self.host_table = host_table
            if bitmap is not None and bloom2 is not None:
                self.bitmap, self.bloom2 = bitmap, bloom2
            else:
                self.bitmap, self.bloom2 = self._build_filters_streaming(
                    *self._filter_sizes())

        T, K = len(self.targets), params.steps_per_chunk
        if T * K * U > CHUNK_WORD_CAP:
            k_new = max(1, CHUNK_WORD_CAP // (T * U))
            if k_new < K:
                get_logger().warn(
                    f"multi-target chunk would need {T}*{K}*{U} query words; "
                    f"shrinking steps_per_chunk {K} -> {k_new} to bound "
                    "device memory")
                self.p = dataclasses.replace(self.p, steps_per_chunk=k_new)
        self._size_cascade(T * self.p.steps_per_chunk * U)
        # the walk's tables: S = -(stride)*G, ADV = U*S
        s_pt = ecref.point_neg(ecref.scalar_mult(self.stride))
        self.walk = pwalk.walk_tables(s_pt, U, ecref.scalar_mult(U, s_pt),
                                      self.p.steps_per_chunk, self.device)
        self.tab_x, self.tab_y, self.adv_x, self.adv_y, self.adv_tab, self.pair_tab = self.walk
        self._rebase_tab = None  # _scheduled_bases' host table, built on first use
        self._host_keys = None  # _rescan_table's host copy, made on first use

    # ------------------------------------------------------------------
    # the baby table (device resolve) and filters (host resolve)
    # ------------------------------------------------------------------

    def _filter_sizes(self) -> Tuple[int, int]:
        """(bitmap bits, bloom2 bits) of host resolve. Defaults follow the JAX
        engine on the matching backend: its accelerator path pins both at
        2^35 bits (4 GiB each, load 1/8 even at m = 2^31); its CPU path
        sizes them from m."""
        p = self.p
        if self.device.type == "cuda":
            bits, b2 = 35, 35
        else:
            bits, b2 = bmp.default_bits_log2(p.m), bmp.bloom2_bits_log2_host(p.m)
        return (p.bits_log2 if p.bits_log2 is not None else bits,
                p.bloom2_bits if p.bloom2_bits is not None else b2)

    def _build_filters_streaming(self, bits_log2: int, b2bits: int):
        """Host resolve: bitmap + bloom2 over j = 1..m, built on the device
        with no m-sized key planes: keys 1..2*Ub (Ub = build_block) from the
        native exact walk, the rest walked by _baby_walk and ORed into both
        filters by K3 in the same step (filter_build_step)."""
        dev = self.device
        words1 = bmp.empty_filter(bits_log2, dev)
        words2 = bmp.empty_filter(b2bits, dev)
        m, ub = self.p.m, self.p.build_block
        n_seed = min(2 * ub, m)
        bmp.insert_keys(words1, bits_log2, words2, b2bits, *_seed_keys(n_seed, dev), n_seed)
        _baby_walk(m, ub, dev, lambda px, py, walk, start, n_keep, bad: filter_build_step(
            px, py, walk, words1, bits_log2, words2, b2bits, n_keep, bad))
        return (bmp.DeviceBitmap(words1, bits_log2),
                bmp.DeviceBloom2(words2, b2bits))

    # ------------------------------------------------------------------
    # table files (reference -S; the JAX package's npz format)
    # ------------------------------------------------------------------

    def save_table(self, path: str) -> None:
        """Write the device table as the JAX package's table file
        (write_table)."""
        if self.table is None:
            raise ValueError("host-resolve engines have no device table; the host "
                             "table is cached on disk by filter/host_table.py")
        write_table(path, self.table)

    @staticmethod
    def load_table(path: str, verify_checksum: bool = True, device="cuda") -> st.SortedXTable:
        """A table file of either package on `device`; ValueError on a bad
        version or checksum (verify_checksum=False skips the checksum)."""
        with np.load(path) as z:
            if int(z["version"]) != 1:
                raise ValueError("unsupported table version")
            hi, lo, idx = z["hi"], z["lo"], z["idx"]
            if verify_checksum:
                digest = hashlib.sha256(hi.tobytes() + lo.tobytes() + idx.tobytes()).digest()
                if digest != z["checksum"].tobytes():
                    raise ValueError("baby table checksum mismatch")
            return st.table_from_planes(hi, lo, idx, device)

    # ------------------------------------------------------------------
    # giant-step search
    # ------------------------------------------------------------------

    def _size_cascade(self, n_queries: int) -> None:
        """The chunk's cascade budgets C1, C2 and (device resolve) its bloom2."""
        if self.table is None:
            self.C1, self.C2 = self._cascade_budgets(n_queries)
        else:
            self.C1, self.C2, use2 = device_budgets(n_queries, self.p.m,
                                                    self.bitmap.bits_log2, self.p)
            self.bloom2 = _bloom2_for_table(self.table) if use2 else None

    def _cascade_budgets(self, n_queries: int) -> Tuple[int, int]:
        """(C1, C2): mean + 8*sqrt(mean) + 512 rounded up to 512, floored at
        chunk_cand_max, for expected stage-1 (B*m/2^bits) and stage-2
        (stage-1 * bloom2_fp) survivors; overflow is safe (host rescan)."""
        p = self.p
        expected = max(1, n_queries * p.m // (1 << self.bitmap.bits_log2))

        def budget(mean: int) -> int:
            need = mean + 8 * int(mean ** 0.5) + 512
            return ((need + 511) // 512) * 512

        C1 = max(p.chunk_cand_max, budget(expected))
        fp2 = bmp.bloom2_fp(p.m, self.bloom2.bits_log2)
        C2 = max(p.chunk_cand_max, budget(int(expected * fp2) + 1))
        return C1, C2

    def _initial_base(self, step0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """P_base(s=step0) per target (host-exact), as (T, 8) limb tensors."""
        c_base = self.a + self.p.m + (step0 * self.p.block_u - 1) * self.stride
        offset = ecref.scalar_mult((-c_base) % ecref.N)
        pts = [ecref.point_add(q, offset) for q in self.targets]
        if any(pt is None for pt in pts):
            raise _ImmediateHit(c_base)  # Q == c_base*G: the base IS a key
        px = np.stack([fe.int_to_limbs(pt[0]) for pt in pts]).view(np.int32)
        py = np.stack([fe.int_to_limbs(pt[1]) for pt in pts]).view(np.int32)
        return (torch.from_numpy(px).to(self.device),
                torch.from_numpy(py).to(self.device))

    def _chunk_fn(self, px, py):
        p = self.p
        shape = dict(U=p.block_u, K=p.steps_per_chunk, T=len(self.targets), C1=self.C1,
                     C2=self.C2, adv_tab=self.adv_tab, pair_tab=self.pair_tab)
        consts = (px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y, self.bitmap)
        if self.table is None:
            return chunk_impl_host(*consts, self.bloom2, **shape)
        return chunk_impl(*consts, self.table, self.bloom2, **shape)

    def _consume_summary(self, step0: int, k: int, arr: np.ndarray):
        """Decode one chunk's summary -> (found, rebase, interesting): the
        JAX engine's "chunk" (device resolve: baby indices) and
        "chunk_host" (host resolve: keys for the host table) forms."""
        p = self.p
        C2 = self.C2
        K = p.steps_per_chunk
        U = p.block_u
        T = len(self.targets)
        B = T * K * U
        cand_pos = arr[:C2]
        degsum = arr[3 * C2 : 3 * C2 + 3 * T * K].reshape(3, T, K)
        ncand = int(arr[3 * C2 + 3 * T * K])
        found: List[FoundKey] = []
        interesting = False
        if ncand > C2:
            interesting = True
            current_call().count("cascade_overflows")
            for s_ in range(k):  # cascade overflow: exact host rescan
                found += self._host_rescan_step(step0 + s_)
        # steps after a mid-chunk advance degeneracy hold garbage walk state
        adv_any = degsum[2, :, :k].any(axis=0)  # (k,)
        adv_first = int(np.argmax(adv_any)) if adv_any.any() else k
        for s_ in range(adv_first + 1, k):
            interesting = True
            found += self._host_rescan_step(step0 + s_)
        valid = np.nonzero(cand_pos < B)[0]
        if self.host_table is None:  # j at the lower bound and its successor (0: none)
            js = arr[C2 : 3 * C2].view(np.uint32).reshape(2, C2)[:, valid]
            hits = [(int(cand_pos[c]), int(j)) for c, j1, j2 in zip(valid, *js)
                    for j in (j1, j2) if j]
        elif len(valid):
            rows, js = self.host_table.resolve(arr[C2 : 2 * C2].view(np.uint32)[valid],
                                               arr[2 * C2 : 3 * C2].view(np.uint32)[valid])
            hits = [(int(cand_pos[valid[r]]), int(j)) for r, j in zip(rows.tolist(), js.tolist())]
        else:
            hits = []
        for pos, j in hits:
            blk, u0 = divmod(pos, U)
            t, s_ = divmod(blk, K)
            if s_ >= k:
                continue
            interesting = True
            found += self._try_candidates(self._candidates_for_hit(step0 + s_, u0 + 1, j), t)
        for t, s_ in zip(*np.nonzero(degsum[0, :, :k] > 0)):
            interesting = True
            u = int(degsum[1, t, s_]) + 1
            found += self._try_candidates(
                self._candidates_for_degenerate(step0 + int(s_), u), int(t))
        return found, bool(adv_any.any()), interesting

    def _center(self, step: int, u: int) -> int:
        """Center scalar for device step `step`, offset u in 1..U."""
        return self.a + self.p.m + (step * self.p.block_u + u - 1) * self.stride

    def _candidates_for_hit(self, step: int, u: int, baby: int) -> List[int]:
        c = self._center(step, u)
        return [c - baby, c + baby]

    def _candidates_for_degenerate(self, step: int, u: int) -> List[int]:
        c_base = self._center(step, 0)  # = c_{sU} - stride
        return [c_base - u * self.stride, c_base + u * self.stride]

    def search(self, max_steps: Optional[int] = None, start_step: int = 0,
               stop_on_first: bool = True, progress_every: int = 0,
               max_seconds: Optional[float] = None) -> List[FoundKey]:
        """Run the giant-step scan in order from start_step (any step);
        returns verified found keys. Up to pipeline_depth chunks are in
        flight (engine/pipeline.py): the walk state chains on the device
        and only summaries come back. max_seconds stops dispatch at the
        first chunk boundary past the deadline; in-flight chunks are
        drained, so stats stay exact."""
        K = self.p.steps_per_chunk
        remaining = self.n_steps - start_step
        total = remaining if max_steps is None else min(remaining, max_steps)
        plan = _BSGSPlan(self, lambda i: start_step + i * K, -(-total // K), start_step + total)
        return pipeline.run("search", plan, stop_on_first, max_seconds, progress_every)

    # ------------------------------------------------------------------
    # range orders and checkpoints
    # ------------------------------------------------------------------

    def chunk_order(self, policy: str = "sequential", seed: int = 0) -> List[int]:
        """The chunk order of a range policy (the reference's five BSGS
        sub-schedulers), a pure function of (policy, seed, n_chunks): a
        resumed run derives the same order, so a checkpoint stores only how
        many chunks of it are done. Python's random.Random(seed), exactly as
        the JAX engine draws it."""
        import random as _random

        n_chunks = math.ceil(self.n_steps / self.p.steps_per_chunk)
        order = list(range(n_chunks))
        if policy == "sequential":
            pass
        elif policy == "backward":
            order.reverse()
        elif policy == "both":
            front, back = 0, n_chunks - 1
            order = []
            rng = _random.Random(seed)
            while front <= back:
                if rng.random() < 0.5:
                    order.append(front)
                    front += 1
                else:
                    order.append(back)
                    back -= 1
        elif policy == "random":
            rng = _random.Random(seed)
            rng.shuffle(order)
        elif policy == "dance":
            # random alternation over front / back / middle
            rng = _random.Random(seed)
            remaining = set(order)
            order = []
            while remaining:
                pool = sorted(remaining)
                pick = rng.choice(("front", "back", "middle"))
                if pick == "front":
                    c = pool[0]
                elif pick == "back":
                    c = pool[-1]
                else:
                    c = pool[len(pool) // 2]
                order.append(c)
                remaining.remove(c)
        else:
            raise ValueError(f"unknown policy {policy}")
        return order

    def _scheduled_bases(self, chunks: Sequence[int]) -> Dict[int, object]:
        """Walk bases of the given chunks, exactly _initial_base(c*K) each,
        as {chunk: (px, py)} or {chunk: _ImmediateHit}. The offset -c_base*G
        of chunk c is O0 + c*E (O0 = chunk 0's, E = -(K*U*stride)*G): a sum
        over c's bits from a host table of 2^i*E in Jacobian coordinates,
        then each target added and every point brought to affine with one
        inversion for all. A sum that meets h == 0 (a doubling, or the
        point at infinity) goes through _initial_base instead."""
        p = self.p
        K, P = p.steps_per_chunk, ecref.P
        n_chunks = math.ceil(self.n_steps / K)
        if self._rebase_tab is None:
            e = ecref.point_neg(ecref.scalar_mult(K * p.block_u * self.stride))
            tab = []
            for _ in range(max(1, n_chunks.bit_length())):
                tab.append(e)
                e = ecref.point_double(e)
            c0 = self.a + p.m - self.stride  # c_base(0)
            self._rebase_tab = (ecref.scalar_mult((-c0) % ecref.N), tab)
        o0, tab = self._rebase_tab
        jac: Dict[int, list] = {}
        out: Dict[int, object] = {}
        for c in chunks:
            acc = (o0[0], o0[1], 1) if o0 is not None else (0, 1, 0)
            for i in range(c.bit_length()):
                if acc is not None and c >> i & 1:
                    acc = _jac_madd(*acc, *tab[i])
            pts = None if acc is None else [_jac_madd(*acc, *q) for q in self.targets]
            if pts is None or not all(pts):
                out[c] = pipeline.base_or_hit(self._initial_base, c * K)
            else:
                jac[c] = pts
        zinv = iter(_batch_inv([pt[2] for pts in jac.values() for pt in pts]))
        limbs = np.empty((len(jac), 2, len(self.targets), 8), dtype=np.uint32)
        for n, pts in enumerate(jac.values()):
            for t, (X, Y, _) in enumerate(pts):
                zi = next(zinv)
                zi2 = zi * zi % P
                limbs[n, 0, t] = fe.int_to_limbs(X * zi2 % P)
                limbs[n, 1, t] = fe.int_to_limbs(Y * zi2 * zi % P)
        if jac:
            # one copy from pinned memory that does not wait for the chunks
            # in flight (a pageable one would drain the stream first)
            host = torch.from_numpy(limbs.view(np.int32))
            dev = (host.pin_memory().to(self.device, non_blocking=True)
                   if self.device.type == "cuda" else host)
            out.update((c, (dev[n, 0], dev[n, 1])) for n, c in enumerate(jac))
        return out

    def search_scheduled(self, policy: str = "sequential", seed: int = 0,
                         max_chunks: Optional[int] = None, stop_on_first: bool = True,
                         progress_every: int = 0, checkpoint=None,
                         max_seconds: Optional[float] = None) -> List[FoundKey]:
        """The giant-step scan over chunk_order(policy, seed), the JAX
        engine's search_scheduled, through search's loop and base rule.
        checkpoint: a core.checkpoint.CheckpointManager; it counts the
        chunks of the order done, and a resumed run reports the keys the
        saved one found."""
        p = self.p
        order = self.chunk_order(policy, seed)
        plan = _BSGSPlan(self, lambda i: order[i] * p.steps_per_chunk, len(order), self.n_steps)
        if checkpoint is not None:
            ck = pipeline.open_checkpoint(
                plan, checkpoint, self.stats,
                dict(mode="bsgs", range_start=self.a, range_end=self.b, policy=policy,
                     seed=seed, params_fp=fingerprint(p.m, p.block_u, p.steps_per_chunk),
                     targets_fp=fingerprint(sorted(self.targets))), n_chunks=len(order))
            if ck is not None:
                plan.i = ck.chunks_done
                plan.found0 = self._try_candidates_all([int(h, 16) for h in ck.found])
        if max_chunks is not None:
            plan.n = min(plan.n, plan.i + max_chunks)
        plan.n_chunks = plan.n - plan.i
        return pipeline.run("search_scheduled", plan, stop_on_first, max_seconds, progress_every)

    def _rescan_table(self):
        """(sorted u64 keys, payload, j offset) for the exact host rescan,
        from the table this engine holds: the host table (payload j - 1),
        or a host copy of the device table (payload j), made on first use."""
        if self._host_keys is None:
            if self.host_table is not None:
                self._host_keys = (self.host_table.keys, self.host_table.idx, 1)
            else:
                keys = self.table.key.cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)
                self._host_keys = (keys, self.table.idx.cpu().numpy().view(np.uint32), 0)
        return self._host_keys

    def _host_rescan_step(self, step: int) -> List[FoundKey]:
        """Exact host scan of one device step (the cascade-overflow and
        invalid-walk fallback): python-int walk of U points per target,
        then one vectorised searchsorted."""
        tr = current_call()
        tr.count("host_rescans")
        with tr.span("rescan"):
            keys, payload, j_off = self._rescan_table()
            found: List[FoundKey] = []
            U = self.p.block_u
            neg_stride = ecref.point_neg(ecref.scalar_mult(self.stride))
            mask64 = (1 << 64) - 1
            for t, q in enumerate(self.targets):
                c0 = self._center(step, 1)
                c = c0
                pt = ecref.point_add(q, ecref.scalar_mult((-c) % ecref.N))
                xs = np.zeros(U, dtype=np.uint64)
                for u in range(U):
                    if pt is None:  # Q == c*G exactly
                        found += self._try_candidates([c], t)
                        pt = neg_stride
                    else:
                        xs[u] = pt[0] & mask64
                        pt = ecref.point_add(pt, neg_stride)
                    c += self.stride
                left = np.searchsorted(keys, xs, side="left")
                right = np.searchsorted(keys, xs, side="right")
                for u in np.nonzero(right > left)[0]:
                    cu = c0 + int(u) * self.stride
                    for p_ in range(int(left[u]), int(right[u])):
                        j = int(payload[p_]) + j_off
                        found += self._try_candidates([cu - j, cu + j], t)
            return found

    def _try_candidates_all(self, cands: Sequence[int]) -> List[FoundKey]:
        """Verify candidates against EVERY target (base-center collisions
        carry no target id)."""
        out: List[FoundKey] = []
        for t in range(len(self.targets)):
            out += self._try_candidates(cands, t)
        return out

    def _try_candidates(self, cands: Sequence[int], t: int = 0) -> List[FoundKey]:
        """Exact verification of one candidate (a device match or lane: its
        scalar, or the pair around its center) against target t; keys
        outside [a, b] are dropped (the last block's centers tile past
        range_end). Counted as one candidate, false when no key comes."""
        tr = current_call()
        seen: Dict[int, FoundKey] = {}
        with tr.span("verify"):
            for cand in cands:
                k = verify_candidate_scalar(cand, self.targets[t])
                if k is not None and self.a <= k <= self.b:
                    seen[k] = FoundKey(private_key=k, pubkey=self.targets[t],
                                       target=f"{self.targets[t][0]:064x}")
        tr.count("candidates_verified")
        if not seen:
            tr.count("false_candidates")
        return list(seen.values())


class _BSGSPlan(pipeline.ChunkPlan):
    """A BSGS search's chunks: chunk i of n covers k = min(K, end - step)
    steps from step_at(i), its position (i, step, k). Its exact base
    (where it does not follow the last chunk dispatched) is _initial_base's,
    or one _scheduled_bases batch's for a look-ahead that jumps; a rebase
    restarts by _initial_base."""

    label = "bsgs"

    def __init__(self, eng: BSGSEngine, step_at, n: int, end: int):
        self.eng, self.step_at, self.n, self.n_chunks, self.end = eng, step_at, n, n, end
        self.i, self.device, self.depth = 0, eng.device, eng.p.pipeline_depth
        self.K, self.step_keys = eng.p.steps_per_chunk, eng.p.block_u * eng.stride
        self.ahead: Dict[int, object] = {}  # step -> exact base, batched ahead

    @staticmethod
    def found_key(f: FoundKey):
        return f.private_key, f.target

    def next(self):
        i = self.i
        if i >= self.n:
            return None
        self.i, step = i + 1, self.step_at(i)
        return step, (i, step, min(self.K, self.end - step))

    def exact(self, pos):
        (i, step, _), eng, K = pos, self.eng, self.K
        if step not in self.ahead:
            need = [self.step_at(j) for j in range(i, min(self.n, i + self.depth))
                    if j == i or self.step_at(j) != self.step_at(j - 1) + K]
            if len(need) == 1:
                return pipeline.base_or_hit(eng._initial_base, step)
            self.ahead.update((c * K, b) for c, b in
                              eng._scheduled_bases([s // K for s in need]).items())
        return self.ahead.pop(step)

    def dispatch(self, pos, base):
        nx, ny, out = self.eng._chunk_fn(*base)
        self.chain = (pos[1] + self.K, (nx, ny))
        return out

    def decode(self, pos, arr: np.ndarray):
        i, step, k = pos
        found, rebase, _ = self.eng._consume_summary(step, k, arr)  # rebase: an advance degenerated
        return found, k * self.step_keys, i + 1 if rebase and i + 1 < self.n else None

    def on_host(self, pos, scalar: int):
        _, step, k = pos
        rescan = [f for s_ in range(step, step + k) for f in self.eng._host_rescan_step(s_)]
        return self.eng._try_candidates_all([scalar]) + rescan, k * self.step_keys

    def restart(self, i: int) -> None:
        self.i, step = i, self.step_at(i)
        self.chain = (step, pipeline.base_or_hit(self.eng._initial_base, step))

    def mark(self, ck, pos, n_done: int) -> None:
        ck.chunks_done = pos[0] + 1
