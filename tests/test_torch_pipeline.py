"""The one pipelined chunk loop (keyhuntm1cpu_tpu_torch/engine/pipeline.py)
behind every search entry, on the CPU at tiny shapes:

- BSGS's two orders walk one loop: search and search_scheduled("sequential")
  give the same found keys and keys covered, with the key in chunk 0,
  mid-range and in a last partial chunk;
- a deadline that expires after three dispatches: every chunk dispatched
  is decoded and counted, in each of the seven entries;
- a forced degenerate advance drops the chunks in flight and restarts
  exactly at the next position (BSGS in both orders, fused brute, sharded
  BSGS, sharded brute), with every key counted once;
- a base center that is a target's key, at the first chunk and after a
  rebase, is recorded once;
- each entry's spans a chunk equal a table here: one dispatch a card of a
  sharded chunk, quiet sharded chunks not decoded.

Keys and counts are compared exactly."""

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu_torch.core import metrics  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import minikeys as mk  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import pipeline  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.parallel import ShardedBruteEngine, ShardedBSGSEngine  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402

torch.set_num_threads(1)
REG = metrics.get_metrics()
A = 0xA00000
M, U, K = 512, 16, 4
STEP = U * 2 * M  # keys a BSGS step
BSGS_P = bsgs.BSGSParams(m=M, block_u=U, steps_per_chunk=K, bits_log2=16, pipeline_depth=2)
BRUTE_P = BruteParams(block_u=128, steps_per_chunk=2, chunk_cand=64, pipeline_depth=2)
WALKER_P = BruteParams(walkers=2, block_u=32, steps_per_chunk=2, chain_len=8, compare_max=0,
                       bucket_max=0)
MINI_P = mk.MinikeyParams(batch=256, valid_max=64, pipeline_depth=2)
CPU2 = [torch.device("cpu")] * 2
BA = 0x90000  # sharded brute ranges: no degenerate lane near key 1 makes a chunk interesting
NONE = 0xDEADBEEF  # a key no range of these tests holds


@pytest.fixture(scope="module")
def table():
    return bsgs.build_baby_table(M, BSGS_P.build_block, torch.device("cpu"))


def _bsgs(keys, table, b=A + 4 * K * STEP, cls=bsgs.BSGSEngine, **kw):
    return cls([ecref.scalar_mult(k) for k in keys], A, b, BSGS_P, table=table, **kw)


def _hash_targets(keys):
    return TargetSet(kind="hash160", labels=[str(k) for k in keys],
                     raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(k)) for k in keys])


def _keys(found):
    return sorted(f.private_key for f in found)


def _spans(rec):
    return {k: v["count"] for k, v in rec["spans"].items()}


# The seven entries: (engine, its search call, its record's name, keys a
# chunk as SearchStats counts them, cards a chunk)
def _entry(name, table):
    if name == "bsgs.search":
        eng = _bsgs([NONE], table, device="cpu")
        return eng, eng.search, "search", K * STEP, 1
    if name == "bsgs.search_scheduled":
        eng = _bsgs([NONE], table, device="cpu")
        return eng, eng.search_scheduled, "search_scheduled", K * STEP, 1
    if name == "brute.fused":
        eng = BruteEngine(_hash_targets([NONE]), 2, 2 + 8 * 256, mode="rmd160", params=BRUTE_P,
                          device="cpu")
        return eng, eng.search, "_search_fused", 256, 1
    if name == "brute.walker":
        eng = BruteEngine(_hash_targets([NONE]), 1, 1041, mode="rmd160", params=WALKER_P,
                          device="cpu")
        return eng, eng.search, "_search_walker", 2 * 2 * 65, 1
    if name == "mesh.bsgs":
        eng = _bsgs([NONE], table, b=A + 8 * K * STEP, cls=ShardedBSGSEngine, devices=CPU2)
        return eng, eng.search_sharded, "search_sharded", 2 * K * STEP, 2
    if name == "mesh.brute":
        eng = ShardedBruteEngine(_hash_targets([NONE]), BA, BA + 16 * 256, mode="rmd160",
                                 params=BRUTE_P, devices=CPU2)
        return eng, eng.search_sharded, "search_sharded", 2 * 256, 2
    eng = mk.MinikeyEngine(_hash_targets([NONE]), prefix="SkeyhuntPIPE", params=MINI_P,
                           device="cpu")
    return eng, eng.search, "search", 256, 1


ENTRIES = ["bsgs.search", "bsgs.search_scheduled", "brute.fused", "brute.walker", "mesh.bsgs",
           "mesh.brute", "minikeys"]


class _ExpiresAfter:
    """A deadline that passes at its n+1st look (one look a dispatch)."""

    def __init__(self, n):
        self.left = n

    def expired(self):
        self.left -= 1
        return self.left < 0


# ---------------------------------------------------------------------------
# BSGS: one loop for both orders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["chunk0", "mid", "last_partial"])
def test_search_and_scheduled_sequential_agree(table, where):
    """Nine steps: chunks of steps 0-3, 4-7 and the partial chunk of step
    8. Each order stops at the key's chunk with the same keys covered."""
    key = {"chunk0": A + 12345, "mid": A + 5 * STEP + 777, "last_partial": A + 8 * STEP + 999}[where]
    b = A + 9 * STEP
    runs = []
    for call in ("search", "search_scheduled"):
        eng = _bsgs([key], table, b=b, device="cpu")
        assert eng.n_steps == 9
        runs.append((_keys(getattr(eng, call)()), eng.stats.keys_covered))
    chunks = {"chunk0": 1, "mid": 2, "last_partial": 3}[where]
    assert runs[0] == runs[1] == ([key], min(chunks * K, 9) * STEP)


# ---------------------------------------------------------------------------
# the deadline drains what is in flight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENTRIES)
def test_deadline_drains_every_dispatched_chunk(table, monkeypatch, name):
    eng, search, loop, keys, cards = _entry(name, table)
    monkeypatch.setattr(pipeline, "Deadline", lambda s: _ExpiresAfter(3))
    assert search(stop_on_first=False, max_seconds=1.0) == []
    rec = REG.last_call(loop)
    assert rec["chunks_decoded"] == 3 and _spans(rec)["dispatch"] == 3 * cards
    assert eng.stats.keys_covered == 3 * keys and rec["keys"] == 3 * keys * eng.stats.multiplier


# ---------------------------------------------------------------------------
# a degenerate advance: drop and restart exactly
# ---------------------------------------------------------------------------


def _spy(obj, name, calls):
    fn = getattr(obj, name)
    setattr(obj, name, lambda *a: calls.append(a) or fn(*a))


@pytest.mark.parametrize("call", ["search", "search_scheduled"])
def test_bsgs_rebase_restarts_at_the_next_chunk(table, call):
    """Chunk 0 reports an advance degeneracy: chunk 1, already in flight,
    is dropped and walked again from _initial_base(K); the key in chunk 2
    is found and every chunk counted once."""
    key = A + 2 * K * STEP + 4321
    eng = _bsgs([key], table, b=A + 3 * K * STEP, device="cpu")
    bases, chunks = [], []
    _spy(eng, "_initial_base", bases)
    _spy(eng, "_chunk_fn", chunks)
    fn = eng._consume_summary
    eng._consume_summary = lambda s, k, arr: (lambda r: (r[0], s == 0, r[2]))(fn(s, k, arr))
    assert _keys(getattr(eng, call)(stop_on_first=False)) == [key]
    assert bases == [(0,), (K,)] and len(chunks) == 4
    restarted = chunks[2]
    want = eng._initial_base(K)
    assert torch.equal(restarted[0], want[0]) and torch.equal(restarted[1], want[1])
    assert eng.stats.keys_covered == 3 * K * STEP
    rec = REG.last_call(call)
    assert rec["counters"]["rebases"] == 1 and _spans(rec)["rebase"] == 1
    assert rec["chunks_decoded"] == 3


def test_fused_brute_rebase_restarts_at_the_first_bad_step():
    """Chunk 0's advance chain breaks after step 1: the walk restarts at
    step 1 from _fast_base, and steps 1.. are walked once more."""
    eng = BruteEngine(_hash_targets([600]), 2, 2 + 8 * 128, mode="rmd160", params=BRUTE_P,
                      device="cpu")
    bases = []
    _spy(eng, "_fast_base", bases)
    fn = eng._decode_fast
    eng._decode_fast = lambda s0, arr: (lambda r: (1 if s0 == 0 else r[0], r[1]))(fn(s0, arr))
    assert _keys(eng.search()) == [600]
    assert bases == [(0,), (1,)]
    assert eng.stats.keys_covered == 8 * 128  # step 0 once, then steps 1..7
    rec = REG.last_call("_search_fused")
    assert rec["chunks_decoded"] == 5 and rec["counters"]["rebases"] == 1


def _force_interest(eng):
    """Every sharded chunk's interest word set, so that each is decoded."""
    fn = eng._sharded_chunk

    def chunk(bases):
        nxt, (host, ev) = fn(bases)
        host[-1] = 1
        return nxt, (host, ev)

    eng._sharded_chunk = chunk


@pytest.mark.parametrize("kind", ["bsgs", "brute"])
def test_sharded_rebase_restarts_every_shard(table, kind):
    if kind == "bsgs":
        key = A + (16 + 5) * STEP + 17  # shard 1's second chunk, local step 5
        eng = _bsgs([key], table, b=A + 8 * K * STEP, cls=ShardedBSGSEngine, devices=CPU2)
        n_keys = 4 * 2 * K * STEP
    else:
        key = BA + 6 * 128 + 2 * 128 + 5  # shard 1's second chunk
        eng = ShardedBruteEngine(_hash_targets([key]), BA, BA + 12 * 128, mode="rmd160",
                                 params=BRUTE_P, devices=CPU2)
        n_keys = 12 * 128
    bases = []
    _spy(eng, "_bases_at", bases)
    _force_interest(eng)
    fn = eng._decode_sharded
    eng._decode_sharded = lambda arr, s, k: (lambda r: (r[0], s == 0))(fn(arr, s, k))
    assert _keys(eng.search_sharded(stop_on_first=False)) == [key]
    K_ = eng.p.steps_per_chunk
    assert bases == [(0,), (K_,)] and eng.stats.keys_covered == n_keys
    rec = REG.last_call("search_sharded")
    assert rec["counters"]["rebases"] == 1 and _spans(rec)["rebase"] == 1
    assert rec["chunks_decoded"] == n_keys // (2 * K_ * (STEP if kind == "bsgs" else 128))


# ---------------------------------------------------------------------------
# a base center at a key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("when", ["first_chunk", "after_rebase"])
def test_base_at_a_key_is_recorded_once(table, when):
    """The key is the base center of step K (the center before step K's
    first): the first chunk of search(start_step=K), or the restart after
    a rebase forced on chunk 0. One record of it, its chunk rescanned on
    the host and counted."""
    eng0 = _bsgs([NONE], table, device="cpu")
    key = eng0._center(K, 0)
    eng = _bsgs([key, A + 3 * K * STEP + 99], table, device="cpu")
    with pytest.raises(bsgs._ImmediateHit):
        eng._initial_base(K)
    if when == "first_chunk":
        found = eng.search(start_step=K, stop_on_first=False)
        n_chunks = 3
    else:
        fn = eng._consume_summary
        eng._consume_summary = lambda s, k, arr: (lambda r: (r[0], s == 0, r[2]))(fn(s, k, arr))
        found = eng.search(stop_on_first=False)
        n_chunks = 4
    assert sorted(f.private_key for f in found) == sorted([key, A + 3 * K * STEP + 99])
    assert eng.stats.keys_covered == n_chunks * K * STEP
    rec = REG.last_call("search")
    assert rec["chunks_decoded"] == n_chunks - 1  # the key's chunk ran on the host
    assert rec["counters"]["host_rescans"] >= K


# ---------------------------------------------------------------------------
# each entry's spans a chunk
# ---------------------------------------------------------------------------

ONE_CARD = {"dispatch": 1, "copy": 1, "wait": 1, "decode": 1}
SPANS_A_CHUNK = {
    "bsgs.search": ONE_CARD,
    "bsgs.search_scheduled": ONE_CARD,
    "brute.fused": ONE_CARD,
    "brute.walker": ONE_CARD,
    "minikeys": ONE_CARD,
    # a dispatch a card, one copy of the gathered summaries; a chunk of no
    # interest is not decoded
    "mesh.bsgs": {"dispatch": 2, "copy": 1, "wait": 1},
    "mesh.brute": {"dispatch": 2, "copy": 1, "wait": 1},
}


@pytest.mark.parametrize("name", ENTRIES)
def test_each_entry_spans_a_chunk(table, name):
    eng, search, loop, _, _ = _entry(name, table)
    kw = {"max_chunks": 2} if name in ("bsgs.search_scheduled", "minikeys") else {
        "max_steps": 2 * eng.p.steps_per_chunk}
    assert search(stop_on_first=False, **kw) == []
    rec = REG.last_call(loop)
    n = rec["chunks_decoded"]
    assert n == 2
    want = {k: v * n for k, v in SPANS_A_CHUNK[name].items()}
    got = _spans(rec)
    assert got.pop("search") == 1
    got.pop("verify", None)  # the candidates a one-card chunk checked, if any
    assert got == want


def test_table_sharded_overflow_rescans_every_source(table):
    """ShardedTableBSGSEngine's decoder splits a prober's row by source:
    an overflow of both probers in the first chunk (their candidates
    blanked) rescans both sources' steps on the host (twice, a prober
    each), which alone finds the key."""
    from keyhuntm1cpu_tpu_torch.parallel import ShardedTableBSGSEngine

    key = A + (8 + 2) * STEP + 55  # source 1, local step 2: the first chunk
    eng = _bsgs([key], table, b=A + 16 * STEP, cls=ShardedTableBSGSEngine, devices=CPU2)
    fn = eng._sharded_chunk

    def chunk(bases):
        nxt, (host, ev) = fn(bases)
        if eng.stats.keys_covered == 0 and not chunk.done:
            rows = host[:-1].view(2, -1)
            rows[:, :eng.C2] = 2 * K * U  # no candidate: only the rescan finds the key
            rows[:, -1] = eng.C2 + 1  # each prober's count word
            host[-1] = 1
            chunk.done = True
        return nxt, (host, ev)

    chunk.done = False
    eng._sharded_chunk = chunk
    assert _keys(eng.search_sharded(stop_on_first=False)) == [key]
    rec = REG.last_call("search_sharded")
    assert rec["counters"]["host_rescans"] == 2 * 2 * K
    assert rec["counters"]["cascade_overflows"] == 2 * 2
