"""Port range-sharded brute force (keyhuntm1cpu_tpu_torch/parallel/
brute_mesh.py ShardedBruteEngine) vs the JAX package's, on the CPU: the
JAX engine on 4 of the conftest's CPU devices (its XLA twin of the fused
chunk), the port's on [torch.device("cpu")] * 4 with the plain versions
of K1, K4 and the compaction.

- the found set equals the JAX engine's on tests/test_parallel.py's case
  (a key in the last shard's slice), and vanity intervals beside exact
  targets find what the single-device engine finds;
- children on one device share its target structures;
- the orchestration on synthetic chunks with the real summary layout
  (tests/test_parallel.py's TestShardedBrute): a hit decoded in a later
  shard, quiet chunks never decoded, a degenerate shard rescanned and every
  shard rebased; checkpoints resume, and a mismatched run raises;
- -R and a walker-path target set are refused.

Integer arithmetic: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from keyhuntm1cpu_tpu.engine.brute import BruteParams as JBruteParams  # noqa: E402
from keyhuntm1cpu_tpu.parallel.brute_mesh import ShardedBruteEngine as JShardedBrute  # noqa: E402
from keyhuntm1cpu_tpu.utils.targets import TargetSet as JTargetSet  # noqa: E402
from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from keyhuntm1cpu_tpu_torch.core.errors import CheckpointError  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import vanity  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.common import summary_to_host  # noqa: E402
from keyhuntm1cpu_tpu_torch.parallel import ShardedBruteEngine  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet  # noqa: E402

torch.set_num_threads(1)
PARAMS = BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64, pipeline_depth=2)
CPU4 = [torch.device("cpu")] * 4


def _targets(keys, cls=TargetSet):
    return cls(kind="hash160", raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(k))
                                    for k in keys], labels=[hex(k) for k in keys])


def _engine(keys=(0x90150,), a=0x90000, span=1 << 12, **kw):
    return ShardedBruteEngine(_targets(keys), a, a + span, mode="rmd160", params=PARAMS,
                              devices=CPU4, **kw)


def _keys(found):
    return sorted(f.private_key for f in found)


def test_found_set_equals_jax():
    """tests/test_parallel.py::test_sharded_brute_end_to_end_xla_twin's case."""
    a = 0x90000
    span = 256 * 2 * 4 * 8  # 4 chunks a shard
    key = a + span - 5 * 256  # in the last shard's slice
    jeng = JShardedBrute(_targets([key], JTargetSet), a, a + span, mode="rmd160",
                         params=JBruteParams(block_u=256, steps_per_chunk=4, pallas_sb=4,
                                             chunk_cand=64, pipeline_depth=2),
                         devices=jax.devices()[:4])
    want = _keys(jeng.search_sharded(stop_on_first=False))
    eng = _engine(keys=[key], a=a, span=span)
    assert [(s.start, s.end, s.step0) for s in eng.slices] == [
        (s.start, s.end, s.step0) for s in jeng.slices]
    assert eng.local_steps == jeng.local_steps == 16
    assert _keys(eng.search_sharded(stop_on_first=False)) == want == [key]
    # the children share the one device's structures
    assert len({id(c._tgt) for c in eng.children}) == 1
    assert len({id(c.tab_x) for c in eng.children}) == 1


def test_vanity_intervals_beside_targets_match_single_device():
    prefix = hashref.pubkey_to_address(ecref.scalar_mult(700))[:6]
    ivs = vanity.vanity_intervals(prefix)
    kw = dict(mode="rmd160", params=PARAMS, intervals=ivs, prefixes=[prefix])
    want = BruteEngine(_targets([100, 1900]), 1, 2049, device="cpu", **kw).search()
    eng = ShardedBruteEngine(_targets([100, 1900]), 1, 2049, devices=CPU4, **kw)
    got = eng.search_sharded()
    assert {(f.private_key, f.target) for f in got} == {(f.private_key, f.target)
                                                        for f in want}
    assert {100, 700, 1900} <= {f.private_key for f in got}


def _summary(eng, hits=(), k_eff=None, ncand=0):
    p = eng.p
    C, K, U = p.chunk_cand, p.steps_per_chunk, p.block_u
    arr = np.zeros(2 * C + 3 * K + 1, dtype=np.int32)
    arr[:C] = K * U
    for i, (pos, bits) in enumerate(hits):
        arr[i] = pos
        arr[C + i] = bits
    if k_eff is not None and k_eff < K:
        arr[2 * C + 2 * K + (k_eff - 1)] = 1  # the advance flag
    arr[2 * C + 3 * K] = ncand if ncand else len(hits)
    return arr


def _fake(rows, interest):
    return summary_to_host(torch.from_numpy(np.append(np.stack(rows).reshape(-1),
                                                      np.int32(interest))))


def test_decode_fanout_finds_key_in_later_shard():
    key = 0x90150 + 1024  # inside shard 1
    eng = _engine(keys=(key,))
    j = key - eng.children[1]._fast_a  # stride 1
    calls = []

    def fake_chunk(bases):
        calls.append(1)
        return bases, _fake([_summary(eng), _summary(eng, hits=[(j, 0b01)]), _summary(eng),
                             _summary(eng)], 1)

    eng._sharded_chunk = fake_chunk
    assert _keys(eng.search_sharded(max_steps=4, stop_on_first=True)) == [key]
    assert calls == [1]


def test_zero_interest_skips_decode(monkeypatch):
    eng = _engine()
    decoded = []
    for c in eng.children:
        monkeypatch.setattr(c, "_decode_fast", lambda s, a: decoded.append(1) or (4, []))
    eng._sharded_chunk = lambda bases: (bases, _fake([_summary(eng)] * 4, 0))
    assert eng.search_sharded(max_steps=8) == [] and decoded == []
    assert eng.stats.keys_covered == 1 << 12  # quiet chunks still count


def test_degenerate_shard_rescans_and_rebases():
    key = 0x90000 + 2 * 2048 + 600  # shard 2, local step 2
    eng = _engine(keys=(key,), span=1 << 13)  # 8 local steps a shard
    c2 = eng.children[2]
    rescans, rebases, first = [], [], [True]
    orig_rescan, orig_bases = c2._host_rescan_fast, eng._bases_at
    c2._host_rescan_fast = lambda s0, kk: rescans.append((s0, kk)) or orig_rescan(s0, kk)
    eng._bases_at = lambda s: rebases.append(s) or orig_bases(s)

    def fake_chunk(bases):
        # the first chunk: shard 2 degenerates after 2 of 4 steps; the key
        # sits in step 2 (invalid on the device), found by the host rescan
        if first[0]:
            first[0] = False
            return bases, _fake([_summary(eng), _summary(eng), _summary(eng, k_eff=2),
                                 _summary(eng)], 1)
        return bases, _fake([_summary(eng)] * 4, 0)

    eng._sharded_chunk = fake_chunk
    assert _keys(eng.search_sharded(max_steps=8)) == [key]
    assert rescans == [(2, 2)] and rebases == [0, 4]


def test_checkpoint_resume_and_mismatch(tmp_path):
    dispatched = []

    def fake_chunk(bases):
        dispatched.append(1)
        return bases, _fake([_summary(eng)] * 4, 0)

    eng = _engine(span=1 << 14)  # 16 local steps a shard
    eng._sharded_chunk = fake_chunk
    mgr = CheckpointManager(str(tmp_path / "ck.json"), every_s=0)
    eng.search_sharded(max_steps=8, checkpoint=mgr)
    ck = mgr.load()
    assert ck.chunks_done == 8 and ck.mode == "brute-sharded:rmd160"
    eng = _engine(span=1 << 14)
    eng._sharded_chunk = fake_chunk
    n0 = len(dispatched)
    eng.search_sharded(max_steps=16, checkpoint=mgr)
    assert len(dispatched) - n0 == 2 and mgr.load().chunks_done == 16
    other = _engine(a=0x91000, span=1 << 14)
    other._sharded_chunk = fake_chunk
    with pytest.raises(CheckpointError):
        other.search_sharded(max_steps=16, checkpoint=mgr)


def test_refusals():
    with pytest.raises(ValueError, match="random mode"):
        ShardedBruteEngine(_targets([5]), 1, 1 << 12, params=BruteParams(random_mode=True),
                           devices=CPU4)
    with pytest.raises(ValueError, match="fused path"):
        ShardedBruteEngine(_targets([5]), 1, 1 << 12, params=BruteParams(block_u=100),
                           devices=CPU4)
