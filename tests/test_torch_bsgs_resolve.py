"""Port BSGS engine (keyhuntm1cpu_tpu_torch/engine/bsgs.py) vs the JAX
engine, in both resolve modes, on the CPU: found sets on the cases of
tests/test_bsgs.py at its shapes (m = 512, U = 16, K = 4; the immediate
hit at m = 256, K = 2): mid-range, range start, a key at a giant-step
center (a degenerate lane), a key at a baby window's edge, two targets,
the exact host rescan after a cascade overflow, a base center at a
target's key, the bloom2 stage forced on, the five range orders and a
checkpoint resume. The JAX side is its device-resolve engine over
host_baby_table; the port runs each case once with resolve="device" (its
own table, built on the CPU) and once with resolve="host" (the native
host table and the streamed filters). Ranges are cut to a few chunks
where the JAX test spans many: a port chunk takes ~0.8 s on the CPU.

Integer arithmetic: the tolerance is exact equality."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.engine import bsgs as jbsgs  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch import convert  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import host_table as ht  # noqa: E402

torch.set_num_threads(1)
JPARAMS = jbsgs.BSGSParams(m=512, block_u=16, steps_per_chunk=4, build_block=128, chain_len=8)
RESOLVE = ["device", "host"]
# the port's pipeline holds two chunks: a stop_on_first search decodes the
# same chunks whatever the depth, and walks fewer on the CPU
DEPTH = 2


def _port_params(jparams, resolve, **kw):
    return dataclasses.replace(convert.params_from_jax(jparams), resolve=resolve,
                               pipeline_depth=DEPTH, **kw)


class _Shared:
    """Per (m, resolve): the structures a port engine shares (bsgsd's
    pattern), built by the first engine."""

    def __init__(self, cache):
        self.cache, self.parts = cache, {}

    def engine(self, pubs, a, b, jparams, resolve, **kw):
        params = _port_params(jparams, resolve, **kw)
        key = (params.m, resolve)
        if key not in self.parts:
            boot = bsgs.BSGSEngine([ecref.G], 1, 2, params, device="cpu",
                                   host_table=(ht.ensure_host_table(params.m, self.cache)
                                               if resolve == "host" else None))
            self.parts[key] = dict(table=boot.table, host_table=boot.host_table,
                                   bitmap=boot.bitmap, bloom2=boot.bloom2)
        return bsgs.BSGSEngine(pubs, a, b, params, device="cpu", **self.parts[key])


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return _Shared(str(tmp_path_factory.mktemp("tc")))


@pytest.fixture(scope="module")
def jtables():
    return {m: jbsgs.host_baby_table(m) for m in (256, 512)}


def _keys(found):
    return sorted(f.private_key for f in found)


def _jax_found(jtables, pubs, a, b, jparams=JPARAMS, **search):
    eng = jbsgs.BSGSEngine(pubs, a, b, jparams, table=jtables[jparams.m])
    return _keys(eng.search(**search))


CASES = {  # name: (keys, a, b, search kwargs); tests/test_bsgs.py's cases
    "mid_range": ([0xA1B2C3], 0xA00000, 0xB00000, {}),
    "range_start": ([0x50000], 0x50000, 0x50000 + 2**18, {}),
    "center_degenerate": ([0x70000 + 512], 0x70000, 0x70000 + 2**18, {}),
    "baby_boundary": ([0x90000 + 1024], 0x90000, 0x90000 + 2**18, {}),
    "two_targets": ([0xA11111, 0xA22222], 0xA00000, 0xA40000, {"stop_on_first": False}),
}


@pytest.mark.parametrize("resolve", RESOLVE)
@pytest.mark.parametrize("case", list(CASES))
def test_found_keys_match_jax(shared, jtables, case, resolve):
    keys, a, b, kw = CASES[case]
    pubs = [ecref.scalar_mult(k) for k in keys]
    want = _jax_found(jtables, pubs, a, b, **kw)
    assert want == keys
    assert _keys(shared.engine(pubs, a, b, JPARAMS, resolve).search(**kw)) == want


@pytest.mark.parametrize("resolve", RESOLVE)
def test_overflow_rescan_recovers_key(shared, jtables, resolve):
    """Every chunk overflows the cascade (a 32-bit bitmap and cand_max = 1
    for the JAX engine; all-pass filters and tiny budgets for the port's):
    the exact host rescan alone finds the key (tests/test_bsgs.py:232)."""
    key, a, b = 0xB4C5D6, 0xB40000, 0xB80000
    pubs = [ecref.scalar_mult(key)]
    jp = dataclasses.replace(JPARAMS, cand_max=1, bits_log2=5)
    assert _jax_found(jtables, pubs, a, b, jp) == [key]
    eng = shared.engine(pubs, a, b, JPARAMS, resolve)
    eng.bitmap = eng.bitmap._replace(words=torch.full_like(eng.bitmap.words, -1))
    if eng.bloom2 is not None:
        eng.bloom2 = eng.bloom2._replace(words=torch.full_like(eng.bloom2.words, -1))
    eng.C1, eng.C2 = 8, 4
    rescans = []
    orig = eng._host_rescan_step
    eng._host_rescan_step = lambda s: rescans.append(s) or orig(s)
    assert _keys(eng.search()) == [key]
    assert rescans[:4] == [0, 1, 2, 3]


@pytest.mark.parametrize("resolve", RESOLVE)
def test_immediate_hit_checks_all_targets(jtables, tmp_path, resolve):
    """A base center at the key of a target that is not the first
    (tests/test_bsgs.py:247), at m = 256, K = 2."""
    jp = jbsgs.BSGSParams(m=256, block_u=16, steps_per_chunk=2, chain_len=8)
    a = 0x900000
    c_base = a + jp.m + (jp.block_u - 1) * 2 * jp.m
    pubs = [ecref.scalar_mult(0x123456789), ecref.scalar_mult(c_base)]
    kw = dict(start_step=1, stop_on_first=False, max_steps=2)
    want = _jax_found(jtables, pubs, a, a + 2**18, jp, **kw)
    assert c_base in want
    eng = bsgs.BSGSEngine(pubs, a, a + 2**18, _port_params(jp, resolve, table_cache=str(tmp_path)),
                          device="cpu")
    with pytest.raises(bsgs._ImmediateHit):
        eng._initial_base(1)
    assert _keys(eng.search(**kw)) == want


@pytest.mark.parametrize("resolve", RESOLVE)
def test_cascade2_on_recovers_keys(shared, jtables, resolve):
    """The bloom2 stage forced on (tests/test_bsgs.py:338): in device
    resolve it sits between the bitmap and the exact search."""
    keys, a, b = [0xA00001, 0xA20000, 0xA3FFFF], 0xA00000, 0xA40000
    pubs = [ecref.scalar_mult(k) for k in keys]
    jp = dataclasses.replace(JPARAMS, cascade2="on")
    assert _jax_found(jtables, pubs, a, b, jp, stop_on_first=False) == keys
    eng = shared.engine(pubs, a, b, jp, resolve)
    assert eng.bloom2 is not None
    assert _keys(eng.search(stop_on_first=False)) == keys


@pytest.mark.parametrize("resolve", RESOLVE)
@pytest.mark.parametrize("policy", ["sequential", "backward", "both", "random", "dance"])
def test_scheduler_policies(shared, jtables, policy, resolve):
    """Every range order finds the key (tests/test_bsgs.py:120), over two
    chunks with the key in the second."""
    key, a, b = 0xC3D4E5, 0xC20000, 0xC40000
    pubs = [ecref.scalar_mult(key)]
    jeng = jbsgs.BSGSEngine(pubs, a, b, JPARAMS, table=jtables[512])
    assert _keys(jeng.search_scheduled(policy=policy, seed=3)) == [key]
    eng = shared.engine(pubs, a, b, JPARAMS, resolve)
    assert _keys(eng.search_scheduled(policy=policy, seed=3)) == [key]


@pytest.mark.parametrize("resolve", RESOLVE)
def test_checkpoint_resume(shared, jtables, tmp_path, resolve):
    """An interrupted scheduled search resumes past the chunks it did and
    finds the key (tests/test_bsgs.py:169), as the JAX engine does."""
    from keyhuntm1cpu_tpu.core.checkpoint import CheckpointManager as JManager
    from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointManager

    key, a, b = 0xE5F607, 0xE40000, 0xE80000
    pubs = [ecref.scalar_mult(key)]
    found = []
    for i, (mk, make) in enumerate(((JManager, lambda: jbsgs.BSGSEngine(
            pubs, a, b, JPARAMS, table=jtables[512])),
            (CheckpointManager, lambda: shared.engine(pubs, a, b, JPARAMS, resolve)))):
        mgr = mk(str(tmp_path / f"ck{i}.json"), every_s=0)
        assert make().search_scheduled(policy="sequential", max_chunks=1, checkpoint=mgr) == []
        assert mgr.load().chunks_done == 1
        found.append(_keys(make().search_scheduled(policy="sequential", checkpoint=mgr)))
        assert mgr.load().found == [f"{key:x}"]
    assert found[0] == found[1] == [key]
