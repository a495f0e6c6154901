"""The set-up guard of the BSGS runners (khbench/runners/bsgs.py
refuse_overflowing_cascade): a layout whose every chunk would overflow the
cascade's budget C2 into the program's exact host rescan is refused after
the engine is made and before the warm-up's first chunk. The tiny cells
pass it in every full run of test_khbench_reference.py."""

import json
import os
from types import SimpleNamespace

import pytest

from khbench import run
from khbench.runners import bsgs as runner
from khbench.runners import common
from khbench.tests.tiny import cell_engines, make_bench

BSGS_CELLS = [c for c, e in cell_engines().items() if e in ("bsgs", "bsgs_sharded")]
# the tiny cut's chunk grown to 2^17 queries (K*U, U = 16): 1,020 pass its
# 2^16-bit bitmap a chunk against C2 = 512; the program's bloom2 leaves 0.25
GROWN_K = 8192


def engine(m: int, U: int, K: int, bits: int, b2: int):
    """What the guard reads of an engine: its targets, parameters and the
    sizes of its two filters."""
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    p = BSGSParams(m=m, block_u=U, steps_per_chunk=K, chunk_cand_max=128, bits_log2=bits,
                   cascade2="on", resolve="device")
    return SimpleNamespace(targets=[None], p=p, bitmap=bmp.DeviceBitmap(None, bits),
                           bloom2=bmp.DeviceBloom2(None, b2))


def test_guard_at_the_deployments_sizes():
    """-k 64 (m = 2^28) passes: ~452 survivors a chunk against C2 = 1,536.
    -k 256 (m = 2^30) with the bloom2 the program builds (2^32 bits, its
    cap) is refused: ~19,980 against C2 = 4,608."""
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    runner.refuse_overflowing_cascade(
        engine(1 << 28, 16384, 256, 35, bmp.bloom2_bits_log2(1 << 28)))
    with pytest.raises(common.Refused,
                       match=r"19978\.5 survivors .* C2 = 4608 .*2\^32-bit bloom2"):
        runner.refuse_overflowing_cascade(
            engine(1 << 30, 16384, 256, 35, bmp.bloom2_bits_log2(1 << 30)))


def test_guard_on_the_grown_tiny_layout():
    """The layout of the refusal test below passes with the bloom2 the
    program sizes for m = 512 and is refused with a 32-bit one."""
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    runner.refuse_overflowing_cascade(engine(512, 16, GROWN_K, 16, bmp.bloom2_bits_log2(512)))
    with pytest.raises(common.Refused, match=r"C2 = 512 "):
        runner.refuse_overflowing_cascade(engine(512, 16, GROWN_K, 16, 5))


@pytest.fixture
def marks(monkeypatch):
    """The set-up marks a run makes, in order."""
    seen = []
    mark = common.Ctx.mark

    def record(self, name):
        seen.append(name)
        mark(self, name)

    monkeypatch.setattr(common.Ctx, "mark", record)
    return seen


@pytest.mark.parametrize("cell", BSGS_CELLS)
def test_undersized_bloom2_is_refused_before_the_warm_up(tmp_path, monkeypatch, marks, cell):
    """The program made to size a 32-bit bloom2, in the tiny cell with its
    chunk grown: run_cell raises in set-up, with no chunk dispatched."""
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.parallel import mesh

    tiny = make_bench(str(tmp_path))
    with open(tiny) as f:
        bench = json.load(f)
    (w,) = [w for w in bench["workloads"] if w["name"] == cell]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    path = os.path.join(str(tmp_path), c["file"])
    with open(path) as f:
        cfg = json.load(f)
    cfg["steps_per_chunk"] = GROWN_K
    with open(path, "w") as f:
        json.dump(cfg, f)

    monkeypatch.setattr(bmp, "bloom2_bits_log2", lambda m: 5)
    chunks = []

    def no_chunk(*args, **kw):
        chunks.append(args)
        raise AssertionError("a chunk was dispatched")

    for mod, name in ((bsgs, "chunk_impl"), (bsgs, "chunk_impl_host"), (mesh, "chunk_impl")):
        monkeypatch.setattr(mod, name, no_chunk)
    with pytest.raises(common.Refused, match=r"survivors expected a chunk against the budget "
                                             r"C2 = 512 \(131072 queries, m = 512, a 2\^16-bit "
                                             r"bitmap, a 2\^5-bit bloom2\)"):
        run.run_cell(tiny, cell, 2718281830, 0.5, False, device="cpu")
    assert not chunks
    assert "engine" in marks and "warm-up" not in marks
