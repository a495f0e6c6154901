"""Position checkpoints and graceful stop in the port
(keyhuntm1cpu_tpu_torch/core/checkpoint.py, engine/common.py) on the CPU:

- a checkpoint file written by the JAX package's CheckpointManager loads
  in the port's and the other way round, with the same sha256;
- kill and resume in the fused brute, walker brute, vanity and minikeys
  searches (tests/test_checkpoints.py's cases on the port's engines): the
  resumed run skips the covered span, reports the saved finds and reaches
  the late key; a run of another range or mode raises CheckpointError;
  with -R the resumed run draws the bases an uninterrupted run draws;
- the stop flag ends a search at a chunk boundary, and SIGTERM on the CLI
  stops at one with its checkpoint saved.

Keys and counts are compared exactly."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.core import checkpoint as jck  # noqa: E402
from keyhuntm1cpu_tpu_torch.core.checkpoint import (Checkpoint, CheckpointManager,  # noqa: E402
                                                     fingerprint)
from keyhuntm1cpu_tpu_torch.core.errors import CheckpointError  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import common  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import minikeys as mk  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.vanity import vanity_intervals  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet, targets_from_ints  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED = BruteParams(block_u=128, steps_per_chunk=2)
WALKER = BruteParams(walkers=2, block_u=32, steps_per_chunk=2, chain_len=8, compare_max=0,
                     bucket_max=0)


def _targets(keys):
    return TargetSet(kind="hash160", labels=[str(k) for k in keys],
                     raw=[hashref.pubkey_to_hash160(ecref.scalar_mult(k)) for k in keys])


def _mgr(path):
    return CheckpointManager(str(path), every_s=0)


def _keys(found):
    return sorted(f.private_key for f in found)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_load_in_both_packages(tmp_path, monkeypatch, writer):
    monkeypatch.setattr(time, "time", lambda: 1234.5)  # one saved_at for every save
    fields = dict(mode="bsgs", range_start=(1 << 200) + 5, range_end=1 << 201,
                  policy="random", seed=7, params_fp=fingerprint(1 << 20, 1024, 16),
                  targets_fp=fingerprint(sorted([(5, 6)])), chunks_done=3, n_chunks=9,
                  keys_covered=1 << 70, found=["abc", "123"],
                  extra={"prefix": "Sabc", "counter": 77})
    assert fields["params_fp"] == jck.fingerprint(1 << 20, 1024, 16)
    path, path2 = str(tmp_path / "ck.json"), str(tmp_path / "ck2.json")
    if writer == "jax":
        src, dst = jck, sys.modules[Checkpoint.__module__]
    else:
        src, dst = sys.modules[Checkpoint.__module__], jck
    src.CheckpointManager(path).save(src.Checkpoint(**fields), force=True)
    env = json.load(open(path))
    back = dst.CheckpointManager(path).load()  # the checksum holds in the reader
    assert back.to_dict() == env["payload"]
    assert {k: getattr(back, k) for k in fields} == fields
    # the reader writes the same checkpoint as the writer: payload and sha256
    dst.CheckpointManager(path2).save(dst.Checkpoint(**fields), force=True)
    assert json.load(open(path2)) == env
    # a changed payload fails the checksum in both packages
    env["payload"]["chunks_done"] = 4
    json.dump(env, open(path, "w"))
    for mgr in (CheckpointManager(path), jck.CheckpointManager(path)):
        with pytest.raises(Exception, match="checksum"):
            mgr.load()


@pytest.mark.parametrize("path_kind", ["fused", "walker"])
def test_brute_checkpoint_resume(tmp_path, path_kind):
    """Fused: 8 chunks over [1, 2049), keys in chunks 0 and 5; walker
    (tests/test_checkpoints.py:26): walkers of 260 keys over [1, 521)."""
    params, b, late = (FUSED, 2049, 1500) if path_kind == "fused" else (WALKER, 521, 250)
    ts = _targets([40, late])
    eng = BruteEngine(ts, 1, b, mode="rmd160", params=params, device="cpu")
    assert eng._walker == (path_kind == "walker")
    f1 = eng.search(max_steps=2, checkpoint=_mgr(tmp_path / "ck.json"))
    ck = _mgr(tmp_path / "ck.json").load()
    assert ck.chunks_done == 2 and ck.mode == "brute:rmd160"
    assert _keys(f1) == [40] and ck.found == [f"{40:x}"]
    assert ck.keys_covered == eng.stats.keys_covered > 0

    eng2 = BruteEngine(ts, 1, b, mode="rmd160", params=params, device="cpu")
    f2 = eng2.search(checkpoint=_mgr(tmp_path / "ck.json"))
    assert _keys(f2) == [40, late]  # the saved find, then the rest of the range
    end = _mgr(tmp_path / "ck.json").load()
    if path_kind == "fused":  # every step of U keys, once
        total, keys = eng2._fast_total_steps, eng2._fast_total_steps * 128
    else:  # every walker's windows of 2U + 1 keys, once
        total, keys = eng2.steps_per_walker, eng2.steps_per_walker * 2 * 65
    assert end.chunks_done == total
    assert end.keys_covered == eng2.stats.keys_covered == keys

    other = BruteEngine(ts, 1, b + 1024, mode="rmd160", params=params, device="cpu")
    with pytest.raises(CheckpointError):
        other.search(checkpoint=_mgr(tmp_path / "ck.json"))


def test_random_mode_resume_replays_the_draws(tmp_path, monkeypatch):
    """-R: 2 chunks, then a resumed run of 2 more, draw the bases of one
    uninterrupted run of 4 (the fused path's one draw per chunk)."""
    ts = _targets([40])
    params = BruteParams(block_u=128, steps_per_chunk=2, random_mode=True, seed=9)
    bases = []
    orig = BruteEngine._fast_base
    monkeypatch.setattr(BruteEngine, "_fast_base",
                        lambda self, s0: bases.append(s0) or orig(self, s0))
    BruteEngine(ts, 1, 1 << 16, mode="rmd160", params=params, device="cpu").search(max_steps=8)
    whole, bases[:] = list(bases), []
    for steps in (4, 8):
        BruteEngine(ts, 1, 1 << 16, mode="rmd160", params=params, device="cpu").search(
            max_steps=steps, checkpoint=_mgr(tmp_path / "ck.json"))
    assert bases == whole and len(set(whole)) == 4
    assert _mgr(tmp_path / "ck.json").load().chunks_done == 4


def test_vanity_checkpoint_resume(tmp_path):
    """tests/test_checkpoints.py:68: a prefix of key 900's address, found
    only by the resumed run."""
    prefix = hashref.pubkey_to_address(ecref.scalar_mult(900))[:6]
    empty = TargetSet(kind="hash160", raw=[], labels=[])

    def engine(b=1025):
        return BruteEngine(empty, 1, b, mode="rmd160", params=FUSED, device="cpu",
                           intervals=vanity_intervals(prefix), prefixes=[prefix])

    assert engine().search(max_steps=2, checkpoint=_mgr(tmp_path / "ck.json")) == []
    assert _mgr(tmp_path / "ck.json").load().chunks_done == 2
    assert 900 in _keys(engine().search(checkpoint=_mgr(tmp_path / "ck.json")))
    with pytest.raises(CheckpointError):  # another prefix set
        BruteEngine(empty, 1, 1025, mode="rmd160", params=FUSED, device="cpu",
                    intervals=vanity_intervals("1BgG"), prefixes=["1BgG"]).search(
            checkpoint=_mgr(tmp_path / "ck.json"))


def test_minikeys_checkpoint_resume(tmp_path):
    """tests/test_checkpoints.py:87 on the port's engine."""
    prefix = "SkeyhuntTPUx"

    def mk_of(c):
        return prefix + mk._b58_digits(c // mk.LOW_SPAN, 5) + mk._b58_digits(c % mk.LOW_SPAN, 5)

    c = 256  # beyond chunk 0
    while hashref.sha256((mk_of(c) + "?").encode())[0] != 0:
        c += 1
    k = int.from_bytes(hashref.sha256(mk_of(c).encode()), "big")
    ts = targets_from_ints("hash160", [hashref.pubkey_to_hash160(ecref.scalar_mult(k), False)])
    params = mk.MinikeyParams(batch=256, valid_max=64)
    eng = mk.MinikeyEngine(ts, prefix=prefix, params=params, device="cpu")
    assert eng.search(max_chunks=1, checkpoint=_mgr(tmp_path / "ck.json")) == []
    ck = _mgr(tmp_path / "ck.json").load()
    assert ck.extra == {"prefix": prefix, "counter": 256} and ck.keys_covered == 256

    eng2 = mk.MinikeyEngine(ts, params=params, device="cpu")  # a random prefix
    f2 = eng2.search(max_chunks=(c - 256) // 256 + 1, checkpoint=_mgr(tmp_path / "ck.json"))
    assert eng2.prefix == prefix  # adopted from the checkpoint
    assert [f.private_key for f in f2] == [k]
    ck = _mgr(tmp_path / "ck.json").load()
    assert ck.extra["counter"] == eng2.counter == 256 * ((c - 256) // 256 + 2)
    assert ck.found == [f"{k:x}"]
    # a resumed run reports the saved find again
    eng3 = mk.MinikeyEngine(ts, params=params, device="cpu")
    assert [f.private_key for f in eng3.search(max_chunks=0, checkpoint=_mgr(
        tmp_path / "ck.json"))] == [k]
    with pytest.raises(CheckpointError):  # other targets
        mk.MinikeyEngine(targets_from_ints("hash160", [b"\x01" * 20]), params=params,
                         device="cpu").search(checkpoint=_mgr(tmp_path / "ck.json"))


def test_stop_flag_ends_searches_at_a_chunk_boundary(tmp_path):
    assert not common.Deadline(None).expired()
    common.request_stop()
    try:
        assert common.stop_requested() and common.Deadline(None).expired()
        eng = BruteEngine(_targets([40]), 1, 2049, mode="rmd160", params=FUSED, device="cpu")
        assert eng.search(checkpoint=_mgr(tmp_path / "ck.json")) == []
        assert eng.stats.keys_covered == 0
    finally:
        common.clear_stop()
    assert not common.stop_requested() and not common.Deadline(None).expired()


def test_sigterm_graceful_stop_saves_checkpoint(tmp_path):
    """tests/test_checkpoints.py:120 on the port's CLI."""
    h = hashref.pubkey_to_hash160(ecref.scalar_mult(0x7FFFFF0), True)
    rmd = tmp_path / "t.rmd"
    rmd.write_text(h.hex() + "\n")
    ck = tmp_path / "ck.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "keyhuntm1cpu_tpu_torch.cli", "-m", "rmd160", "-f", str(rmd),
         "-r", "100000:8000000", "-u", "128", "--chunk-steps", "2", "--device", "cpu",
         "--checkpoint", str(ck), "--checkpoint-every", "0"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    while time.time() < deadline and not ck.exists():
        time.sleep(0.2)
        assert proc.poll() is None, proc.communicate()[0][-2000:]
    assert ck.exists(), "no checkpoint before the signal"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode in (0, 1), out[-2000:]
    assert "stop requested" in out
    saved = json.loads(ck.read_text())["payload"]
    assert saved["keys_covered"] > 0 and saved["chunks_done"] % 2 == 0
    assert saved["keys_covered"] == saved["chunks_done"] * 128
