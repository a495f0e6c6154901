"""Port multi-host runtime (keyhuntm1cpu_tpu_torch/dist/multihost.py) on
the CPU: two OS processes join a gloo process group (rank and world size
only), take disjoint window-aligned slices, and the one owning the planted
key finds it and reports it once to the port's coordinator, whose stop
flag it sets (tests/test_multihost.py's protocol); once with the
single-device engine, once with the baby table sharded over two CPU
devices in each process. process_slice equals the JAX package's.
Exact checks (integers)."""

import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from keyhuntm1cpu_tpu.dist.multihost import process_slice as jprocess_slice  # noqa: E402
from keyhuntm1cpu_tpu_torch.dist.coordinator import (CoordinatorServer,  # noqa: E402
                                                     WorkCoordinator)
from keyhuntm1cpu_tpu_torch.dist.multihost import process_slice  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = 0xABC123
A, B = 0xA00000, 0xC00000

_CHILD = r"""
import sys
import torch

torch.set_num_threads(1)
from keyhuntm1cpu_tpu_torch.dist.multihost import (initialize, process_count,
                                                    search_bsgs_multihost)
from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams

coord, pid, report_port, pub_hex, sharded = sys.argv[1:6]
initialize(coord, 2, int(pid))
assert process_count() == 2
x, y = (int(t, 16) for t in pub_hex.split(":"))
found = search_bsgs_multihost(
    [(x, y)], 0xA00000, 0xC00000,
    BSGSParams(m=256, block_u=64, steps_per_chunk=16, build_block=64),
    report_addr=("127.0.0.1", int(report_port)), device="cpu",
    sharded=None if sharded == "none" else sharded, devices=["cpu", "cpu"])
print("CHILD", pid, "found", [hex(f.private_key) for f in found], flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n,i", [(1, 0), (2, 0), (2, 1), (3, 2), (8, 5), (64, 63)])
def test_process_slice_equals_jax(n, i):
    for window in (1, 32768, 1 << 20):
        got = process_slice(A, B, window, n=n, i=i)
        want = jprocess_slice(A, B, window, n=n, i=i)
        assert (got.start, got.end, got.step0) == (want.start, want.end, want.step0)


@pytest.mark.parametrize("sharded", ["none", "table"])
def test_two_process_multihost_search(sharded):
    window = 64 * 2 * 256
    owners = [process_slice(A, B, window, n=2, i=i) for i in (0, 1)]
    assert [sl.start <= KEY < sl.end for sl in owners] == [True, False]
    report_port = _free_port()
    coord = WorkCoordinator(1, 2, n_units=1)  # the report sink
    srv = CoordinatorServer(("127.0.0.1", report_port), coord)
    srv.start_background()
    procs = []
    try:
        x, y = ecref.scalar_mult(KEY)
        env = dict(os.environ, PYTHONPATH=REPO)
        rdv = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, rdv, str(pid), str(report_port), f"{x:x}:{y:x}",
             sharded], env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for pid in (0, 1)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-2000:]
        assert f"CHILD 0 found ['{hex(KEY)}']" in outs[0] and "CHILD 1 found []" in outs[1]
        assert [f["private_key"] for f in coord.found_keys()] == [f"{KEY:x}"]
        assert coord.status()["stopped"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        srv.shutdown()


def test_two_process_multihost_cli(tmp_path):
    """python -m keyhuntm1cpu_tpu_torch.dist.multihost in two processes:
    rank 0 finds the key (exit 0, KEYFOUNDKEYFOUND.txt), rank 1 none (1)."""
    x, y = ecref.scalar_mult(KEY)
    (tmp_path / "t.pub").write_text(f"{2 + (y & 1):02x}{x:064x}\n")
    report_port = _free_port()
    coord = WorkCoordinator(1, 2, n_units=1)
    srv = CoordinatorServer(("127.0.0.1", report_port), coord)
    srv.start_background()
    procs = []
    try:
        rdv = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "keyhuntm1cpu_tpu_torch.dist.multihost", "--coordinator",
             rdv, "--num-processes", "2", "--process-id", str(pid), "--report",
             f"127.0.0.1:{report_port}", "-f", "t.pub", "-r", "a00000:c00000",
             "--m-babies", "256", "-u", "64", "--chunk-steps", "16", "--device", "cpu"],
            env=dict(os.environ, PYTHONPATH=REPO), cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 1], outs
        assert f"FOUND {KEY:064x} (process 0)" in outs[0]
        assert f"Private key: {KEY:064x}" in (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
        assert [f["private_key"] for f in coord.found_keys()] == [f"{KEY:x}"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        srv.shutdown()
