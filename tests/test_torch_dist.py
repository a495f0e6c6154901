"""The port's coordinator/worker fleet (keyhuntm1cpu_tpu_torch/dist): the
coordinator cases of tests/test_dist.py parametrised over both packages'
coordinators; wire interop (a port worker against a JAX coordinator and a
JAX worker against the port's); and the port's workers with the port's
BSGS, brute and minikeys engines on the CPU: planted keys recovered
exactly once, an expired lease reclaimed, a graceful stop requeueing the
partial unit. Exact checks."""

import hashlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu import dist as jdist  # noqa: E402
from keyhuntm1cpu_tpu.dist import coordinator as jcoord  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref, hashref  # noqa: E402
from keyhuntm1cpu_tpu_torch import dist as tdist  # noqa: E402
from keyhuntm1cpu_tpu_torch.dist import coordinator as tcoord  # noqa: E402
from keyhuntm1cpu_tpu_torch.dist import worker as tworker  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import common  # noqa: E402

torch.set_num_threads(1)
PKGS = {"jax": (jdist, jcoord), "torch": (tdist, tcoord)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _serve(d, coord):
    srv = d.CoordinatorServer(("127.0.0.1", 0), coord)
    srv.start_background()
    return srv, srv.server_address[1]


def _drain(c, wid="w"):
    out = []
    while True:
        r = c.request_work(wid)
        if r["unit"] is None:
            return out
        out.append(r["unit"])


# --- tests/test_dist.py's coordinator cases, over both packages -------------

def test_unit_partitioning_alignment(pkg):
    d, _ = pkg
    c = d.WorkCoordinator(0x1000, 0x2000, n_units=3, align=0x400)
    c.register("w")
    units = [(int(u["start"], 16), int(u["end"], 16)) for u in _drain(c)]
    assert units[0][0] == 0x1000 and units[-1][1] == 0x2000
    for (a1, b1), (a2, _) in zip(units, units[1:]):
        assert b1 == a2 and (b1 - a1) % 0x400 == 0


def test_lease_expiry_reassigns(pkg):
    d, _ = pkg
    c = d.WorkCoordinator(0, 100, n_units=1, lease_s=0.05)
    r = c.request_work("w1")
    assert r["unit"] is not None
    assert c.request_work("w2")["unit"] is None
    time.sleep(0.08)
    r2 = c.request_work("w2")
    assert r2["unit"]["unit_id"] == r["unit"]["unit_id"]


def test_heartbeat_renews_lease(pkg):
    d, _ = pkg
    c = d.WorkCoordinator(0, 100, n_units=1, lease_s=0.1)
    uid = c.request_work("w1")["unit"]["unit_id"]
    for _ in range(3):
        time.sleep(0.06)
        c.heartbeat("w1", uid)
        assert c.request_work("w2")["unit"] is None


def test_stop_on_first(pkg):
    d, _ = pkg
    c = d.WorkCoordinator(0, 100, n_units=10, stop_on_first=True)
    r = c.request_work("w1")
    assert c.report("w1", r["unit"]["unit_id"], "found", found=["abc123"])["stop"]
    assert c.request_work("w2")["done"]
    assert c.found_keys()[0]["private_key"] == "abc123"


def test_failed_unit_requeued(pkg):
    d, _ = pkg
    c = d.WorkCoordinator(0, 100, n_units=1)
    r = c.request_work("w1")
    c.report("w1", r["unit"]["unit_id"], "failed")
    assert c.request_work("w2")["unit"] is not None


def test_completion(pkg):
    d, _ = pkg
    c = d.WorkCoordinator(0, 100, n_units=2, stop_on_first=False)
    for u in _drain(c):
        c.report("w", u["unit_id"], "done")
    st = c.status()
    assert c.is_done() and st["completed"] == 2 and st["pending"] == 0


def test_workers_find_planted_key_over_tcp(pkg):
    d, _ = pkg
    coord = d.WorkCoordinator(0, 1000, n_units=8, stop_on_first=True)
    srv, port = _serve(d, coord)
    try:
        def search(a, b):
            return [f"{777:x}"] if a <= 777 < b else []

        workers = [d.DistributedWorker("127.0.0.1", port, search, heartbeat_s=0.5)
                   for _ in range(3)]
        threads = [threading.Thread(target=w.run) for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert [f["private_key"] for f in coord.found_keys()] == ["309"]
        assert coord.status()["stopped"]
    finally:
        srv.shutdown()


def test_rpc_status(pkg):
    d, c = pkg
    coord = d.WorkCoordinator(0, 10, n_units=1)
    srv, port = _serve(d, coord)
    try:
        st = c.rpc("127.0.0.1", port, {"op": "status"})
        assert st["ok"] and st["n_units"] == 1
        assert not c.rpc("127.0.0.1", port, {"op": "bogus"})["ok"]
    finally:
        srv.shutdown()


def test_all_units_processed_no_key(pkg):
    d, _ = pkg
    coord = d.WorkCoordinator(0, 64, n_units=4, stop_on_first=True)
    srv, port = _serve(d, coord)
    try:
        w = d.DistributedWorker("127.0.0.1", port, lambda a, b: [])
        w.run()
        assert w.units_done == 4 and coord.is_done() and coord.found_keys() == []
    finally:
        srv.shutdown()


def test_coordinator_restart_restores_progress(pkg, tmp_path):
    d, _ = pkg
    sf = str(tmp_path / "coord.json")
    c1 = d.WorkCoordinator(0, 100, n_units=4, stop_on_first=False, state_file=sf)
    r1 = c1.request_work("w")
    c1.report("w", r1["unit"]["unit_id"], "done")
    r2 = c1.request_work("w")
    c1.report("w", r2["unit"]["unit_id"], "found", found=["beef"])
    c2 = d.WorkCoordinator(0, 100, n_units=4, stop_on_first=False, state_file=sf)
    st = c2.status()
    assert (st["completed"], st["pending"]) == (2, 2)
    assert [f["private_key"] for f in c2.found_keys()] == ["beef"]
    remaining = {u["unit_id"] for u in _drain(c2, "w2")}
    assert remaining == {0, 1, 2, 3} - {r1["unit"]["unit_id"], r2["unit"]["unit_id"]}


def test_state_file_loads_in_the_other_package(tmp_path):
    """A state file of either coordinator restores the other's progress."""
    for writer, reader in ((jdist, tdist), (tdist, jdist)):
        sf = str(tmp_path / f"{writer.__name__}.json")
        c1 = writer.WorkCoordinator(0, 100, n_units=4, stop_on_first=False, state_file=sf)
        r = c1.request_work("w")
        c1.report("w", r["unit"]["unit_id"], "found", found=["abc"])
        c2 = reader.WorkCoordinator(0, 100, n_units=4, stop_on_first=False, state_file=sf)
        assert c2.status()["completed"] == 1 and c2.found_keys() == c1.found_keys()


# --- wire interop ------------------------------------------------------------

@pytest.mark.parametrize("server,client", [(jdist, tdist), (tdist, jdist)])
def test_wire_interop(server, client):
    """A worker of one package drains a coordinator of the other."""
    coord = server.WorkCoordinator(0, 4096, n_units=8, stop_on_first=False)
    srv, port = _serve(server, coord)
    try:
        seen = []

        def search(a, b):
            seen.append((a, b))
            return [f"{k:x}" for k in (1000, 3000) if a <= k < b]

        w = client.DistributedWorker("127.0.0.1", port, search, worker_id="x", poll_s=0.1)
        t = threading.Thread(target=w.run)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        st = coord.status()
        assert st["completed"] == 8 and st["done"] and w.units_done == 8
        assert sorted(seen) == [(512 * i, 512 * (i + 1)) for i in range(8)]
        assert sorted(f["private_key"] for f in coord.found_keys()) == ["3e8", "bb8"]
    finally:
        srv.shutdown()


# --- the port's workers with the port's engines, on the CPU ------------------

def _run_workers(workers, timeout=300):
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()


def test_two_workers_port_bsgs_with_lease_expiry():
    """Two port workers with the port's BSGS engine (device resolve on the
    CPU, one table built for both) share a coordinator; one unit's lease
    is backdated and reclaimed; the planted key is found exactly once."""
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams

    key = 0xA0B2C3  # in the fourth unit
    params = BSGSParams(m=256, block_u=16, steps_per_chunk=2)
    chunk = params.steps_per_chunk * params.block_u * 2 * params.m  # 16384 keys
    coord = tdist.WorkCoordinator(0xA00000 - chunk, 0xA00000 + 4 * chunk, n_units=5,
                                  align=chunk, lease_s=60.0, stop_on_first=False)
    srv, port = _serve(tdist, coord)
    try:
        ghost = coord.request_work("ghost")
        with coord._lock:
            uid = int(ghost["unit"]["unit_id"])
            unit, lease = coord._assigned[uid]
            coord._assigned[uid] = (unit, type(lease)("ghost", 0.0))
        fn = tworker.bsgs_search_fn([ecref.scalar_mult(key)], params, device="cpu")
        workers = [tdist.DistributedWorker("127.0.0.1", port, fn, worker_id=f"w{i}",
                                           poll_s=0.1) for i in range(2)]
        _run_workers(workers)
        st = coord.status()
        assert st["completed"] == 5
        assert [f["private_key"] for f in coord.found_keys()] == [f"{key:x}"]
        assert sum(w.units_done for w in workers) == 5
        leased = sorted(u["unit_id"] for w in workers for u in w.units)
        assert leased == [0, 1, 2, 3, 4]  # the ghost's unit once, by a worker
        assert sum(t["first"] for t in fn.timings) == 1  # one resident table
        assert [t["keys"] for t in fn.timings] == [chunk] * 5
    finally:
        srv.shutdown()


def test_port_worker_brute_finds_all_hits():
    """A port worker with the port's fused brute engine reports every hit
    of its units (exhaustive units), each once."""
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteParams
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    keys = [0x90100, 0x90280, 0x90500]  # units 0, 0 and 1
    raw = [hashref.pubkey_to_hash160(ecref.scalar_mult(k), compressed=True) for k in keys]
    ts = TargetSet(kind="hash160", raw=raw, labels=[str(k) for k in keys])
    params = BruteParams(block_u=128, steps_per_chunk=2)
    coord = tdist.WorkCoordinator(0x90000, 0x90000 + 4 * 1024, n_units=4, align=256,
                                  lease_s=60.0, stop_on_first=False)
    srv, port = _serve(tdist, coord)
    try:
        fn = tworker.brute_search_fn(ts, mode="rmd160", params=params, device="cpu")
        w = tdist.DistributedWorker("127.0.0.1", port, fn, worker_id="bw0", poll_s=0.1)
        _run_workers([w])
        assert coord.status()["completed"] == 4
        got = sorted(int(f["private_key"], 16) for f in coord.found_keys())
        assert got == keys
        assert [t["keys"] for t in fn.timings] == [1024] * 4
    finally:
        srv.shutdown()


def _first_valid_minikey(prefix, start=0):
    alpha = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
    c = start
    while True:
        mk = prefix + "11111" + "".join(alpha[c // 58 ** i % 58] for i in range(4, -1, -1))
        if hashlib.sha256((mk + "?").encode()).digest()[0] == 0:
            return mk, c
        c += 1


def test_port_worker_minikeys_over_counter_units():
    """Minikeys units are suffix-counter ranges: the planted minikey's unit
    finds it, the others do not, and no chunk crosses its unit."""
    from keyhuntm1cpu_tpu_torch.engine.minikeys import MinikeyParams
    from keyhuntm1cpu_tpu_torch.utils.targets import targets_from_ints

    prefix = "SkeyhuntDSTx"
    mk, c = _first_valid_minikey(prefix)
    k = int.from_bytes(hashlib.sha256(mk.encode()).digest(), "big")
    ts = targets_from_ints("hash160", [hashref.pubkey_to_hash160(ecref.scalar_mult(k), False)])
    lo = max(0, (c // 256 - 1) * 256)
    hi = (c // 256 + 2) * 256
    coord = tdist.WorkCoordinator(lo, hi, n_units=(hi - lo) // 256, align=256,
                                  lease_s=60.0, stop_on_first=False)
    srv, port = _serve(tdist, coord)
    try:
        fn = tworker.minikeys_search_fn(
            ts, prefix, params=MinikeyParams(batch=256, valid_max=16, hit_max=8),
            device="cpu")
        w = tdist.DistributedWorker("127.0.0.1", port, fn, worker_id="mk", poll_s=0.1)
        _run_workers([w])
        assert [f["private_key"] for f in coord.found_keys()] == [f"{k:x}"]
        assert coord.found_keys()[0]["unit_id"] == (c - lo) // 256
        assert [t["keys"] for t in fn.timings] == [256] * ((hi - lo) // 256)
    finally:
        srv.shutdown()


def test_port_worker_graceful_stop_requeues_partial_unit():
    """A stop request during a unit (SIGTERM's flag) stops the port's BSGS
    engine at its first chunk boundary; the worker reports the unit
    failed, it is requeued, and the worker exits its loop."""
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams

    params = BSGSParams(m=256, block_u=16, steps_per_chunk=2)
    chunk = params.steps_per_chunk * params.block_u * 2 * params.m
    coord = tdist.WorkCoordinator(1 << 40, (1 << 40) + 8 * chunk, n_units=4, align=chunk,
                                  lease_s=60.0, stop_on_first=False)
    srv, port = _serve(tdist, coord)
    inner = tworker.bsgs_search_fn([ecref.scalar_mult(5)], params, device="cpu")

    def search(a, b):
        common.request_stop()  # preemption arrives as the unit starts
        return inner(a, b)

    try:
        w = tdist.DistributedWorker("127.0.0.1", port, search, worker_id="gs", poll_s=0.1)
        _run_workers([w], timeout=120)
        st = coord.status()
        assert (w.units_done, st["completed"], st["pending"]) == (0, 0, 4)
        assert [u["status"] for u in w.units] == ["failed"]
        assert inner.timings[0]["keys"] < 2 * chunk  # the unit was not covered
    finally:
        common.clear_stop()
        srv.shutdown()


def test_worker_main_arguments(monkeypatch, tmp_path):
    """The worker CLI: -v reaches the brute search function, bad
    combinations exit 2, and --device cuda without a GPU exits 2."""
    captured = {}

    def fake_brute_search_fn(targets, mode, params, intervals=None, prefixes=None,
                             device="cuda"):
        captured.update(targets=targets, mode=mode, intervals=intervals,
                        prefixes=prefixes, device=device)
        return lambda a, b: []

    class FakeWorker:
        def __init__(self, *a, **kw):
            self.worker_id, self.units_done, self.units = "t", 0, []

        def run(self):
            return []

    monkeypatch.setattr(tworker, "brute_search_fn", fake_brute_search_fn)
    monkeypatch.setattr(tworker, "DistributedWorker", FakeWorker)
    tworker.main(["-c", "h:1", "-m", "rmd160", "-v", "1Love", "--device", "cpu"])
    assert captured["mode"] == "rmd160" and captured["device"] == "cpu"
    assert len(captured["targets"].raw) == 0 and captured["prefixes"] == ["1Love"]
    assert len(captured["intervals"]) >= 1
    for argv in (["-m", "xpoint", "-v", "1Love"], ["-m", "rmd160"], ["-m", "bsgs"],
                 ["-m", "minikeys", "-f", str(tmp_path / "x")]):
        with pytest.raises(SystemExit) as e:
            tworker.main(["-c", "h:1", "--device", "cpu", *argv])
        assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tworker.main(["-c", "h:1", "-m", "rmd160", "-v", "1Love"])
    assert e.value.code == 2
