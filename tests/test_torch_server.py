"""Port bsgsd (keyhuntm1cpu_tpu_torch/server.py) on the CPU, the cases of
tests/test_server.py: a solved request, 404, 400, 408 at the per-request
deadline and two interleaved requests, on a device-resolve service over
one resident table; and a solved request and a 404 on a host-resolve
service. Keys are compared exactly."""

import socket
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams  # noqa: E402
from keyhuntm1cpu_tpu_torch.server import BSGSDServer, BSGSService  # noqa: E402

torch.set_num_threads(1)
PARAMS = BSGSParams(m=512, block_u=16, steps_per_chunk=4, build_block=128)


@pytest.fixture(scope="module")
def table():
    return BSGSService(PARAMS, warm=False, device="cpu").table


def _serve(service):
    srv = BSGSDServer(("127.0.0.1", 0), service)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def server(table):
    srv = _serve(BSGSService(PARAMS, table=table, device="cpu"))
    yield srv.server_address
    srv.shutdown()


def _request(addr, line: str) -> str:
    with socket.create_connection(addr, timeout=300) as s:
        s.sendall(line.encode() + b"\n")
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = s.recv(4096)
            if not b:
                break
            chunks.append(b)
    return b"".join(chunks).decode()


def _pub(key):
    return ecref.serialize_pubkey(ecref.scalar_mult(key)).hex()


def test_solve_request(server):
    assert int(_request(server, f"{_pub(0xA1B2C3)} a00000:a40000"), 16) == 0xA1B2C3


def test_not_found(server):
    assert _request(server, f"{_pub(0xF00000)} a00000:a40000") == "404 Not Found"


def test_bad_request(server):
    assert _request(server, "garbage") == "400 Bad Request"
    assert _request(server, "02aa bad:range") == "400 Bad Request"
    assert _request(server, f"{_pub(1)} ff:01") == "400 Bad Request"


def test_request_deadline_returns_408(table):
    """max_seconds = 0 answers 408 (not 404: the range was not searched, so
    a client that keeps books of cleared ranges must not mark it)."""
    srv = _serve(BSGSService(PARAMS, table=table, warm=False, max_seconds=0.0, device="cpu"))
    try:
        resp = _request(srv.server_address, f"{_pub(0xA1B2C3)} a00000:{'f' * 12}")
        assert resp == "408 Request Timeout"
    finally:
        srv.shutdown()


def test_concurrent_requests_interleave(table):
    """A small request queued behind a large one comes back first, in a few
    turns of one chunk, and both answers are right."""
    srv = _serve(BSGSService(PARAMS, table=table, warm=False, slice_chunks=1, device="cpu"))
    try:
        big_key, small_key = 0xA7D000, 0xA00200  # the big one near its range's end
        results = {}

        def ask(name, line):
            t0 = time.monotonic()
            results[name] = (_request(srv.server_address, line), time.monotonic() - t0)

        t_big = threading.Thread(target=ask, args=("big", f"{_pub(big_key)} a00000:a80000"))
        t_big.start()
        time.sleep(0.5)  # the big request takes the lock first
        t_small = threading.Thread(target=ask, args=("small", f"{_pub(small_key)} a00000:a08000"))
        t_small.start()
        t_small.join()
        t_big.join()
        (small_resp, small_dt), (big_resp, big_dt) = results["small"], results["big"]
        assert int(small_resp, 16) == small_key
        assert int(big_resp, 16) == big_key
        assert small_dt < 0.75 * big_dt, (small_dt, big_dt)
    finally:
        srv.shutdown()


def test_host_resolve_service(tmp_path):
    """--resolve host: the card (here the CPU) holds the two filters, the
    host the exact table; the same protocol."""
    import dataclasses

    params = dataclasses.replace(PARAMS, resolve="host", table_cache=str(tmp_path))
    service = BSGSService(params, device="cpu")
    assert service.table is None and service.host_table is not None
    srv = _serve(service)
    try:
        assert int(_request(srv.server_address, f"{_pub(0xA1B2C3)} a00000:a40000"), 16) == 0xA1B2C3
        assert _request(srv.server_address, f"{_pub(0xF00000)} a00000:a20000") == "404 Not Found"
    finally:
        srv.shutdown()
