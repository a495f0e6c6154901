"""Port host table (keyhuntm1cpu_tpu_torch/filter/host_table.py, native
library built by keyhuntm1cpu_tpu_torch/_build.py) vs ref/ecref and the
JAX package's host_table: same keys, payloads, cache format and resolve
results. Integer data: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu.filter import host_table as jht  # noqa: E402
from keyhuntm1cpu_tpu.ref import ecref  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import host_table as ht  # noqa: E402

torch.set_num_threads(1)
M = 1 << 12
M64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("tc"))
    return ht.ensure_host_table(M, cache_dir=cache), cache


def test_native_table_bit_exact_vs_ecref(table):
    tab, _ = table
    ref = np.array([ecref.scalar_mult(j)[0] & M64 for j in range(1, M + 1)],
                   dtype=np.uint64)
    order = np.argsort(ref, kind="stable")
    assert np.array_equal(np.asarray(tab.keys), ref[order])
    assert np.array_equal(np.asarray(tab.idx).astype(np.int64), order)


def test_keys_range_matches_ecref():
    got = ht.native_keys_range(97, 5)
    assert got.tolist() == [ecref.scalar_mult(j)[0] & M64 for j in range(97, 102)]


def test_cache_shared_with_jax_package(table):
    """A port-built cache loads in the JAX package and resolves identically."""
    tab, cache = table
    jtab = jht.load_host_table(M, cache_dir=cache)
    assert jtab is not None
    assert np.array_equal(np.asarray(jtab.keys), np.asarray(tab.keys))
    js = [1, 2, 1000, 4096]
    keys = [ecref.scalar_mult(j)[0] & M64 for j in js] + [123 << 32 | 456]
    qhi = np.array([k >> 32 for k in keys], dtype=np.uint32)
    qlo = np.array([k & 0xFFFFFFFF for k in keys], dtype=np.uint32)
    rows, got = tab.resolve(qhi, qlo)
    assert rows.tolist() == [0, 1, 2, 3] and got.tolist() == js
    jrows, jgot = jtab.resolve(qhi, qlo)
    assert np.array_equal(rows, jrows) and np.array_equal(got, jgot)


def test_cached_load_and_corruption_detect(table, tmp_path):
    import shutil

    _, cache = table
    t = ht.load_host_table(M, cache_dir=cache)
    assert t is not None and t.m == M
    t.prefault()
    assert ht.load_host_table(M // 2, cache_dir=cache) is None
    bad = tmp_path / "bad"
    shutil.copytree(cache, bad)
    with open(bad / f"baby_{M}.keys", "r+b") as f:
        f.truncate(100)
    assert ht.load_host_table(M, cache_dir=str(bad)) is None
