"""The walker step's exact lookup and summary row
(keyhuntm1cpu_tpu_torch/filter/sorted_table.py lookup_summary, its plain
version on CPU tensors) against the JAX package's sorted_table.lookup
plus the summary ops of engine/brute.py _brute_chunk_impl, restated here
in jnp, on the cases of tests/walker_lookup_cases.py: a duplicated
truncated key (found2), a key above every table key, a table of one key,
padding positions, hits on degenerate lanes, a walker without a
degenerate lane, a survivor count past C, more walkers and survivors
than a block has warps and threads, and the kernel's 32-ary warp
search's edges: tables of 32, 33, 34, 1,089 and 1,090 keys, duplicated
keys across a first-level pivot, the table's first and last keys. Integer arithmetic: the
tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keyhuntm1cpu_tpu.filter import sorted_table as jst  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import sorted_table as tst  # noqa: E402
from walker_lookup_cases import (CASES, ENDS_SURVIVORS, PIVOT_SURVIVORS,  # noqa: E402
                                 SHAPES, make_case)

torch.set_num_threads(1)


def jax_summary(d):
    """The JAX walker step's row: filtered_lookup's exact search of the
    survivors (found masked by pos < total) and _brute_chunk_impl's
    summary (engine/brute.py:1064-1093)."""
    table = jst.build_sorted_table(d["hi"], d["lo"], d["idx"])
    lr = jst.lookup(table, jnp.asarray(d["qhi"]), jnp.asarray(d["qlo"]))
    pos, total, deg = jnp.asarray(d["pos"]), d["total"], jnp.asarray(d["deg"])
    W, U = d["deg"].shape
    npts = 2 * U + 1
    valid = pos < total
    found, found2 = lr.found & valid, lr.found2 & valid
    degm = jnp.concatenate([deg, deg, jnp.zeros((W, 1), dtype=bool)], axis=1).reshape(-1)
    live = ~degm[jnp.minimum(pos, total - 1) % (W * npts)]
    hit = (found | found2) & live
    out = jnp.concatenate([
        jnp.where(hit, pos, total).astype(jnp.int32),
        jnp.where(hit, lr.idx, 0).astype(jnp.int32),
        deg.sum(axis=1).astype(jnp.int32),
        jnp.argmax(deg, axis=1).astype(jnp.int32),
        jnp.asarray(d["adeg"]).astype(jnp.int32),
        jnp.asarray([d["n"]], dtype=jnp.int32)])
    return np.asarray(out), np.asarray(lr.found2 & valid)


def port_args(d):
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())
    table = tst.build_sorted_table(d["hi"], d["lo"], d["idx"])
    return (table, torch.from_numpy(d["pos"]), i32(d["qhi"]), i32(d["qlo"]),
            torch.tensor(d["n"], dtype=torch.int32), torch.from_numpy(d["deg"]),
            torch.from_numpy(d["adeg"]), d["total"])


@pytest.mark.parametrize("case", CASES)
def test_lookup_summary_matches_jax(case):
    d = make_case(case)
    want, found2 = jax_summary(d)
    args = port_args(d)
    n0 = tst.lookup_summary.launches
    got = tst.lookup_summary(*args)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tst.lookup_summary_ref(*args).numpy(), want)
    out = torch.full((2, want.shape[0]), -1, dtype=torch.int32)
    assert tst.lookup_summary(*args, out=out[1]) is not None
    assert np.array_equal(out[1].numpy(), want) and (out[0] == -1).all()
    assert tst.lookup_summary.launches == n0  # CPU tensors take the plain version
    W, U = d["deg"].shape
    C, total = d["pos"].shape[0], d["total"]
    cand, rows = want[:C], want[C:2 * C]
    n_deg, first_deg = want[2 * C:2 * C + W], want[2 * C + W:2 * C + 2 * W]
    hits = cand < total
    assert hits.any() and (rows[~hits] == 0).all()
    assert want[-1] == d["n"]
    # what each case plants shows in the row
    if case == "dup":
        assert found2[2] and cand[2] == d["pos"][2]
    if case == "above":
        assert not hits[1]
    if case == "m1":
        assert hits.sum() == 1 and hits[0]
    if case == "padding":
        pad = d["pos"] == total
        assert pad.any() and not hits[pad].any()
        assert (d["qhi"][pad] == d["qhi"][~pad][-1]).all() and hits[~pad][-1]
    if case == "degenerate":
        npts = 2 * U + 1
        for q in range(2):
            base = q * W * npts + npts
            for lane, live in ((3, False), (U + 3, False), (2 * U, True)):
                j = int(np.flatnonzero(d["pos"] == base + lane)[0])
                assert hits[j] == live
    if case == "no_deg":
        assert n_deg[1] == 0 and first_deg[1] == 0 and first_deg[2] == 5
    if case == "overflow":
        assert want[-1] > C and (d["pos"] < total).all()
    if case in SHAPES and case.startswith(("m", "pivot")):  # the warp search's edges
        assert len(d["hi"]) == SHAPES[case]["m"]
    if case == "pivot_dup":
        assert found2[list(PIVOT_SURVIVORS)].all() and hits[list(PIVOT_SURVIVORS)].all()
    if case == "ends":
        key = (d["hi"].astype(np.uint64) << np.uint64(32)) | d["lo"]
        q = (d["qhi"].astype(np.uint64) << np.uint64(32)) | d["qlo"]
        assert [q[j] for j in ENDS_SURVIVORS] == [key.min(), key.max()]
        assert hits[list(ENDS_SURVIVORS)].all()


@pytest.mark.parametrize("bad", ["pos_dtype", "qhi_len", "deg_dtype", "adeg_len", "out_width",
                                 "total_zero", "total_wide"])
def test_lookup_summary_rejects_bad_inputs(bad):
    """The wrapper checks dtypes, shapes and the range of total before it
    would hand pointers to the kernel, on the CPU as on the card."""
    table, pos, qhi, qlo, n, deg, adeg, total = port_args(make_case("random"))
    out = None
    if bad == "pos_dtype":
        pos = pos.long()
    elif bad == "qhi_len":
        qhi = qhi[:-1]
    elif bad == "deg_dtype":
        deg = deg.to(torch.uint8)
    elif bad == "adeg_len":
        adeg = adeg[:-1]
    elif bad == "out_width":
        out = torch.empty(tst.summary_width(pos.shape[0], deg.shape[0]) + 1, dtype=torch.int32)
    elif bad == "total_zero":
        total = 0
    else:
        total = 1 << 31
    with pytest.raises(ValueError):
        tst.lookup_summary(table, pos, qhi, qlo, n, deg, adeg, total, out=out)
