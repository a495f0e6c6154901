"""CUDA kernels K1-K3 (keyhuntm1cpu_tpu_torch/csrc) vs their plain torch
versions on the card, and the engine on CUDA vs the engine on the CPU.
Needs an NVIDIA GPU and nvcc; skipped without a GPU. Run on the card with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
Integer arithmetic: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu_torch.curve import pwalk, tables  # noqa: E402
from keyhuntm1cpu_tpu_torch.engine import bsgs  # noqa: E402
from keyhuntm1cpu_tpu_torch.field import fe  # noqa: E402
from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _limbs(v):
    return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())


def _pts(pts):
    return (torch.stack([_limbs(p[0]) for p in pts]).t().contiguous(),
            torch.stack([_limbs(p[1]) for p in pts]).t().contiguous())


def test_advance_chain_kernel_matches_plain(dev):
    advk, K = 1000, 64
    adv = ecref.scalar_mult(advk)
    ks = [advk, 12345, ecref.N - 3 * advk] + [777 * i + 5 for i in range(13)]
    px, py = _pts([ecref.scalar_mult(k) for k in ks])
    args = (px, py, _limbs(adv[0]), _limbs(adv[1]))
    want = pwalk.advance_chain_ref(*args, K)
    got = pwalk.advance_chain(*(a.to(dev) for a in args), K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("R,U", [(45, 1000), (32, 128), (64, 7)])
def test_walk_blocks_kernel_matches_plain(dev, R, U):
    tab_x, tab_y = tables.step_table(ecref.scalar_mult(7), U)
    rows = [ecref.scalar_mult(100 + 3 * r) for r in range(R)]
    rows[2] = ecref.scalar_mult(7 * 5)  # dx == 0 at u = 4
    rows[30] = ecref.point_neg(ecref.scalar_mult(7 * 6))  # dx == 0 at u = 5
    bx, by = _pts(rows)
    tx = pwalk.table_to_limb_major(tab_x, "cpu")
    ty = pwalk.table_to_limb_major(tab_y, "cpu")
    want = pwalk.walk_blocks_ref(bx, by, tx, ty)
    got = pwalk.walk_blocks(bx.to(dev), by.to(dev), tx.to(dev), ty.to(dev))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bits,b2bits", [(24, 22), (35, 33)])
def test_insert_keys_kernel_matches_plain(dev, bits, b2bits):
    rng = np.random.default_rng(7)
    n = 1 << 20
    qhi = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    qlo = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    keep = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    w1, w2 = bmp.empty_filter(bits, dev), bmp.empty_filter(b2bits, dev)
    r1, r2 = w1.clone(), w2.clone()
    bmp.insert_keys(w1, bits, w2, b2bits, qhi, qlo, keep)
    bmp.insert_keys_ref(r1, bits, r2, b2bits, qhi, qlo, keep)
    torch.cuda.synchronize()
    assert torch.equal(w1, r1) and torch.equal(w2, r2)


def test_engine_cuda_matches_cpu(dev, tmp_path):
    ks = [0xA12345, 0xA54321, 0xAFEDCB]
    pubs = [ecref.scalar_mult(k) for k in ks]
    params = bsgs.BSGSParams(m=1 << 12, block_u=256, steps_per_chunk=8,
                             build_block=128, bits_log2=24, bloom2_bits=17,
                             table_cache=str(tmp_path))
    got = bsgs.BSGSEngine(pubs, 0xA00000, 0xB00000, params, device=dev)
    want = bsgs.BSGSEngine(pubs, 0xA00000, 0xB00000, params, device="cpu",
                           host_table=got.host_table)
    assert torch.equal(got.bitmap.words.cpu(), want.bitmap.words)
    assert torch.equal(got.bloom2.words.cpu(), want.bloom2.words)
    found = sorted(f.private_key for f in got.search(stop_on_first=False))
    assert found == sorted(ks)
