"""Elementwise modular inverse a^(p-2) mod p (0 -> 0).

Port of keyhuntm1cpu_tpu/field/pinv.py. ``inv_batch`` inverts every column
of a limb-major (8, n) int32 tensor (u32 bits): its plain torch version
(``fe.inv``, the secp256k1 addition chain) for a CPU tensor, the CUDA
kernel of csrc/pinv.cu for a CUDA tensor, launches counted in
``inv_batch.launches``. The JAX function takes (B, 8) batch-major limbs;
the port keeps its limb-major layout. The walker walk (curve/walk.py)
calls it once per step on the chain totals of its batched inversion.
"""

from __future__ import annotations

import torch

from .. import _build
from . import fe


def inv_batch_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel (see inv_batch)."""
    return fe.i32(fe.inv(fe.u32(a)))


def inv_batch(a: torch.Tensor) -> torch.Tensor:
    """a: (8, n) int32 limbs -> (8, n) int32 limbs of a^(p-2) mod p."""
    n = a.shape[1] if a.dim() == 2 else 0
    if a.dtype != torch.int32 or not a.is_contiguous() or a.shape[0] != 8 or n < 1:
        raise ValueError(f"need contiguous int32 (8, n) limbs with n >= 1, got "
                         f"{a.dtype} {tuple(a.shape)}")
    if not _build.on_cuda(a):
        return inv_batch_ref(a)
    out = torch.empty_like(a)
    _build.launch("kh_inv_batch", a.data_ptr(), out.data_ptr(), n, _build.stream(a))
    inv_batch.launches += 1
    return out


inv_batch.launches = 0
