"""The device field arithmetic of keyhuntm1cpu_tpu_torch/csrc/fe.cuh compiled
as host C++ (g++, with __device__ and the one intrinsic it uses defined
away): the two safegcd inversions, fe_inv_var (variable time: K2, K4) and
fe_inv_const (a fixed count of divsteps: pinv, K1, K6's to-affine launch),
against python's exact inverse, on edge values (0, 1, p - 1, values with
long runs of zero or one bits) and seeded random ones. Exact equality; the kernels themselves run on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keyhuntm1cpu_tpu_torch import _build  # noqa: E402
from keyhuntm1cpu_tpu_torch.ref import ecref  # noqa: E402

SHIM = r"""
#include <cstdint>
#include <cstdio>
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct uint4 { unsigned x, y, z, w; };
static inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
static inline int __ffs(unsigned x) { return __builtin_ffs(x); }
#include "fe.cuh"
// each input line: 8 hex limbs, least significant first; output: the
// limbs of fe_inv_var(a), then of fe_inv_const(a)
int main() {
  kh::Fe a;
  while (scanf("%x %x %x %x %x %x %x %x", &a.v[0], &a.v[1], &a.v[2], &a.v[3], &a.v[4],
               &a.v[5], &a.v[6], &a.v[7]) == 8) {
    const kh::Fe r[2] = {kh::fe_inv_var(a), kh::fe_inv_const(a)};
    for (const kh::Fe& x : r)
      for (int i = 0; i < 8; i++) printf("%08x%c", x.v[i], i == 7 ? '\n' : ' ');
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def fe_host(tmp_path_factory):
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        pytest.fail(f"{cxx} not found: the tests' native build needs it too")
    d = tmp_path_factory.mktemp("fe_host")
    (d / "main.cpp").write_text(SHIM)
    exe = d / "fe_host"
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", _build.CSRC_DIR, "-o", str(exe),
                    str(d / "main.cpp")], check=True, capture_output=True, timeout=300)
    return exe


def _values():
    P = ecref.P
    rng = np.random.default_rng(30)
    vals = [0, 1, 2, 3, P - 1, P - 2, 2 ** 255, 2 ** 32 + 977, P // 2, (P + 1) // 2]
    vals += [1 << b for b in range(0, 256, 7)] + [P - (1 << b) for b in range(0, 256, 9)]
    # long zero runs between set bits, and long runs of ones
    vals += [(1 << b) | 1 for b in range(31, 256, 16)] + [(1 << 255) | (1 << b) for b in (0, 64, 200)]
    vals += [((1 << b) - 1) << (255 - b) for b in (30, 60, 128)] + [(1 << 128) - 1]
    vals += [int.from_bytes(rng.bytes(32), "big") % P for _ in range(2000)]
    vals += [int.from_bytes(rng.bytes(4), "big") for _ in range(100)]  # small
    return vals


def test_fe_inv_var_matches_exact_inverse(fe_host):
    P = ecref.P
    vals = _values()
    lines = "".join(" ".join(f"{(v >> (32 * i)) & 0xFFFFFFFF:08x}" for i in range(8)) + "\n"
                    for v in vals)
    out = subprocess.run([str(fe_host)], input=lines, capture_output=True, text=True,
                         check=True, timeout=300).stdout.split("\n")
    for j, v in enumerate(vals):
        want = pow(v, -1, P) if v else 0
        for got in out[2 * j: 2 * j + 2]:
            limbs = [int(h, 16) for h in got.split()]
            assert sum(x << (32 * i) for i, x in enumerate(limbs)) == want, hex(v)
