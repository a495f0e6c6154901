"""The frozen least-work model equals chip_smoke.py's at the cells' shapes."""

import chip_smoke as smoke
import pytest

from khbench import roofline

CLOCKS = (1980.0, 1755.0)


@pytest.mark.parametrize("clock", CLOCKS)
@pytest.mark.parametrize("R,U", [(256, 16384), (32, 16384)])
def test_k2_bound(clock, R, U):
    want = smoke.bound_ms(smoke.walk_point_ops(R * U) * R * U, 64 * (R + U) + 9 * R * U, clock)
    assert roofline.bound_ms(*roofline.k2_ops_bytes(R, U), clock) == want


@pytest.mark.parametrize("clock", CLOCKS)
@pytest.mark.parametrize("mode,n_endo,T,TB", [("rmd160", 1, 8, 0), ("rmd160", 1, 8, 520),
                                              ("rmd160", 3, 32, 0), ("eth", 1, 8, 0),
                                              ("xpoint", 1, 8, 16)])
def test_k4_bound(clock, mode, n_endo, T, TB):
    K, U = 256, 16384
    want = smoke.bound_ms(smoke.k4_ops(mode, n_endo, T, TB, K * U),
                          64 * (K + U) + 16 * T + 512 * TB + 4 * K * U, clock)
    assert roofline.bound_ms(*roofline.k4_ops_bytes(mode, n_endo, T, TB, K, U), clock) == want


def test_constants():
    for name in ("MUL_OPS", "SQR_OPS", "SUB_OPS", "INV_OPS", "SHA_OPS", "RMD_OPS",
                 "KECCAK_OPS", "HASH_OPS", "MODE_HASHES", "INT32_PER_CLK_SM", "N_SM",
                 "HBM_BYTES_PER_S"):
        assert getattr(roofline, name) == getattr(smoke, name), name
