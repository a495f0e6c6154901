"""secp256k1 in Python integers: the benchmark's own curve arithmetic.

Written for the reference from the curve's published parameters (SEC 2,
section 2.4.1); it shares no code with the program under test. Points are
affine (x, y) tuples, None is the point at infinity. Scalar multiplication
runs in Jacobian coordinates with one inversion at the end.
"""

from __future__ import annotations

from typing import Optional, Tuple

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)

Point = Optional[Tuple[int, int]]


def on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 7) % P == 0


def neg(pt: Point) -> Point:
    return None if pt is None else (pt[0], (-pt[1]) % P)


def add(p1: Point, p2: Point) -> Point:
    """Affine sum (one inversion)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _jdouble(X: int, Y: int, Z: int):
    if Z == 0 or Y == 0:
        return 0, 1, 0
    yy = Y * Y % P
    s = 4 * X * yy % P
    m = 3 * X * X % P
    x3 = (m * m - 2 * s) % P
    return x3, (m * (s - x3) - 8 * yy * yy) % P, 2 * Y * Z % P


def _jadd_affine(X: int, Y: int, Z: int, x2: int, y2: int):
    """Jacobian (X, Y, Z) + affine (x2, y2)."""
    if Z == 0:
        return x2, y2, 1
    zz = Z * Z % P
    u2 = x2 * zz % P
    s2 = y2 * zz * Z % P
    h = (u2 - X) % P
    r = (s2 - Y) % P
    if h == 0:
        return _jdouble(X, Y, Z) if r == 0 else (0, 1, 0)
    hh = h * h % P
    hhh = h * hh % P
    v = X * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return x3, (r * (v - x3) - Y * hhh) % P, Z * h % P


def mul(k: int, pt: Point = G) -> Point:
    """k * pt (k taken mod N; 0 gives the point at infinity)."""
    k %= N
    if k == 0 or pt is None:
        return None
    X, Y, Z = 0, 1, 0
    x2, y2 = pt
    for bit in bin(k)[2:]:
        X, Y, Z = _jdouble(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jadd_affine(X, Y, Z, x2, y2)
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def compressed(pt: Tuple[int, int]) -> bytes:
    """The 33-byte SEC encoding: 02 or 03 by the parity of y, then x."""
    return bytes([2 + (pt[1] & 1)]) + pt[0].to_bytes(32, "big")


def trunc64(pt: Tuple[int, int]) -> int:
    """The low 64 bits of x: the key a BSGS baby table holds for a point."""
    return pt[0] & ((1 << 64) - 1)
