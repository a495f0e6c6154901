"""Exact secp256k1 arithmetic over python ints (host side of the port).

Copy of the parts of keyhuntm1cpu_tpu/ref/ecref.py the port uses, so the
port runs without the JAX package: the curve y^2 = x^3 + 7 over F_p from
the SEC 2 parameters, affine add/double, double-and-add scalar
multiplication and pubkey parsing. It builds the step tables and walk
bases and verifies every device candidate exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

# GLV endomorphism: (x, y) -> (beta*x, y) corresponds to scalar mult by
# lambda, where lambda^3 = 1 mod N and beta^3 = 1 mod P.
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72

# Affine point or None for the point at infinity.
PointA = Optional[Tuple[int, int]]

G: PointA = (GX, GY)


def inv_mod(a: int, m: int = P) -> int:
    return pow(a, -1, m)


def is_on_curve(pt: PointA) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B)) % P == 0


def point_neg(pt: PointA) -> PointA:
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def point_add(p1: PointA, p2: PointA) -> PointA:
    """General affine addition handling infinity / doubling / inverse."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return point_double(p1)
    lam = ((y2 - y1) * inv_mod((x2 - x1) % P)) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_double(p1: PointA) -> PointA:
    if p1 is None:
        return None
    x1, y1 = p1
    if y1 == 0:
        return None
    lam = (3 * x1 * x1 * inv_mod((2 * y1) % P)) % P
    x3 = (lam * lam - 2 * x1) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def scalar_mult(k: int, pt: PointA = G) -> PointA:
    """Double-and-add scalar multiplication (exact, host-side only)."""
    k %= N
    result: PointA = None
    addend = pt
    while k:
        if k & 1:
            result = point_add(result, addend)
        addend = point_double(addend)
        k >>= 1
    return result


def y_from_x(x: int, odd: bool) -> Optional[int]:
    """y of the given parity for x, or None if x is not on the curve
    (p = 3 mod 4, so sqrt(a) = a^((p+1)/4) for a quadratic residue)."""
    y2 = (x * x * x + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if (y * y) % P != y2:
        return None
    if (y & 1) != int(odd):
        y = P - y
    return y


def parse_pubkey(hexstr: str) -> PointA:
    """Parse a 33-byte compressed or 65-byte uncompressed hex public key."""
    raw = bytes.fromhex(hexstr.strip().lower())
    if len(raw) == 33 and raw[0] in (2, 3):
        x = int.from_bytes(raw[1:], "big")
        y = y_from_x(x, odd=(raw[0] == 3))
        if y is None:
            raise ValueError("x not on curve")
        return (x, y)
    if len(raw) == 65 and raw[0] == 4:
        pt = (int.from_bytes(raw[1:33], "big"), int.from_bytes(raw[33:], "big"))
        if not is_on_curve(pt):
            raise ValueError("point not on curve")
        return pt
    raise ValueError(f"bad pubkey length/prefix: {len(raw)} bytes")


def serialize_pubkey(pt: PointA, compressed: bool = True) -> bytes:
    if pt is None:
        raise ValueError("cannot serialize infinity")
    x, y = pt
    if compressed:
        return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
