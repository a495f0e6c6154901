"""Exact hashes and encodings on the host (python ints + hashlib).

Copy of the parts of keyhuntm1cpu_tpu/ref/hashref.py that found-key
reports and brute-force verification need: SHA-256 from hashlib,
RIPEMD-160 and Keccak-256 from their specifications (OpenSSL 3 builds of
hashlib drop ripemd160, and hashlib's sha3_256 is NIST-padded SHA-3, not
the 0x01-padded Keccak that Ethereum uses), hash160 of a public key, the
ETH address and base58check.
"""

from __future__ import annotations

import hashlib
import struct

from ..hash.consts import _IV, _K1, _K2, _R1, _R2, _RC, _ROT, _S1, _S2
from . import ecref

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _rmd_f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z) & _M32
    if j < 48:
        return (x | ~y & _M32) ^ z
    if j < 64:
        return (x & z) | (y & ~z & _M32)
    return x ^ (y | ~z & _M32)


def ripemd160(data: bytes) -> bytes:
    msg = bytearray(data) + b"\x80"
    while len(msg) % 64 != 56:
        msg.append(0)
    msg += struct.pack("<Q", len(data) * 8)
    h = list(_IV)
    for off in range(0, len(msg), 64):
        x = struct.unpack("<16I", bytes(msg[off : off + 64]))
        a1, b1, c1, d1, e1 = h
        a2, b2, c2, d2, e2 = h
        for j in range(80):
            t = (_rol((a1 + _rmd_f(j, b1, c1, d1) + x[_R1[j]] + _K1[j // 16])
                      & _M32, _S1[j]) + e1) & _M32
            a1, e1, d1, c1, b1 = e1, d1, _rol(c1, 10), b1, t
            t = (_rol((a2 + _rmd_f(79 - j, b2, c2, d2) + x[_R2[j]] + _K2[j // 16])
                      & _M32, _S2[j]) + e2) & _M32
            a2, e2, d2, c2, b2 = e2, d2, _rol(c2, 10), b2, t
        h = [(h[1] + c1 + d2) & _M32, (h[2] + d1 + e2) & _M32,
             (h[3] + e1 + a2) & _M32, (h[4] + a1 + b2) & _M32,
             (h[0] + b1 + c2) & _M32]
    return struct.pack("<5I", *h)


def _rol64(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(a) -> None:
    for rnd in range(24):
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol64(a[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= _RC[rnd]


def keccak256(data: bytes) -> bytes:
    """Keccak-256 with the pre-NIST 0x01 padding (Ethereum's)."""
    rate = 136
    state = [[0] * 5 for _ in range(5)]
    msg = bytearray(data) + b"\x01"
    while len(msg) % rate:
        msg.append(0)
    msg[-1] ^= 0x80
    for off in range(0, len(msg), rate):
        for i in range(rate // 8):
            lane = int.from_bytes(msg[off + 8 * i : off + 8 * i + 8], "little")
            state[i % 5][i // 5] ^= lane
        _keccak_f(state)
    return b"".join(state[i % 5][i // 5].to_bytes(8, "little") for i in range(4))


def hash160(data: bytes) -> bytes:
    return ripemd160(sha256(data))


def pubkey_to_hash160(pt, compressed: bool = True) -> bytes:
    return hash160(ecref.serialize_pubkey(pt, compressed))


def pubkey_to_eth_address(pt) -> bytes:
    """20-byte ETH address = keccak256(x || y)[12:]."""
    x, y = pt
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]


def b58encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = ""
    while n:
        n, r = divmod(n, 58)
        out = _B58_ALPHABET[r] + out
    pad = len(data) - len(data.lstrip(b"\x00"))
    return "1" * pad + out


def b58decode(s: str) -> bytes:
    n = 0
    for ch in s:
        n = n * 58 + _B58_ALPHABET.index(ch)
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = len(s) - len(s.lstrip("1"))
    return b"\x00" * pad + raw


def b58check_encode(payload: bytes) -> str:
    return b58encode(payload + sha256(sha256(payload))[:4])


def b58check_decode(s: str) -> bytes:
    raw = b58decode(s)
    payload, chk = raw[:-4], raw[-4:]
    if sha256(sha256(payload))[:4] != chk:
        raise ValueError("bad base58check checksum")
    return payload


def pubkey_to_address(pt, compressed: bool = True, version: int = 0x00) -> str:
    return b58check_encode(bytes([version]) + pubkey_to_hash160(pt, compressed))
