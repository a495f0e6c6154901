"""Reference keyhunt `.blm` / `.tbl` / `.dat` file interop (read + write):
a copy of keyhuntm1cpu_tpu/utils/legacy.py whose files are byte for byte
the JAX package's. The one part that runs on the card is `baby_x_bytes`
with a CUDA device: X(j*G) for j = 1..m by K6 (curve/pladder.py); the
blooms and the table are built on the host with numpy, as there.

The reference persists its BSGS precompute as raw-struct dumps
(keyhunt.cpp:1373-1612 load, 1881-2025 save):

- `keyhunt_bsgs_4_<m>.blm` / `_6_<m2>.blm` / `_7_<m3>.blm`: 256 shard
  records, each = `struct bloom` (80 bytes on x86-64: entries@0 bits@8
  bytes@16 hashes@24 error(long double)@32 ready/major/minor@48 bpe@56
  bf-pointer@64 — layout probed by compiling against the reference
  header) + the raw bit array + a 64-byte {sha256, sha256-backup}
  checksum of the bit array.
- `keyhunt_bsgs_2_<m3>.tbl`: m3 x `struct bsgs_xvalue {uint8 value[6];
  uint64 index}` (16 bytes: value = X(j) big-endian bytes 16..21, index
  = j-1), sorted by value, + one 32-byte sha256 of the table bytes.

Bloom semantics are libbloom2 (bloom/bloom.cpp): sizing bpe =
-ln(err)/ln(2)^2, double hashing a = XXH64(X_be32, 0x59f2815b16f81798),
b = XXH64(X_be32, a), bit_i = (a + b*i) % bits, byte bit>>3 mask
1<<(bit&7); shard index = X_be[0] (keyhunt.cpp:4514-4562).

This module lets a reference deployment carry its precompute over —
either direction: `read_*` parse + checksum-verify legacy files (and
`verify_against_ecref` spot-checks their contents against exact EC
math); `export_reference_files` writes a fresh, reference-loadable set.
"""

from __future__ import annotations

import hashlib
import math
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..filter.bloom import _P1, _P2, _P3, _P4, _P5, _rotl64 as _rotl
from ..ref import ecref

BLOOM_STRUCT = 80
# pre-2021 `struct oldbloom` (oldbloom/oldbloom.h:26-52): same leading
# fields as `struct bloom` (entries@0 bits@8 bytes@16 hashes@24 error@32
# ready/major/minor@48 bpe@56) then checksum@64 checksum_backup@96
# bf-pointer@128 pthread_mutex_t@136 -> sizeof = 176 on x86-64. The
# checksums are EMBEDDED in the struct (v4 moved them after the bit
# array), and there is no trailing checksum block.
OLDBLOOM_STRUCT = 176
CHECKSUM = 64  # {data[32], backup[32]}
XVALUE_SIZE = 16  # 6-byte value + 2 pad + 8-byte index
BLOOM_SEED = 0x59F2815B16F81798
BLOOM_ERROR = 0.000001

def xxh64_32bytes(msgs: np.ndarray, seed) -> np.ndarray:
    """Vectorized XXH64 of (B, 32)-byte messages (exactly one stripe)."""
    old = np.seterr(over="ignore")
    try:
        lanes = msgs.reshape(-1, 4, 8).astype(np.uint8)
        lanes = np.ascontiguousarray(lanes).view("<u8").reshape(-1, 4)
        lanes = lanes.astype(np.uint64)
        seed = np.asarray(seed, dtype=np.uint64)
        v = [
            seed + _P1 + _P2,
            seed + _P2,
            seed + np.uint64(0),
            seed - _P1,
        ]
        for i in range(4):
            acc = v[i] + lanes[:, i] * _P2
            v[i] = _rotl(acc, 31) * _P1
        h = _rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)
        for i in range(4):
            h ^= _rotl(v[i] * _P2, 31) * _P1
            h = h * _P1 + _P4
        h = h + np.uint64(32)
        h ^= h >> np.uint64(33)
        h *= _P2
        h ^= h >> np.uint64(29)
        h *= _P3
        h ^= h >> np.uint64(32)
        return h
    finally:
        np.seterr(**old)


def xxh64_20bytes(msgs: np.ndarray, seed) -> np.ndarray:
    """Vectorized XXH64 of (B, 20)-byte messages (no stripe: 2 u64
    chunks + 1 u32 chunk + avalanche). The reference's address-mode
    bloom keys are raw 20-byte hash160 values (keyhunt.cpp:6351-6360)."""
    old = np.seterr(over="ignore")
    try:
        msgs = np.ascontiguousarray(msgs.astype(np.uint8))
        q = msgs[:, :16].copy().view("<u8").reshape(-1, 2).astype(np.uint64)
        d = msgs[:, 16:20].copy().view("<u4").reshape(-1).astype(np.uint64)
        seed = np.asarray(seed, dtype=np.uint64)
        h = seed + _P5 + np.uint64(20)
        for i in range(2):
            k = _rotl(q[:, i] * _P2, 31) * _P1
            h = _rotl(h ^ k, 27) * _P1 + _P4
        h = _rotl(h ^ (d * _P1), 23) * _P2 + _P3
        h ^= h >> np.uint64(33)
        h *= _P2
        h ^= h >> np.uint64(29)
        h *= _P3
        h ^= h >> np.uint64(32)
        return h
    finally:
        np.seterr(**old)


@dataclass
class LegacyBloom:
    entries: int
    bits: int
    nbytes: int
    hashes: int
    bf: np.ndarray  # (nbytes,) uint8

    @classmethod
    def create(cls, entries: int) -> "LegacyBloom":
        bpe = -math.log(BLOOM_ERROR) / 0.480453013918201
        bits = int(entries * bpe)
        nbytes = bits // 8 + (1 if bits % 8 else 0)
        hashes = int(math.ceil(0.693147180559945 * bpe))
        return cls(entries, bits, nbytes, hashes,
                   np.zeros(nbytes, dtype=np.uint8))

    def _positions(self, x32: np.ndarray) -> np.ndarray:
        hash_fn = xxh64_20bytes if x32.shape[1] == 20 else xxh64_32bytes
        a = hash_fn(x32, BLOOM_SEED)
        b = hash_fn(x32, a)
        i = np.arange(self.hashes, dtype=np.uint64)[None, :]
        old = np.seterr(over="ignore")
        try:
            return (a[:, None] + b[:, None] * i) % np.uint64(self.bits)
        finally:
            np.seterr(**old)

    def add(self, x32: np.ndarray) -> None:
        pos = self._positions(x32).reshape(-1)
        np.bitwise_or.at(
            self.bf, (pos >> np.uint64(3)).astype(np.int64),
            np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8),
        )

    def check(self, x32: np.ndarray) -> np.ndarray:
        pos = self._positions(x32)
        byte = self.bf[(pos >> np.uint64(3)).astype(np.int64)]
        return ((byte >> (pos & np.uint64(7)).astype(np.uint8)) & 1).all(axis=1)

    def header_bytes(self) -> bytes:
        bpe = -math.log(BLOOM_ERROR) / 0.480453013918201
        hdr = bytearray(BLOOM_STRUCT)
        struct.pack_into("<QQQ", hdr, 0, self.entries, self.bits, self.nbytes)
        hdr[24] = self.hashes
        # x86-64 80-bit extended long double of 1e-6 + 6 zeroed pad bytes
        # (the reference memsets the struct, so padding is zero); a
        # host-dependent np.longdouble would mis-encode on aarch64
        hdr[32:48] = (
            b"\x00\x68\x6c\xaf\x05\xbd\x37\x86\xeb\x3f" + b"\x00" * 6
        )
        hdr[48] = 1  # ready
        hdr[49] = 2  # BLOOM_VERSION_MAJOR
        hdr[50] = 200  # BLOOM_VERSION_MINOR
        struct.pack_into("<d", hdr, 56, bpe)
        return bytes(hdr)


def shard_entries(m: int, level: int) -> int:
    """Per-shard bloom entry count (keyhunt.cpp:1185-1213)."""
    per = m // 256 + (1 if m % 256 else 0)
    floor = 10000 if level == 1 else 1000
    return per if m // 256 > floor else 1000


def read_blm(path: str, skip_checksum: bool = False) -> List[LegacyBloom]:
    out = []
    with open(path, "rb") as f:
        for _ in range(256):
            hdr = f.read(BLOOM_STRUCT)
            if len(hdr) != BLOOM_STRUCT:
                raise ValueError(f"{path}: truncated bloom header")
            entries, bits, nbytes = struct.unpack_from("<QQQ", hdr, 0)
            hashes = hdr[24]
            if not (0 < bits <= nbytes * 8 and hashes):
                raise ValueError(f"{path}: implausible bloom header")
            bf = np.frombuffer(f.read(nbytes), dtype=np.uint8)
            if len(bf) != nbytes:
                raise ValueError(f"{path}: truncated bit array")
            ck = f.read(CHECKSUM)
            if not skip_checksum:
                digest = hashlib.sha256(bf.tobytes()).digest()
                if ck[:32] != digest or ck[32:] != digest:
                    raise ValueError(f"{path}: bloom checksum mismatch")
            out.append(LegacyBloom(entries, bits, nbytes, hashes, bf.copy()))
    return out


def write_blm(path: str, blooms: List[LegacyBloom]) -> None:
    assert len(blooms) == 256
    with open(path, "wb") as f:
        for b in blooms:
            f.write(b.header_bytes())
            f.write(b.bf.tobytes())
            digest = hashlib.sha256(b.bf.tobytes()).digest()
            f.write(digest + digest)


def _old_header_bytes(b: LegacyBloom) -> bytes:
    """176-byte `struct oldbloom` image for one shard (checksums
    embedded at 64/96; bf pointer + mutex zeroed as fread garbage)."""
    hdr = bytearray(OLDBLOOM_STRUCT)
    hdr[:BLOOM_STRUCT] = b.header_bytes()
    digest = hashlib.sha256(b.bf.tobytes()).digest()
    hdr[64:96] = digest
    hdr[96:128] = digest
    return bytes(hdr)


def read_old_blm(path: str, skip_checksum: bool = False) -> List[LegacyBloom]:
    """Parse a pre-2021 `keyhunt_bsgs_3_<m>.blm` (256 x {oldbloom
    struct, bit array}; keyhunt.cpp:1422-1476 is the reference's
    migration read of exactly this layout)."""
    out = []
    with open(path, "rb") as f:
        for _ in range(256):
            hdr = f.read(OLDBLOOM_STRUCT)
            if len(hdr) != OLDBLOOM_STRUCT:
                raise ValueError(f"{path}: truncated oldbloom header")
            entries, bits, nbytes = struct.unpack_from("<QQQ", hdr, 0)
            hashes = hdr[24]
            if not (0 < bits <= nbytes * 8 and hashes):
                raise ValueError(f"{path}: implausible oldbloom header")
            bf = np.frombuffer(f.read(nbytes), dtype=np.uint8)
            if len(bf) != nbytes:
                raise ValueError(f"{path}: truncated bit array")
            if not skip_checksum:
                digest = hashlib.sha256(bf.tobytes()).digest()
                if hdr[64:96] != digest or hdr[96:128] != digest:
                    raise ValueError(f"{path}: oldbloom checksum mismatch")
            out.append(LegacyBloom(entries, bits, nbytes, hashes, bf.copy()))
    return out


def write_old_blm(path: str, blooms: List[LegacyBloom]) -> None:
    """Write the pre-2021 `_3_` layout (for tests and for feeding a
    deployment that still runs a pre-v4 reference build)."""
    assert len(blooms) == 256
    with open(path, "wb") as f:
        for b in blooms:
            f.write(_old_header_bytes(b))
            f.write(b.bf.tobytes())


def migrate_oldbloom_file(old_path: str, new_path: str,
                          skip_checksum: bool = False) -> List[LegacyBloom]:
    """`keyhunt_bsgs_3_<m>.blm` -> `keyhunt_bsgs_4_<m>.blm` upgrade
    (reference: read old struct, keep bit arrays + checksums, rewrite in
    the v4 layout — keyhunt.cpp:1422-1476 + FLAGUPDATEFILE1 save)."""
    blooms = read_old_blm(old_path, skip_checksum=skip_checksum)
    write_blm(new_path, blooms)
    return blooms


def load_level1_blooms(dirpath: str, m: int, skip_checksum: bool = False,
                       migrate: bool = True) -> Tuple[List[LegacyBloom], bool]:
    """Load the level-1 bloom set for baby size m, preferring v4 and
    falling back to a `_3_` file (migrating it to `_4_` like the
    reference does on load). Returns (blooms, migrated)."""
    p4 = os.path.join(dirpath, f"keyhunt_bsgs_4_{m}.blm")
    p3 = os.path.join(dirpath, f"keyhunt_bsgs_3_{m}.blm")
    if os.path.exists(p4):
        return read_blm(p4, skip_checksum=skip_checksum), False
    if os.path.exists(p3):
        if migrate:
            return migrate_oldbloom_file(p3, p4, skip_checksum), True
        return read_old_blm(p3, skip_checksum=skip_checksum), False
    raise FileNotFoundError(p4)


def dat_cache_path(target_file: str, dirpath: str = ".") -> str:
    """`data_<8-hex>.dat` companion path for a target file: the prefix
    is the hex of the FIRST four bytes of sha256(file) — the reference
    comment says "last" but tohex_dst(checksum, 4) hexes the first four
    (keyhunt.cpp:6146-6148)."""
    h = hashlib.sha256()
    with open(target_file, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return os.path.join(dirpath, f"data_{h.digest()[:4].hex()}.dat")


def read_dat(path: str, skip_checksum: bool = False
             ) -> Tuple[LegacyBloom, np.ndarray]:
    """Parse the reference's address-mode binary cache
    (keyhunt.cpp:6131-6279 read, 6578-6678 write):
    {sha256(bf), struct bloom, bf, sha256(table), u64 size, table} with
    table = N x 20-byte sorted hash160/xpoint-prefix values and bloom
    keys = those same 20 raw bytes. Returns (bloom, (N, 20) values)."""
    with open(path, "rb") as f:
        bloom_ck = f.read(32)
        hdr = f.read(BLOOM_STRUCT)
        if len(bloom_ck) != 32 or len(hdr) != BLOOM_STRUCT:
            raise ValueError(f"{path}: truncated header")
        entries, bits, nbytes = struct.unpack_from("<QQQ", hdr, 0)
        hashes = hdr[24]
        if not (0 < bits <= nbytes * 8 and hashes):
            raise ValueError(f"{path}: implausible bloom header")
        bf = np.frombuffer(f.read(nbytes), dtype=np.uint8)
        if len(bf) != nbytes:
            raise ValueError(f"{path}: truncated bit array")
        data_ck = f.read(32)
        (dsize,) = struct.unpack("<Q", f.read(8))
        if dsize % 20:
            raise ValueError(f"{path}: table size not a multiple of 20")
        raw = f.read(dsize)
        if len(raw) != dsize:
            raise ValueError(f"{path}: truncated address table")
    if not skip_checksum:
        if hashlib.sha256(bf.tobytes()).digest() != bloom_ck:
            raise ValueError(f"{path}: bloom checksum mismatch")
        if hashlib.sha256(raw).digest() != data_ck:
            raise ValueError(f"{path}: table checksum mismatch")
    values = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 20).copy()
    return LegacyBloom(entries, bits, nbytes, hashes, bf.copy()), values


def write_dat(path: str, values: np.ndarray, multiplier: int = 1) -> None:
    """Write a reference-loadable `data_<8-hex>.dat` from (N, 20)
    values. Sizing mirrors initBloomFilter (keyhunt.cpp:6558-6576):
    entries = max(10000, multiplier*N); table stored sorted (the
    reference binary-searches it)."""
    values = np.asarray(values, dtype=np.uint8).reshape(-1, 20)
    order = np.lexsort(tuple(values[:, i] for i in range(19, -1, -1)))
    values = values[order]
    n = len(values)
    bloom = LegacyBloom.create(max(10000, multiplier * n))
    if n:
        bloom.add(values)
    raw = values.tobytes()
    with open(path, "wb") as f:
        f.write(hashlib.sha256(bloom.bf.tobytes()).digest())
        f.write(bloom.header_bytes())
        f.write(bloom.bf.tobytes())
        f.write(hashlib.sha256(raw).digest())
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)


def read_tbl(path: str, skip_checksum: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """-> (value (n, 6) uint8, index (n,) uint64), sorted by value."""
    size = os.path.getsize(path)
    n = (size - 32) // XVALUE_SIZE
    if n * XVALUE_SIZE + 32 != size:
        raise ValueError(f"{path}: size is not n*16 + 32")
    with open(path, "rb") as f:
        raw = f.read(n * XVALUE_SIZE)
        ck = f.read(32)
    if not skip_checksum and hashlib.sha256(raw).digest() != ck:
        raise ValueError(f"{path}: table checksum mismatch")
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(n, XVALUE_SIZE)
    value = rec[:, :6].copy()
    index = np.ascontiguousarray(rec[:, 8:16]).view("<u8").reshape(-1)
    return value, index.astype(np.uint64)


def write_tbl(path: str, value: np.ndarray, index: np.ndarray) -> None:
    n = len(value)
    rec = np.zeros((n, XVALUE_SIZE), dtype=np.uint8)
    rec[:, :6] = value
    rec[:, 8:16] = index.astype("<u8")[:, None].view(np.uint8)
    raw = rec.tobytes()
    with open(path, "wb") as f:
        f.write(raw)
        f.write(hashlib.sha256(raw).digest())


# scalars a K6 call takes in baby_x_bytes: the width K6 is timed at (the
# minikeys chunk's valid-lane budget at B = 2^23)
X32_BATCH = 34816


def baby_x_bytes(m: int, device="cuda") -> np.ndarray:
    """(m, 32) big-endian X(j*G) for j = 1..m: on a CUDA device by K6 in
    batches of X32_BATCH scalars (x32_by_ladder); on the CPU by the exact
    incremental host walk. The same bytes either way."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        return x32_by_ladder(m, device)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    out = np.empty((m, 32), dtype=np.uint8)
    pt = ecref.G
    for j in range(m):
        out[j] = np.frombuffer(pt[0].to_bytes(32, "big"), dtype=np.uint8)
        if j + 1 < m:
            pt = ecref.point_add(pt, ecref.G)
    return out


def x32_by_ladder(m: int, device, batch: int = X32_BATCH) -> np.ndarray:
    """X(j*G), j = 1..m, as (m, 32) big-endian bytes through
    pladder.scalar_mult_tiles on `device` (K6 on a CUDA device, its plain
    version on the CPU): the scalars' limb 0 is an arange built on the
    device (j < 2^31), the rows are assembled there, and one copy brings
    them to the host. Irregular lanes are recomputed with ecref, as
    pladder.scalar_mult_points does."""
    from ..curve import pladder

    if not 1 <= m < 1 << 31:
        raise ValueError(f"m must be in [1, 2^31): {m}")
    gtx, gty = pladder.gtable_tensors(device)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=device)
    rows = torch.empty((m, 32), dtype=torch.uint8, device=device)
    flags = torch.empty(m, dtype=torch.bool, device=device)
    for s in range(0, m, batch):
        n = min(batch, m - s)
        k = torch.zeros((8, n), dtype=torch.int32, device=device)
        k[0] = torch.arange(s + 1, s + n + 1, dtype=torch.int32, device=device)
        x, _, inf, irr = pladder.scalar_mult_tiles(k, gtx, gty)
        # most significant limb first, each limb's bytes from the top
        be = (x.flip(0).t().unsqueeze(-1) >> shifts) & 0xFF
        rows[s:s + n] = be.reshape(n, 32).to(torch.uint8)
        flags[s:s + n] = inf | irr
    out = rows.cpu().numpy()
    for i in torch.nonzero(flags).flatten().tolist():
        out[i] = np.frombuffer(ecref.scalar_mult(i + 1)[0].to_bytes(32, "big"), dtype=np.uint8)
    return out


def derived_sizes(m: int) -> Tuple[int, int]:
    """(m2, m3) cascade sizes (keyhunt.cpp:1129-1161)."""
    m2 = m // 32 + (1 if m % 32 else 0)
    m3 = m2 // 32 + (1 if m2 % 32 else 0)
    return m2, m3


def export_reference_files(dirpath: str, m: int, x32: Optional[np.ndarray] = None,
                           device="cuda") -> List[str]:
    """Write a reference-loadable precompute set for baby size m.

    The reference reads these with `-S` (keyhunt.cpp:1373-1612) and skips
    its own table build — the capability its legacy deployments rely on
    (BSGSD.md:58-66). x32 defaults to baby_x_bytes(m, device): K6 on a
    CUDA device, the exact host walk on the CPU (slow for large m).
    """
    if x32 is None:
        x32 = baby_x_bytes(m, device)
    m2, m3 = derived_sizes(m)
    shard = x32[:, 0].astype(np.int64)
    paths = []
    for level, count, name in (
        (1, m, f"keyhunt_bsgs_4_{m}.blm"),
        (2, m2, f"keyhunt_bsgs_6_{m2}.blm"),
        (3, m3, f"keyhunt_bsgs_7_{m3}.blm"),
    ):
        blooms = [LegacyBloom.create(shard_entries(count, level))
                  for _ in range(256)]
        sub = x32[:count]
        ssub = shard[:count]
        for s in range(256):
            sel = sub[ssub == s]
            if len(sel):
                blooms[s].add(sel)
        p = os.path.join(dirpath, name)
        write_blm(p, blooms)
        paths.append(p)
    # bPtable: X bytes 16..21 of the first m3 babies, index = j-1,
    # sorted by value (keyhunt.cpp:70-73, 4523-4527, 1875)
    value = x32[:m3, 16:22]
    index = np.arange(m3, dtype=np.uint64)
    order = np.lexsort(tuple(value[:, i] for i in range(5, -1, -1)))
    p = os.path.join(dirpath, f"keyhunt_bsgs_2_{m3}.tbl")
    write_tbl(p, value[order], index[order])
    paths.append(p)
    return paths


def verify_against_ecref(dirpath: str, m: int, probes: int = 16) -> bool:
    """Spot-check a legacy file set against exact EC math: random baby
    indices must probe positive in every bloom level that covers them and
    appear in the table when j <= m3."""
    m2, m3 = derived_sizes(m)
    blooms1 = read_blm(os.path.join(dirpath, f"keyhunt_bsgs_4_{m}.blm"))
    blooms2 = read_blm(os.path.join(dirpath, f"keyhunt_bsgs_6_{m2}.blm"))
    blooms3 = read_blm(os.path.join(dirpath, f"keyhunt_bsgs_7_{m3}.blm"))
    value, index = read_tbl(os.path.join(dirpath, f"keyhunt_bsgs_2_{m3}.tbl"))
    rng = np.random.default_rng(0)
    for j in rng.integers(1, m + 1, probes):
        j = int(j)
        x = ecref.scalar_mult(j)[0].to_bytes(32, "big")
        x32 = np.frombuffer(x, dtype=np.uint8)[None, :]
        s = x[0]
        if not blooms1[s].check(x32)[0]:
            return False
        if j <= m2 and not blooms2[s].check(x32)[0]:
            return False
        if j <= m3:
            if not blooms3[s].check(x32)[0]:
                return False
            rows = np.nonzero((value == x32[0, 16:22]).all(axis=1))[0]
            if not any(int(index[r]) == j - 1 for r in rows):
                return False
    return True
