"""Target sets of the brute-force modes: addresses, hash160s, ETH
addresses and x coordinates.

Port of keyhuntm1cpu_tpu/utils/targets.py: the same files parse to the
same sets, address files past 10,000 lines through the native bulk parse
(native.py), and ``parse_target_file_cached`` keeps the JAX package's
content-addressed npz cache (a cache either package writes loads in the
other) beside a read-through of the reference's ``data_<8hex>.dat``.
``raw`` holds the exact digests the host verifies against: 20-byte
hash160 / ETH digests or 32-byte big-endian x coordinates.
``build_table`` packs them into the sorted 64-bit key table the minikeys
and large-target brute paths search (filter/sorted_table.py);
``build_bitmap`` into the level-1 bitmap the brute path probes first
(filter/bitmap.py).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.log import get_logger
from ..filter import sorted_table as st
from ..ref import ecref, hashref


@dataclass
class TargetSet:
    kind: str  # 'hash160' | 'eth' | 'xpoint' | 'pubkey'
    raw: List[bytes]  # 20-byte digests or 32-byte X (exact host compare)
    labels: List[str]  # original text form, for reports
    pubkeys: List[Tuple[int, int]] = field(default_factory=list)  # pubkey kind
    _built: dict = field(default_factory=dict, repr=False, compare=False)

    def target_words(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) uint32 arrays of the 64-bit truncated target keys,
        unsorted (row i = raw[i]). Packing matches the device hashes:
        hash160 / ETH digest bytes 0..3 and 4..7 as little-endian words;
        xpoint the low 64 bits of X."""
        if not self.raw:
            return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
        rows = np.frombuffer(b"".join(self.raw), dtype=np.uint8).reshape(len(self.raw), -1)
        if self.kind == "xpoint":  # the last 8 big-endian bytes
            return (rows[:, -4:].copy().view(">u4")[:, 0].astype(np.uint32),
                    rows[:, -8:-4].copy().view(">u4")[:, 0].astype(np.uint32))
        return (rows[:, 0:4].copy().view("<u4")[:, 0].astype(np.uint32),
                rows[:, 4:8].copy().view("<u4")[:, 0].astype(np.uint32))

    def build_table(self, device="cpu") -> st.SortedXTable:
        """The sorted key table on `device` (payload: row in raw),
        memoized per device."""
        key = ("table", str(device))
        if key not in self._built:
            lo, hi = self.target_words()
            idx = np.arange(len(self.raw), dtype=np.uint32)
            self._built[key] = st.build_sorted_table(hi, lo, idx, device)
        return self._built[key]

    def build_bitmap(self, bits_log2: Optional[int] = None, device="cpu"):
        """The level-1 bitmap over the target keys on `device`
        (bitmap.build_bitmap; default size default_bits_log2(len)),
        memoized per size and device."""
        key = ("bitmap", bits_log2, str(device))
        if key not in self._built:
            from ..filter import bitmap as bmp

            lo, hi = self.target_words()
            self._built[key] = bmp.build_bitmap(hi, lo, bits_log2, device)
        return self._built[key]

    def __len__(self) -> int:
        return len(self.raw)


NATIVE_PARSE_MIN = 10000  # address files past this many lines parse natively


def _parse_line_address(line: str) -> Optional[bytes]:
    line = line.strip()
    if not line:
        return None
    if len(line) == 40:
        try:
            return bytes.fromhex(line)
        except ValueError:
            pass
    return hashref.b58check_decode(line)[1:]


def parse_target_file(path: str, kind: str) -> TargetSet:
    """Parse a text file of targets, one per line (the first token counts).
    kind in {'address', 'rmd160', 'eth', 'xpoint', 'pubkey'}."""
    raw: List[bytes] = []
    labels: List[str] = []
    pubkeys: List[Tuple[int, int]] = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    native_h160: dict = {}
    if kind in ("address", "rmd160") and len(lines) > NATIVE_PARSE_MIN:
        # big address files through the native bulk parse (6.5x the python
        # parse's lines/s, phase 5l of chip_smoke.py); a zero row is a bad
        # line, which the python parse below then reports
        from .. import native

        b58 = [t for t in (ln.split()[0] for ln in lines) if len(t) != 40]
        for t, row in zip(b58, native.parse_addresses("\n".join(b58).encode(), len(b58))):
            if row.any():
                native_h160[t] = row.tobytes()
    for ln in lines:
        tok = ln.split()[0]
        if kind in ("address", "rmd160"):
            h = native_h160.get(tok) or _parse_line_address(tok)
            if h is None or len(h) != 20:
                raise ValueError(f"bad address/rmd160 target: {ln!r}")
            raw.append(h)
        elif kind == "eth":
            t = tok[2:] if tok.lower().startswith("0x") else tok
            if len(t) != 40:
                raise ValueError(f"bad eth target: {ln!r}")
            raw.append(bytes.fromhex(t.lower()))
        elif kind == "xpoint":
            if len(tok) in (66, 130):  # a full pubkey: take X
                raw.append(ecref.parse_pubkey(tok)[0].to_bytes(32, "big"))
            elif len(tok) == 64:
                raw.append(bytes.fromhex(tok))
            else:
                raise ValueError(f"bad xpoint target: {ln!r}")
        elif kind == "pubkey":
            pt = ecref.parse_pubkey(tok)
            pubkeys.append(pt)
            raw.append(pt[0].to_bytes(32, "big"))
        else:
            raise ValueError(f"unknown target kind {kind}")
        labels.append(tok)
    out_kind = {"address": "hash160", "rmd160": "hash160"}.get(kind, kind)
    return TargetSet(kind=out_kind, raw=raw, labels=labels, pubkeys=pubkeys)


def targets_from_ints(kind: str, values: "Sequence[bytes | int]",
                      labels=None) -> TargetSet:
    """TargetSet from raw digests. Ints are converted big-endian at the
    kind's digest width (hash160/eth: 20 bytes, xpoint/pubkey: 32)."""
    widths = {"hash160": 20, "address": 20, "rmd160": 20, "eth": 20,
              "xpoint": 32, "pubkey": 32}
    if kind not in widths:
        raise ValueError(f"unknown target kind {kind!r}")
    width = widths[kind]
    raw = [v if isinstance(v, bytes) else int(v).to_bytes(width, "big")
           for v in values]
    return TargetSet(kind=kind, raw=raw,
                     labels=labels or [v.hex() for v in raw])


# ---------------------------------------------------------------------------
# Parsed-target cache: large target files are parsed once; reloads keyed by
# the file's content hash skip base58 / hex decoding. The JAX package's
# versioned npz with a sha256 checksum, and a read-through of the
# reference's binary data_<8-hex>.dat (keyhunt.cpp:6578-6678).
# ---------------------------------------------------------------------------

_CACHE_VERSION = 1


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cache_path_for(path: str, kind: str) -> str:
    """data_<sha8>_<kind>.npz beside the target file."""
    return os.path.join(os.path.dirname(os.path.abspath(path)) or ".",
                        f"data_{_file_digest(path)[:8]}_{kind}.npz")


def _reference_dat_targets(path: str, kind: str) -> Optional[TargetSet]:
    """Targets from a reference-written data_<8-hex>.dat beside the target
    file or in the cwd (the reference writes it to the cwd). Only the
    20-byte kinds (address, rmd160) map onto its table."""
    if kind not in ("address", "rmd160"):
        return None
    from . import legacy

    dirs = [os.path.dirname(os.path.abspath(path)) or ".", "."]
    for d in dict.fromkeys(os.path.abspath(x) for x in dirs):
        dat = legacy.dat_cache_path(path, d)
        if not os.path.exists(dat):
            continue
        try:
            _, values = legacy.read_dat(dat)
        except (OSError, ValueError):
            continue  # a corrupt or foreign file: parse the text
        raw = [v.tobytes() for v in values]
        get_logger().plus(f"read {len(raw)} targets from the reference cache {dat}")
        return TargetSet("hash160", raw, [b.hex() for b in raw])
    return None


def write_reference_dat(path: str, ts: TargetSet, dirpath: str = ".") -> str:
    """Write the reference-loadable data_<8-hex>.dat companion of a target
    file (the reference's -S address-mode cache); returns its path."""
    from . import legacy

    if ts.kind != "hash160" or any(len(b) != 20 for b in ts.raw):
        raise ValueError("a reference .dat holds 20-byte hash160 targets only")
    dat = legacy.dat_cache_path(path, dirpath)
    values = np.frombuffer(b"".join(ts.raw), dtype=np.uint8).reshape(-1, 20)
    legacy.write_dat(dat, values)
    return dat


def _load_cache(cpath: str) -> Optional[TargetSet]:
    try:
        with np.load(cpath, allow_pickle=False) as z:
            if int(z["version"]) != _CACHE_VERSION:
                return None
            raw_arr = z["raw"]
            if hashlib.sha256(raw_arr.tobytes()).hexdigest() != str(z["checksum"]):
                return None
            pubkeys = [(int.from_bytes(bytes(p[:32]), "big"),
                        int.from_bytes(bytes(p[32:]), "big")) for p in z["pubkeys"]]
            return TargetSet(str(z["kind"]), [bytes(r) for r in raw_arr],
                             [str(s) for s in z["labels"]], pubkeys)
    except (OSError, KeyError, ValueError):
        return None


def parse_target_file_cached(path: str, kind: str, reference_dat: bool = True) -> TargetSet:
    """parse_target_file with the content-addressed npz cache beside the
    file, preceded by a read-through of a reference data_<8-hex>.dat when
    one is present (reference_dat)."""
    if reference_dat:
        ts = _reference_dat_targets(path, kind)
        if ts is not None:
            return ts
    cpath = cache_path_for(path, kind)
    ts = _load_cache(cpath)
    if ts is not None:
        return ts
    ts = parse_target_file(path, kind)
    width = len(ts.raw[0]) if ts.raw else 20
    raw_arr = np.frombuffer(b"".join(ts.raw), dtype=np.uint8).reshape(-1, width)
    pub_arr = (np.frombuffer(b"".join(x.to_bytes(32, "big") + y.to_bytes(32, "big")
                                      for x, y in ts.pubkeys), dtype=np.uint8).reshape(-1, 64)
               if ts.pubkeys else np.zeros((0, 64), dtype=np.uint8))
    np.savez(cpath, version=np.int64(_CACHE_VERSION), kind=ts.kind, raw=raw_arr,
             labels=np.asarray(ts.labels), pubkeys=pub_arr,
             checksum=hashlib.sha256(raw_arr.tobytes()).hexdigest())
    return ts
