"""Target sets of the brute-force modes: addresses, hash160s, ETH
addresses and x coordinates.

Port of keyhuntm1cpu_tpu/utils/targets.py without the parsed target
cache. ``raw`` holds the exact digests the host verifies against: 20-byte
hash160 / ETH digests or 32-byte big-endian x coordinates.
``build_table`` packs them into the sorted 64-bit key table the minikeys
and large-target brute paths search (filter/sorted_table.py);
``build_bitmap`` into the level-1 bitmap the brute path probes first
(filter/bitmap.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

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
    for ln in lines:
        tok = ln.split()[0]
        if kind in ("address", "rmd160"):
            h = _parse_line_address(tok)
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
