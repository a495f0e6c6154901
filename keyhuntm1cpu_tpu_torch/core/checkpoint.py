"""Search-position checkpoint / resume.

Copy of keyhuntm1cpu_tpu/core/checkpoint.py: the file format is the JAX
package's (an envelope with the sha256 of the sorted-key JSON payload,
VERSION 1, ranges as hex), so a checkpoint written by either package
loads in the other.

- Engines enumerate work as a deterministic chunk order derived from
  (policy, seed, n_chunks), so a checkpoint only needs the count of
  completed chunks plus the identity of the run (range, params, targets).
- Writes are atomic (tmp + os.replace) and carry a sha256 of the payload.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from .errors import CheckpointError

VERSION = 1


@dataclass
class Checkpoint:
    mode: str
    range_start: int
    range_end: int
    policy: str
    seed: int
    params_fp: str  # fingerprint of engine params
    targets_fp: str  # fingerprint of the target set
    chunks_done: int = 0
    n_chunks: int = 0
    keys_covered: int = 0
    elapsed_s: float = 0.0
    found: list = field(default_factory=list)  # hex private keys already found
    extra: dict = field(default_factory=dict)  # mode-specific position
    # state (e.g. the minikey engine's base58 counter + prefix)
    version: int = VERSION
    saved_at: float = 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # ints in the payload can exceed 2^53; store ranges as hex strings
        d["range_start"] = f"{self.range_start:x}"
        d["range_end"] = f"{self.range_end:x}"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Checkpoint":
        d = dict(d)
        d["range_start"] = int(d["range_start"], 16)
        d["range_end"] = int(d["range_end"], 16)
        return cls(**d)


def fingerprint(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


class CheckpointManager:
    def __init__(self, path: str, every_s: float = 60.0):
        self.path = path
        self.every_s = every_s
        self._last_save = 0.0

    def load(self) -> Optional[Checkpoint]:
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                envelope = json.load(f)
            payload = envelope["payload"]
            digest = hashlib.sha256(
                json.dumps(payload, sort_keys=True).encode()
            ).hexdigest()
            if digest != envelope["sha256"]:
                raise CheckpointError(f"checkpoint {self.path} failed checksum")
            ck = Checkpoint.from_dict(payload)
            if ck.version != VERSION:
                raise CheckpointError(
                    f"checkpoint version {ck.version} != {VERSION}"
                )
            return ck
        except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
            raise CheckpointError(f"cannot load checkpoint {self.path}: {e}")

    def save(self, ck: Checkpoint, force: bool = False) -> bool:
        now = time.time()
        if not force and now - self._last_save < self.every_s:
            return False
        ck.saved_at = now
        payload = ck.to_dict()
        envelope = {
            "sha256": hashlib.sha256(
                json.dumps(payload, sort_keys=True).encode()
            ).hexdigest(),
            "payload": payload,
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(envelope, f)
        os.replace(tmp, self.path)
        self._last_save = now
        return True

    def matches(self, ck: Checkpoint, **expect) -> None:
        """Raise unless the checkpoint describes the same run."""
        for k, v in expect.items():
            got = getattr(ck, k)
            if got != v:
                raise CheckpointError(
                    f"checkpoint mismatch on {k}: saved {got!r} != current {v!r}"
                )
