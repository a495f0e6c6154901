"""Casascius minikey search engine.

Port of keyhuntm1cpu_tpu/engine/minikeys.py. A minikey is 'S' + 21 base58
characters; it is valid iff sha256(minikey + '?')[0] == 0, and its
private key is sha256(minikey) (the reference's -m minikeys). The engine
scans a suffix counter: the prefix (12 characters, 'S' first) and the 5
high counter digits are fixed per chunk, the 5 low digits are generated on
the card. One chunk of B minikeys is:

1. **K5** validity (hash/pminikey.minikey_valid): a (B,) mask;
2. **compaction and key derivation** (pminikey.compact_keys, one
   kernel): the exact count of valid lanes, the positions of the first V
   in ascending order (no host sync) and sha256(minikey) of those lanes
   as scalar limbs;
3. **K6** the scalar-mult ladder (curve/pladder.scalar_mult_tiles);
4. **K7, K8** hash160 of the compressed (parity from y) and uncompressed
   public keys (hash/phash.py);
5. lookup of both in the sorted target table, and a packed int32 summary
   [n_valid, n_check, lanes (HM)]: the lanes to verify on the host (table
   hits and irregular ladder lanes), fill B.

Up to pipeline_depth chunks are in flight (engine/pipeline.py);
summaries come back through pinned non-blocking copies. Every flagged
lane is re-verified on the host with the exact references (ref/hashref,
ref/ecref); a budget overflow (more than V valid lanes or HM flagged
ones) rescans the chunk on the host.
A checkpoint (mode "minikeys") saves the prefix and the counter past the
last decoded chunk; a resumed engine adopts both.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.checkpoint import fingerprint
from ..curve import pladder
from ..filter import sorted_table as st
from ..filter.bitmap import compact_positions
from ..hash import phash, pminikey
from ..ref import ecref, hashref
from ..utils.targets import TargetSet
from . import pipeline
from .common import FoundKey, SearchStats

_B58 = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
SUFFIX_LEN = 10
DEVICE_DIGITS = pminikey.DEVICE_DIGITS  # low digits made on the card (58^5 < 2^31)
LOW_SPAN = 58 ** DEVICE_DIGITS


def valid_budget(batch: int) -> int:
    """Compacted valid-lane budget: mean + 8*sqrt(mean) + 512, rounded to
    512 (validity is Bernoulli(2^-8); an overflow falls back to an exact
    host rescan)."""
    mean = max(1, batch // 256)
    need = mean + 8 * int(mean ** 0.5) + 512
    return max(2048, ((need + 511) // 512) * 512)


@dataclass(frozen=True)
class MinikeyParams:
    """keyhuntm1cpu_tpu's MinikeyParams without the TPU kernel switch
    (pallas) and the XLA ladder's inversion chain (chain_len)."""

    batch: int = 262144  # minikeys per chunk; tuned_params gives the card's
    valid_max: int = 2048  # V: compacted valid-lane budget (expected B/256)
    hit_max: int = 64  # HM: flagged-lane budget per chunk
    pipeline_depth: int = 8  # chunks in flight ahead of host decode


def tuned_params(batch: Optional[int] = None, device="cuda") -> MinikeyParams:
    """MinikeyParams for `device`: batch 2^23 on the card (the JAX package's
    device batch), the dataclass default on the CPU; valid_max always
    follows the batch through valid_budget."""
    if batch is None:
        if torch.device(device).type == "cpu":
            return MinikeyParams()
        batch = 1 << 23
    return MinikeyParams(batch=batch, valid_max=valid_budget(batch))


def _b58_digits(v: int, n: int, alphabet: str = _B58) -> str:
    out = []
    for _ in range(n):
        v, d = divmod(v, 58)
        out.append(alphabet[d])
    return "".join(reversed(out))


def _pack_block_words(msgs: np.ndarray, msg_len: int) -> np.ndarray:
    """(B, L) bytes -> (B, 16) uint32 BE words of the padded block."""
    b = msgs.shape[0]
    block = np.zeros((b, 64), dtype=np.uint8)
    block[:, :msg_len] = msgs[:, :msg_len]
    block[:, msg_len] = 0x80
    bitlen = msg_len * 8
    block[:, 62] = (bitlen >> 8) & 0xFF
    block[:, 63] = bitlen & 0xFF
    return block.reshape(b, 16, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32)


def minikey_finish(base_lo: int, valid: torch.Tensor, w22_base: torch.Tensor,
                   gtx: torch.Tensor, gty: torch.Tensor, table: st.SortedXTable, *,
                   B: int, V: int, HM: int, alphabet: str = _B58) -> torch.Tensor:
    """Port of _minikey_finish_impl: steps 2-5 of a chunk. Returns the
    (2 + HM,) int32 summary [n_valid, n_check, lanes]; lanes are batch
    indices to verify on the host, ascending, fill B. Unlike the JAX
    package, n_valid is never poisoned: the compaction is exact."""
    n_valid, vidx, k = pminikey.compact_keys(valid, V, base_lo, w22_base, B, alphabet)
    live = vidx < B
    x, y, inf, irr = pladder.scalar_mult_tiles(k, gtx, gty)
    odd = (y[0] & 1) == 1
    (cle, che), (clo, cho) = phash.hash160_x2_from_batch(x)
    lu_lo, lu_hi = phash.hash160_u_from_batch(x, y)
    lc = st.lookup(table, torch.where(odd, cho, che), torch.where(odd, clo, cle))
    lu = st.lookup(table, lu_hi, lu_lo)
    hit = (lc.found | lc.found2 | lu.found | lu.found2) & ~inf
    check = (hit | irr) & live
    n_check = check.sum(dtype=torch.int32)
    hidx = compact_positions(check, HM, V)
    lanes = torch.where(hidx < V, vidx[hidx.clamp(max=V - 1).long()], B)
    return torch.cat([n_valid.reshape(1), n_check.reshape(1), lanes.to(torch.int32)])


class MinikeyEngine:
    def __init__(self, targets: TargetSet, prefix: Optional[str] = None,
                 params: MinikeyParams = MinikeyParams(), alphabet: Optional[str] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if not len(targets.raw):
            raise ValueError("no targets")
        p = params
        if not 1 <= p.batch <= LOW_SPAN:
            raise ValueError(f"batch must be in [1, 58^{DEVICE_DIGITS}]")
        if p.valid_max < 1 or p.hit_max < 1 or p.pipeline_depth < 1:
            raise ValueError("valid_max, hit_max and pipeline_depth must be >= 1")
        if alphabet is None:
            alphabet = _B58
        if len(alphabet) != 58 or len(set(alphabet)) != 58:
            raise ValueError("minikey alphabet must be 58 distinct characters "
                             "(reference -8, keyhunt.cpp:756-765)")
        if any(ord(c) > 0x7F for c in alphabet):
            raise ValueError("minikey alphabet must be ASCII")
        self.alphabet = alphabet
        if prefix is None:
            prefix = "S" + "".join(secrets.choice(alphabet) for _ in range(21 - SUFFIX_LEN))
        if not prefix.startswith("S") or len(prefix) != 22 - SUFFIX_LEN or not prefix.isascii():
            raise ValueError(f"prefix must be 'S' + {21 - SUFFIX_LEN} base58 chars")
        self.prefix = prefix
        self.targets = targets
        # first occurrence wins on duplicate targets
        self._raw_index = {r: i for i, r in reversed(list(enumerate(targets.raw)))}
        self.table = targets.build_table(self.device)
        self.p = p
        self.stats = SearchStats()
        self.counter = 0  # suffix counter in [0, 58^SUFFIX_LEN)
        self._gx, self._gy = pladder.gtable_tensors(self.device)
        self._base_cache = {}

    def _base_words(self, prefix17: str):
        """(w22, w23): (16,) int32 block words on the device of the 22- and
        23-byte messages with the 5 device digit bytes (17..21) zeroed."""
        if prefix17 not in self._base_cache:
            msg = np.zeros((1, 23), dtype=np.uint8)
            msg[0, :17] = np.frombuffer(prefix17.encode(), dtype=np.uint8)
            w22 = _pack_block_words(msg[:, :22], 22)[0]
            msg[0, 22] = ord("?")
            w23 = _pack_block_words(msg, 23)[0]
            self._base_cache[prefix17] = tuple(
                torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(self.device)
                for w in (w22, w23))
        return self._base_cache[prefix17]

    def _minikey_str(self, prefix17: str, low: int, lane: int) -> str:
        return prefix17 + _b58_digits(low + lane, DEVICE_DIGITS, self.alphabet)

    def _chunk_fn(self, low: int, w22: torch.Tensor, w23: torch.Tensor) -> torch.Tensor:
        """One chunk on the device: K5, then minikey_finish. No host sync."""
        p = self.p
        valid = pminikey.minikey_valid(low, w23, p.batch, self.alphabet)
        return minikey_finish(low, valid, w22, self._gx, self._gy, self.table, B=p.batch,
                              V=p.valid_max, HM=p.hit_max, alphabet=self.alphabet)

    def search(self, max_chunks: int = 1 << 30, stop_on_first: bool = True,
               progress_every: int = 0, checkpoint=None,
               max_seconds: Optional[float] = None,
               counter_end: Optional[int] = None) -> List[FoundKey]:
        """Scan from self.counter in engine/pipeline.py's loop; counter_end
        bounds the scan to the counter range [self.counter, counter_end).
        A chunk that would cross a 58^5 boundary is clamped back (a tiny
        overlap, never a gap). checkpoint: a core.checkpoint.
        CheckpointManager; a saved run's prefix and counter replace this
        engine's."""
        plan = _MinikeyPlan(self, max_chunks, counter_end)
        if checkpoint is not None:
            # the position (prefix and counter) does not depend on the batch,
            # so the fingerprint pins only what the scan means
            params_fp = (fingerprint("minikeys-v2") if self.alphabet == _B58
                         else fingerprint("minikeys-v2", self.alphabet))
            ck = pipeline.open_checkpoint(
                plan, checkpoint, self.stats,
                dict(mode="minikeys", params_fp=params_fp,
                     targets_fp=fingerprint(sorted(self.targets.raw))),
                range_start=0, range_end=0, policy="sequential", seed=0,
                extra={"prefix": self.prefix, "counter": self.counter})
            if ck is not None:
                self.prefix = ck.extra["prefix"]
                self.counter = int(ck.extra["counter"])
                # the saved finds: their span is skipped now
                plan.found0 = [fk for h in ck.found for fk in self._reverify_scalar(int(h, 16))]
        return pipeline.run("search", plan, stop_on_first, max_seconds, progress_every)

    def _reverify_scalar(self, k: int, mk: str = "") -> List[FoundKey]:
        """FoundKeys of private key k: the hash160 of both forms of its
        public key against the targets (a checkpoint's saved key comes
        without its minikey mk)."""
        if not 1 <= k < ecref.N:
            return []
        pt = ecref.scalar_mult(k)
        out = []
        for compressed in (False, True):
            i = self._raw_index.get(hashref.pubkey_to_hash160(pt, compressed=compressed))
            if i is not None:
                out.append(FoundKey(private_key=k, pubkey=pt, compressed=compressed,
                                    target=self.targets.labels[i] + (mk and f" (minikey {mk})")))
        return out

    def _verify_minikey(self, mk: str) -> Optional[FoundKey]:
        if hashref.sha256((mk + "?").encode())[0] != 0:
            return None
        found = self._reverify_scalar(int.from_bytes(hashref.sha256(mk.encode()), "big"), mk)
        return found[0] if found else None


class _MinikeyPlan(pipeline.ChunkPlan):
    """Chunks of B minikeys from the engine's counter: a position is (its
    17-character prefix, low counter, the counter after it)."""

    label = "minikeys"

    def __init__(self, eng: MinikeyEngine, max_chunks: int, counter_end: Optional[int]):
        self.eng, self.max_chunks, self.counter_end, self.n = eng, max_chunks, counter_end, 0
        self.device, self.depth = eng.device, eng.p.pipeline_depth

    def next(self):
        eng, B = self.eng, self.eng.p.batch
        if self.n >= self.max_chunks or (self.counter_end is not None
                                         and eng.counter >= self.counter_end):
            return None
        high, low = divmod(eng.counter, LOW_SPAN)
        if low + B > LOW_SPAN:
            low = LOW_SPAN - B
            eng.counter = (high + 1) * LOW_SPAN
        else:
            eng.counter += B
        self.n += 1
        return self.n - 1, (eng.prefix + _b58_digits(high, 5, eng.alphabet), low, eng.counter)

    def base(self, cid, pos):
        return self.eng._base_words(pos[0])

    def dispatch(self, pos, words):
        return self.eng._chunk_fn(pos[1], *words)

    def decode(self, pos, arr: np.ndarray):
        """The flagged lanes verified; a budget overflow: every lane."""
        eng, p = self.eng, self.eng.p
        prefix17, low, _ = pos
        lanes = arr[2:]
        lanes = (range(p.batch) if int(arr[0]) > p.valid_max or int(arr[1]) > p.hit_max
                 else lanes[lanes < p.batch])
        found = [eng._verify_minikey(eng._minikey_str(prefix17, low, int(n))) for n in lanes]
        return [f for f in found if f is not None], p.batch, None

    def mark(self, ck, pos, n_done: int) -> None:
        ck.chunks_done = n_done
        ck.extra = {"prefix": self.eng.prefix, "counter": pos[2]}
