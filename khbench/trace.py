"""What a traced run records, from the benchmark's own files.

The program has no spans of its own yet, so the harness sets them on the
engine instance it drives (the chunk dispatch and the summary decode) and
times the card with CUDA events:

- a pair of events on the device's stream around every chunk (each
  shard's chunk on its card in a sharded run), recorded outside the host
  spans: the device intervals of bench_modes.chunk_window's idle share;
- a pair around each kernel launch (``_build.launch``, which every kernel
  of the main path enters with its stream) in one chunk of every
  KERNEL_EVERY, so that the card time by kernel costs the host little; the
  host spans of those chunks are left out of the dispatch time.

Host times are ``time.perf_counter`` seconds. A reference event recorded
on an idle device at the window's start ties device times to the host's
clock, which names each idle gap by what the host was doing then.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional

KERNEL_EVERY = 4


class Recorder:
    """Spans and events of one measured window (inert when off)."""

    def __init__(self, on: bool, devices: List):
        self.on = on
        self.devices = list(dict.fromkeys(devices))
        self.cuda = all(d.type == "cuda" for d in self.devices)  # else host spans alone
        self.dispatch: List[tuple] = []  # (t0, t1, sampled)
        self.decode: List[tuple] = []  # (t0, t1)
        self.pairs: Dict[object, List[tuple]] = defaultdict(list)  # device -> [(e0, e1)]
        self.launches: List[tuple] = []  # (kernel, e0, e1)
        self.ref: Dict[object, tuple] = {}  # device -> (event, host seconds)
        self.t0 = self.t1 = None
        self._sampling = False
        self._launch = None

    # -- the window ---------------------------------------------------------

    def start(self) -> None:
        if self.on and self.cuda:
            import torch

            from keyhuntm1cpu_tpu_torch import _build

            for d in self.devices:
                torch.cuda.synchronize(d)
                e = torch.cuda.Event(enable_timing=True)
                e.record(torch.cuda.current_stream(d))
                e.synchronize()
                self.ref[d] = (e, time.perf_counter())
            self._launch = _build.launch
            _build.launch = self._timed_launch
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        if self.on and self.cuda:
            import torch

            from keyhuntm1cpu_tpu_torch import _build

            _build.launch = self._launch
            for d in self.devices:
                torch.cuda.synchronize(d)

    # -- hooks --------------------------------------------------------------

    def _event(self, device):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(device))
        return e

    def dispatch_call(self, fn, args, pair_device=None):
        """fn(*args) as one chunk's dispatch: a host span, and with
        pair_device a device interval around it."""
        if not self.on:
            return fn(*args)
        sampled = len(self.dispatch) % KERNEL_EVERY == 0
        e0 = None if pair_device is None or not self.cuda else self._event(pair_device)
        self._sampling = sampled
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
        self._sampling = False
        if e0 is not None:
            self.pairs[pair_device].append((e0, self._event(pair_device)))
        self.dispatch.append((t0, t1, sampled))
        return out

    def pair_call(self, device, fn, args):
        """fn(*args) between a pair of events on `device` (a shard's chunk)."""
        if not (self.on and self.cuda):
            return fn(*args)
        e0 = self._event(device)
        out = fn(*args)
        self.pairs[device].append((e0, self._event(device)))
        return out

    def decode_call(self, fn, args):
        if not self.on:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        self.decode.append((t0, time.perf_counter()))
        return out

    def _timed_launch(self, fn: str, *args):
        if not self._sampling:
            return self._launch(fn, *args)
        import torch

        from keyhuntm1cpu_tpu_torch import _build

        s = next(a for a in args if isinstance(a, _build.Stream))
        stream = torch.cuda.current_stream(torch.device("cuda", s.device))
        if stream.cuda_stream != int(s):
            # a side stream's launch: events on another stream would not bracket it
            return self._launch(fn, *args)
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        self._launch(fn, *args)
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record(stream)
        self.launches.append((fn, e0, e1))

    # -- reduction ----------------------------------------------------------

    def _intervals(self, device) -> List[tuple]:
        """Host-clock (start, end) seconds of the device's chunk intervals."""
        if device not in self.ref:
            return []
        ref, host = self.ref[device]
        return [(host + ref.elapsed_time(a) / 1e3, host + ref.elapsed_time(b) / 1e3)
                for a, b in self.pairs.get(device, [])]

    def reduce(self) -> Optional[dict]:
        """The traced window's readings (None when tracing was off)."""
        if not self.on:
            return None
        sampled = [d for d in self.dispatch if d[2]]
        kernels: Dict[str, float] = defaultdict(float)
        for name, a, b in self.launches:
            kernels[name] += a.elapsed_time(b)
        cards = {}
        for d in self.devices:
            iv = self._intervals(d)
            if self.cuda and iv:
                busy = sum(b - a for a, b in iv)
                span = iv[-1][1] - iv[0][0]
                cards[str(d)] = dict(busy_s=busy, span_s=span, idle=1 - busy / span,
                                     intervals=iv)
        first = self.pairs.get(self.devices[0], [])
        sampled_pair_ms = [a.elapsed_time(b) for (a, b), d in zip(first, self.dispatch) if d[2]] \
            if self.cuda and len(first) == len(self.dispatch) else []
        return dict(
            window_s=self.t1 - self.t0,
            sampled_pair_ms=sampled_pair_ms,
            n_dispatch=len(self.dispatch),
            dispatch_ms=[1e3 * (b - a) for a, b, s in self.dispatch if not s],
            n_sampled=len(sampled),
            decode_ms=[1e3 * (b - a) for a, b in self.decode],
            kernel_ms=dict(kernels),
            kernel_launches=_count(n for n, _, _ in self.launches),
            cards=cards,
            idle_gaps=self._idle_gaps(cards[str(self.devices[0])]["intervals"])
            if str(self.devices[0]) in cards else {},
        )

    def _idle_gaps(self, iv: List[tuple]) -> Dict[str, float]:
        """Seconds the first device sat idle in the window, by what the
        host was doing: inside a chunk's dispatch, a summary's decode, or
        neither (waiting on a summary's event, the loop's own work), and
        before the first chunk and after the last."""
        spans = sorted([(a, b, "dispatch") for a, b, _ in self.dispatch]
                       + [(a, b, "decode") for a, b in self.decode])
        starts = [s[0] for s in spans]
        out: Dict[str, float] = defaultdict(float)
        out["before the first chunk"] = max(0.0, iv[0][0] - self.t0)
        out["after the last chunk"] = max(0.0, self.t1 - iv[-1][1])
        for (_, g0), (g1, _) in zip(iv, iv[1:]):
            if g1 <= g0:
                continue
            covered = 0.0
            i = max(0, bisect.bisect_right(starts, g0) - 1)
            while i < len(spans) and spans[i][0] < g1:
                a, b, kind = spans[i]
                ov = min(b, g1) - max(a, g0)
                if ov > 0:
                    out[kind] += ov
                    covered += ov
                i += 1
            out["wait"] += (g1 - g0) - covered
        return dict(out)


def _count(names) -> Dict[str, int]:
    out: Dict[str, int] = defaultdict(int)
    for n in names:
        out[n] += 1
    return dict(out)
