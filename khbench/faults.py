"""Timed paths broken on purpose: the control and the faults that a run's
checks must catch (``khbench/run.py --fault NAME``; the benchmark's own runs
set none).

- ``half_batch``: half of every chunk's queries are never searched (the
  odd lanes), while every key is still counted: the coverage guarantee
  broken. This is the control of every cell.
- ``state_unchanged``: a chunk hands on the walk state it was given.
- ``altered_answer``: each table match or hit a chunk reports names the
  neighbouring lane.
- ``no_exchange``: in a sharded run, the other cards' summaries never
  reach the first card.
"""

from __future__ import annotations

from typing import Callable, List

NAMES = ("half_batch", "state_unchanged", "altered_answer", "no_exchange")


def _set(obj, attr: str, value, undo: List[Callable]) -> None:
    had = attr in vars(obj)
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    undo.append(lambda: setattr(obj, attr, old) if had else delattr(obj, attr))


def _shift_live(out, C: int, B: int):
    """The summary with every live position (below B among its first C
    words) moved to its neighbouring lane."""
    import torch

    out = out.clone()
    pos = out[:C]
    out[:C] = torch.where(pos < B, pos ^ 1, pos)
    return out


def apply(name, eng, kind: str) -> Callable[[], None]:
    """Break engine `eng` (kind: "bsgs", "brute" or "bsgs_sharded") as
    `name` says; returns what undoes it (module functions are patched for
    the process)."""
    undo: List[Callable] = []
    if name is None:
        return lambda: None
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r} (one of {', '.join(NAMES)})")
    if name == "half_batch":
        _half_batch(eng, kind, undo)
    elif name == "state_unchanged":
        if kind == "bsgs_sharded":
            f = eng._sharded_chunk
            _set(eng, "_sharded_chunk", lambda bases: (bases, f(bases)[1]), undo)
        else:
            f = eng._chunk_fn
            _set(eng, "_chunk_fn", lambda px, py: (px, py, f(px, py)[2]), undo)
    elif name == "altered_answer":
        _altered(eng, kind, undo)
    elif name == "no_exchange":
        if kind != "bsgs_sharded":
            raise ValueError("no_exchange needs a sharded run")
        import torch

        f = eng._to_host
        _set(eng, "_to_host", lambda outs, B: f(
            [outs[0]] + [torch.zeros_like(outs[0]) for _ in outs[1:]], B), undo)
    return lambda: [u() for u in reversed(undo)]


def _half_batch(eng, kind: str, undo: List[Callable]) -> None:
    if kind == "brute":
        from keyhuntm1cpu_tpu_torch.curve import pbrute

        f = pbrute.brute_walk_blocks

        def walk(*args, **kw):
            hits = f(*args, **kw)
            hits[:, 1::2] = 0
            return hits

        walk.launches = f.launches  # the wrapped function counts its launches here
        _set(pbrute, "brute_walk_blocks", walk, undo)
        return
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    # a key whose bitmap bit is clear: the odd lanes' queries become it
    words, bits = eng.bitmap.words, eng.bitmap.bits_log2
    dead = next(v for v in range(1 << 12)
                if not (int(words[(v & ((1 << bits) - 1)) >> 5]) >> (v & 31)) & 1)
    f = bmp.filtered_survivors

    def survivors(bm, qhi, qlo, *args, **kw):
        qhi, qlo = qhi.clone(), qlo.clone()
        qhi[1::2] = 0
        qlo[1::2] = dead
        return f(bm, qhi, qlo, *args, **kw)

    _set(bmp, "filtered_survivors", survivors, undo)


def _altered(eng, kind: str, undo: List[Callable]) -> None:
    if kind == "bsgs_sharded":
        from keyhuntm1cpu_tpu_torch.parallel import mesh

        f = mesh.chunk_impl

        def chunk(*args, **kw):
            nx, ny, out = f(*args, **kw)
            return nx, ny, _shift_live(out, eng.C2, kw["T"] * kw["K"] * kw["U"])

        _set(mesh, "chunk_impl", chunk, undo)
        return
    f = eng._chunk_fn
    p = eng.p
    if kind == "bsgs":
        C, B = eng.C2, len(eng.targets) * p.steps_per_chunk * p.block_u
    else:
        C, B = p.chunk_cand, p.steps_per_chunk * p.block_u

    def chunk(px, py):
        nx, ny, out = f(px, py)
        return nx, ny, _shift_live(out, C, B)

    _set(eng, "_chunk_fn", chunk, undo)
