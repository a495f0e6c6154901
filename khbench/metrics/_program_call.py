"""The record the program's registry keeps of its last search call
(``keyhuntm1cpu_tpu_torch.core.metrics``: start, end, chunks decoded, keys
covered times the multiplier, span totals and counter deltas), for the
readers of the program's own spans and counters."""


def last_call(r):
    """The record of the window's call: None where the program keeps no
    such record (a tree without spans), where it decoded no chunk, or
    where its keys are not the window's (the warm-up's call)."""
    try:
        from keyhuntm1cpu_tpu_torch.core import metrics
    except ImportError:
        return None
    last = getattr(metrics.get_metrics(), "last_call", None)
    rec = last() if last is not None else None
    if not rec or rec.get("keys") != r["keys"] or not rec.get("chunks_decoded"):
        return None
    return rec


def span_s(rec, name: str) -> float:
    """Seconds the call spent in spans `name` (0 where it had none)."""
    return rec["spans"].get(name, {}).get("seconds", 0.0)
