"""Host milliseconds a sharded chunk in dispatching every card's chunk:
the program's "dispatch" spans (one a card, around each card's chunk in
ShardedBSGSEngine._sharded_chunk) in the window's search call, over the
sharded chunks it decoded."""

from ._program_call import last_call, span_s


def read(r):
    rec = last_call(r) if r["n_devices"] > 1 else None
    if rec is None:
        return None
    return 1e3 * span_s(rec, "dispatch") / rec["chunks_decoded"]
