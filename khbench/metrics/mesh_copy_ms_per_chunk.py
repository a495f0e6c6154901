"""Host milliseconds a sharded chunk in gathering the cards' summaries:
the program's "copy" spans (ShardedBSGSEngine._to_host: every card's
summary stacked on the first card, the interest sum, one copy to the
host) in the window's search call, over the sharded chunks it decoded."""

from ._program_call import last_call, span_s


def read(r):
    rec = last_call(r) if r["n_devices"] > 1 else None
    if rec is None:
        return None
    return 1e3 * span_s(rec, "copy") / rec["chunks_decoded"]
