"""Host milliseconds a chunk outside the wait on a summary's event: the
program's own spans, the window's search call (its root span "search")
less its "wait" spans, over the chunks it decoded. Near the chunk's card
time, the host paces the card."""

from ._program_call import last_call, span_s


def read(r):
    rec = last_call(r)
    if rec is None:
        return None
    return 1e3 * (span_s(rec, "search") - span_s(rec, "wait")) / rec["chunks_decoded"]
