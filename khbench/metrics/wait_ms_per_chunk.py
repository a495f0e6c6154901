"""Host milliseconds a chunk waiting on a summary's event (the program's
"wait" spans in the window's search call, over the chunks it decoded).
Near 0, the host paces the card."""

from ._program_call import last_call, span_s


def read(r):
    rec = last_call(r)
    if rec is None:
        return None
    return 1e3 * span_s(rec, "wait") / rec["chunks_decoded"]
