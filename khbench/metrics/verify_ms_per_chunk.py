"""Host milliseconds a chunk in the exact check of candidates (the
program's "verify" spans: BSGSEngine._try_candidates,
BruteEngine._verify_all) in the window's search call, over the chunks it
decoded."""

from ._program_call import last_call, span_s


def read(r):
    rec = last_call(r)
    if rec is None:
        return None
    return 1e3 * span_s(rec, "verify") / rec["chunks_decoded"]
