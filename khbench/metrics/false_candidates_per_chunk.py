"""Candidates the host verified that gave no key, a chunk: the program's
counter false_candidates over chunks_decoded, in the window's search
call."""

from ._program_call import last_call


def read(r):
    rec = last_call(r)
    if rec is None:
        return None
    return rec["counters"].get("false_candidates", 0) / rec["chunks_decoded"]
