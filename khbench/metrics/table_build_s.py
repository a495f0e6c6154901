"""Seconds to build the baby table, its bitmap and its bloom2 on the
(first) card, host clock around the build ending in a synchronize."""


def read(r):
    return r.get("table_build_s")
