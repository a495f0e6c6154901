"""Seconds from the process's start to the window's start: imports, the
kernel build or its cache, the table and filters, the engine, the warm-up."""


def read(r):
    return r["setup_s"]
