"""Seconds from the process's start to the window's start: imports, the
kernel build or its cache, the table and filters, the engine, the warm-up.
Where the card clock runs (khbench/card_clock.py), the seconds its profiler
took to start, just before the window, are the harness's and are left out."""


def read(r):
    return r["setup_s"]
