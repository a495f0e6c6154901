"""Metric readers, one module a metric named in BENCHMARK.json.

Each has ``read(r) -> float | None``: r holds the run's readings (the
window's keys and seconds, set-up seconds, the trace's reduction, the
cell's shapes, the card's clock). A reader that finds nothing to read
returns None, and the run leaves that metric out of its line.
"""
