"""Runners: one module a kind of engine a configuration names (its
``engine`` key), each with ``run(ctx) -> Outcome``."""
