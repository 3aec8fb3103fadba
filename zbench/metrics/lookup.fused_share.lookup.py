"""Percent of the window's lookup streams served by the fused K-hop
program (``lookups.fused``) of all, the device frontier's and the host
walker's (``lookups.frontier`` + ``lookups.walker``)."""


def read(run):
    c = run.counters
    n = c.get("lookups.frontier", 0.0) + c.get("lookups.walker", 0.0)
    return 100.0 * c.get("lookups.fused", 0.0) / n if n else None
