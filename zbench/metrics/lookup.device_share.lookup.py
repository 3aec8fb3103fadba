"""Percent of the window's lookup streams that the device frontier served
(``lookups.frontier``) of all, the host walker's (``lookups.walker``)
beside them.  Both counters are taken where the program picks the path."""


def read(run):
    c = run.counters
    dev = c.get("lookups.frontier", 0.0)
    host = c.get("lookups.walker", 0.0)
    return 100.0 * dev / (dev + host) if dev + host else None
