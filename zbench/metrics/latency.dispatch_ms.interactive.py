"""The mean milliseconds of one latency-path dispatch (host clock: lower,
copy in, replay, copy out): the window's count and sum of
``latency.dispatch_s``."""


def read(run):
    c = run.counters
    n = c.get("latency.dispatch_s.count", 0.0)
    return c.get("latency.dispatch_s.total_s", 0.0) * 1e3 / n if n else None
