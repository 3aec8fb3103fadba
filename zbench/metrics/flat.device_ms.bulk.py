"""Milliseconds of the card busy (the union of device intervals) in the
traced window, per batch that finished in it."""


def read(run):
    ts = run.trace_summary
    if ts is None or run.kind != "bulk":
        return None
    t0, t1 = run.trace_window
    n = sum(1 for e in run.batch_ends if t0 <= e <= t1)
    return ts["busy_s"] * 1e3 / n if n else None
