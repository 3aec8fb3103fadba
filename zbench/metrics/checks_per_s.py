"""Checks answered with a final verdict inside the window, over the
window's seconds (a batch still in flight at the close counts for
nothing)."""

from zbench import stats


def read(run):
    if run.kind != "bulk":
        return None
    t0, t1 = run.window
    return stats.window_rate(run.batch_ends, [run.batch] * len(run.batch_ends), t0, t1)
