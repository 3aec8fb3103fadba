"""The 95th percentile, over every lookup issued in the window, of the
time from its call to its complete answer; a failed lookup is infinitely
late (then 1e9 ms)."""

from zbench import stats


def read(run):
    if run.kind != "lookup":
        return None
    return stats.finite_or(stats.percentile([ms for _, ms in run.lookup_ms], 95), 1e9)
