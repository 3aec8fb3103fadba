"""The 95th percentile, over every request due in the window, of its
answer's time minus its due time; a shed or failed request is infinitely
late (then 1e9 ms)."""

from zbench import stats


def read(run):
    if run.kind != "serve":
        return None
    return stats.finite_or(stats.percentile(run.request_ms, 95), 1e9)
