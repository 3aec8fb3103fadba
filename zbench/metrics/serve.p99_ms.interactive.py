"""The 99th percentile of the same latencies as ``check_p95_ms``, from
each request's due time."""

from zbench import stats


def read(run):
    if run.kind != "serve":
        return None
    return stats.finite_or(stats.percentile(run.request_ms, 99), 1e9)
