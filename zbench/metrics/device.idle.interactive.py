"""Percent of the traced window in which no device operation ran."""


def read(run):
    ts = run.trace_summary
    if ts is None or ts["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ts["busy_s"] / ts["window_s"])
