"""The 95th percentile of the LookupSubjects requests alone."""

from zbench import stats


def read(run):
    if run.kind != "lookup":
        return None
    ms = [t for k, t in run.lookup_ms if k == "subjects"]
    return stats.finite_or(stats.percentile(ms, 95), 1e9) if ms else None
