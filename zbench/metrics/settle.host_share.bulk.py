"""Percent of the window's checks that the flat program flagged
(possible but not definite, or overflowed) and the host oracle settled:
the program's ``checks.fallback_*`` counters over the checks evaluated."""


def read(run):
    if run.kind != "bulk" or not run.batches_evaluated:
        return None
    c = run.counters
    settled = c.get("checks.fallback_overflow", 0.0) + c.get("checks.fallback_conditional", 0.0)
    return 100.0 * settled / (run.batches_evaluated * run.batch)
