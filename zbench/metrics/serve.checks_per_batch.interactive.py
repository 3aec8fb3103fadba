"""Checks a formed batch carried: the window's ``serve.checks`` over
``serve.batches``."""


def read(run):
    c = run.counters
    b = c.get("serve.batches", 0.0)
    return c.get("serve.checks", 0.0) / b if b else None
