"""The mean milliseconds a submission waited in the batcher's queue before
its batch formed: the window's count and sum of ``serve.queue_wait_s``."""


def read(run):
    c = run.counters
    n = c.get("serve.queue_wait_s.count", 0.0)
    return c.get("serve.queue_wait_s.total_s", 0.0) * 1e3 / n if n else None
