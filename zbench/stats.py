"""The arithmetic of the end-to-end metrics: nearest-rank percentiles over
every request (a failed one counts as infinitely late), latency from the
time a request was due, and the rate over a whole window."""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence


def percentile(samples: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100), or None with no
    samples.  ``inf`` samples sort last."""
    s = sorted(samples)
    if not s:
        return None
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def due_latency_ms(due: float, resolved: Optional[float]) -> float:
    """Milliseconds from when a request was due to when its answer came;
    ``inf`` for one that never came.  Timing from the due time counts the
    wait that a stall of the sender or the queue puts on later requests."""
    if resolved is None:
        return math.inf
    return (resolved - due) * 1e3


def window_rate(ends: Sequence[float], sizes: Sequence[int], t0: float, t1: float) -> float:
    """Work per second of the window [t0, t1]: the sizes of the units that
    finished inside it, over its length.  A unit still in flight at t1
    counts for nothing."""
    done = sum(n for e, n in zip(ends, sizes) if t0 <= e <= t1)
    return done / (t1 - t0)


def finite_or(value: Optional[float], cap: float) -> Optional[float]:
    """A JSON-safe number: ``cap`` in place of ``inf``."""
    if value is None:
        return None
    return cap if math.isinf(value) else value
