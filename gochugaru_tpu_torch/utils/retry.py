"""Exponential-backoff retry for retriable errors.

Mirrors the reference's envelope exactly: initial 50 ms, max interval 2 s,
multiplier 1.5, randomization factor 0.5 (client/client.go:205-210 with
cenkalti/backoff defaults), bounded by the context deadline.

Cancellation-honesty contract (tests/test_retry.py):
- the default backoff pause is the *context-aware* ``ctx.wait``, so a
  cancellation arriving mid-backoff interrupts the pause instead of
  waiting it out;
- ``ctx.err()`` is re-checked immediately after every pause, so a
  cancellation or deadline that landed during the backoff surfaces
  before the next ``fn()`` attempt, never after it;
- a deadline clamp that produces ``pause == 0`` skips the sleep call
  entirely (an injected fake sleep must not observe zero-length pauses).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

from . import metrics as _metrics
from . import trace as _trace
from .context import Context
from .errors import DeadlineExceededError, PermanentError, is_retriable

T = TypeVar("T")

INITIAL_INTERVAL = 0.050
MAX_INTERVAL = 2.0
MULTIPLIER = 1.5  # backoff.DefaultMultiplier
RANDOMIZATION_FACTOR = 0.5  # backoff.DefaultRandomizationFactor


def retry_retriable_errors(
    ctx: Context,
    fn: Callable[[], T],
    *,
    sleep: Optional[Callable[[float], None]] = None,
    max_tries: Optional[int] = None,
) -> T:
    """Run ``fn`` until it succeeds or fails permanently
    (client/client.go:193-211).  ``max_tries`` is an escape hatch for tests
    and deadline-less engine paths; the reference bounds retries only by
    the context.  ``sleep`` overrides the backoff pause (tests inject a
    fake); the default pause is ``ctx.wait`` so cancellation interrupts
    the backoff."""
    interval = INITIAL_INTERVAL
    tries = 0
    # the request's trace span rides the context (utils/trace.py); the
    # disabled path is one branch returning the NOOP singleton
    span = _trace.span_of(ctx)
    while True:
        err = ctx.err()
        if err is not None:
            raise err
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classify every error
            tries += 1
            if isinstance(e, PermanentError) and e.__cause__ is not None:
                raise e.__cause__
            if not is_retriable(e):
                raise
            if max_tries is not None and tries >= max_tries:
                raise
            dl = ctx.deadline()
            if dl is not None and time.monotonic() >= dl:
                raise DeadlineExceededError("context deadline exceeded") from e
            delta = RANDOMIZATION_FACTOR * interval
            pause = random.uniform(interval - delta, interval + delta)
            if dl is not None:
                # Never sleep past the deadline (backoff.WithContext behavior).
                pause = min(pause, max(dl - time.monotonic(), 0.0))
            _metrics.default.inc("retry.retries")
            span.event(
                "retry",
                error=type(e).__name__, attempt=tries,
                pause_s=round(pause, 6),
            )
            if pause > 0.0:
                if sleep is not None:
                    sleep(pause)
                else:
                    # context-aware pause: returns early on cancellation
                    ctx.wait(pause)
            # re-check immediately after the pause: a cancellation or
            # deadline that landed during the backoff must surface before
            # the next fn() attempt
            err = ctx.err()
            if err is not None:
                raise err
            interval = min(interval * MULTIPLIER, MAX_INTERVAL)
