"""A Go-style Context: cancellation, deadline, and request-scoped values.

The reference API passes ``context.Context`` as the first argument of every
client method and carries the SpiceDB overlap key in outgoing gRPC metadata
(consistency/consistency.go:21-23, client/client.go:182-191).  This is the
structural equivalent so the client surface keeps the same shape: methods
take ``ctx`` first, cancellation stops streams, and ``with_value`` carries
request metadata such as the overlap key.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping, Optional


class Context:
    """Immutable-ish context chain with cancellation and deadline."""

    def __init__(
        self,
        parent: Optional["Context"] = None,
        *,
        deadline: Optional[float] = None,
        values: Optional[Mapping[str, Any]] = None,
        _root: bool = False,
    ) -> None:
        self._parent = parent
        self._deadline = deadline
        self._values = dict(values or {})
        self._cancelled = threading.Event()
        self._root = _root

    # -- values ------------------------------------------------------------
    def value(self, key: str) -> Any:
        if key in self._values:
            return self._values[key]
        if self._parent is not None:
            return self._parent.value(key)
        return None

    def with_value(self, key: str, val: Any) -> "Context":
        return Context(self, values={key: val})

    # -- tracing (utils/trace.py) ------------------------------------------
    def with_span(self, span) -> "Context":
        """Carry a request-scoped trace span (utils/trace.py) down the
        context chain — the structural analogue of the overlap key riding
        ``with_value``.  The NOOP span rides for free: the SAME context
        comes back, so the disabled-tracing path creates no child
        context (zero dict churn on the latency path)."""
        from . import trace as _trace

        return _trace.ctx_with_span(self, span)

    def span(self):
        """The active trace span carried by this context chain, or the
        NOOP singleton (one branch when tracing is disabled)."""
        from . import trace as _trace

        return _trace.span_of(self)

    # -- cancellation ------------------------------------------------------
    def with_cancel(self) -> "Context":
        return Context(self)

    def with_deadline(self, deadline: float) -> "Context":
        return Context(self, deadline=deadline)

    def with_timeout(self, seconds: float) -> "Context":
        return self.with_deadline(time.monotonic() + seconds)

    def cancel(self) -> None:
        # The background root is uncancellable, like Go's context.Background();
        # cancelling it would poison every context in the process.
        if self._root:
            return
        self._cancelled.set()

    def deadline(self) -> Optional[float]:
        own = self._deadline
        parent = self._parent.deadline() if self._parent is not None else None
        if own is None:
            return parent
        if parent is None:
            return own
        return min(own, parent)

    def done(self) -> bool:
        if self._cancelled.is_set():
            return True
        dl = self.deadline()
        if dl is not None and time.monotonic() >= dl:
            return True
        return self._parent.done() if self._parent is not None else False

    def err(self) -> Optional[BaseException]:
        from .errors import CancelledError, DeadlineExceededError

        if self._cancelled.is_set() or (self._parent is not None and self._parent.done()):
            if self._is_deadline_hit():
                return DeadlineExceededError("context deadline exceeded")
            return CancelledError("context cancelled")
        if self._is_deadline_hit():
            return DeadlineExceededError("context deadline exceeded")
        return None

    def _is_deadline_hit(self) -> bool:
        dl = self.deadline()
        return dl is not None and time.monotonic() >= dl

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until this context is done (cancelled anywhere in the chain,
        or past its deadline).  Returns True if done, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.done():
                return True
            step = 0.05
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self.done()
                step = min(step, remaining)
            dl = self.deadline()
            if dl is not None:
                step = min(step, max(dl - time.monotonic(), 0.0) + 0.001)
            # Wake promptly on own cancellation; parent cancellation and
            # deadlines are caught by the poll above.
            self._cancelled.wait(step)


_BACKGROUND = Context(_root=True)


def background() -> Context:
    return _BACKGROUND


def todo() -> Context:
    return _BACKGROUND
