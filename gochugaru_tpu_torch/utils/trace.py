"""Request-scoped tracing: spans and head sampling with a keep-slow
tail rule.

The span API the store and the client thread through a request: with no
tracer installed, ``root_span`` is one module-global load + branch
returning the ``NOOP`` singleton, every method on ``NOOP`` is a no-op
returning ``NOOP``, and ``ctx_with_span`` returns the SAME context.  A
configured tracer keeps finished traces in a bounded ring; requests the
head sample drops leave a root-only trace behind when they blow the
slow threshold (``maybe_keep_slow``).

Spans form a tree: ``root_span`` starts a trace, ``span.child`` nests;
timestamps are ``time.perf_counter()``.  The active span rides request
Context values (utils/context.py), and a thread-local "current span"
(set by ``with span:``) lets deep sites attach events through
``event_if_active``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

#: events kept per span before dropping (the drop count is recorded on
#: the span as ``events_dropped``)
MAX_EVENTS = 128

#: Context value key the active span rides on (utils/context.py)
SPAN_KEY = "gochugaru.trace.span"

#: total real Span objects ever constructed in this process — the
#: zero-allocation contract's witness (tests assert it does not move
#: when sampling is off)
_SPANS_CREATED = 0

#: module-level fast path: None ⇒ every entry point is one load + branch
_TRACER: Optional["Tracer"] = None

#: pid hex for trace ids, read ONCE — os.getpid() is a syscall per call.
#: Refreshed after fork so children don't reuse the parent's.
_PID_HEX = f"{os.getpid():x}"


def _refresh_pid() -> None:
    global _PID_HEX
    _PID_HEX = f"{os.getpid():x}"


if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_refresh_pid)

_tls = threading.local()


class _NoopSpan:
    """The disabled/unsampled span: every method is a no-op returning
    the singleton itself, so traced code needs no ``if span:`` guards
    and allocates nothing.  Identity (``span is NOOP``) is the
    zero-cost contract tests assert."""

    __slots__ = ()

    sampled = False
    trace_id = ""
    span_id = 0
    name = ""

    def child(self, name: str, t: Optional[float] = None, **attrs) -> "_NoopSpan":
        return self

    def child_at(self, name: str, t: float) -> "_NoopSpan":
        return self

    def event(self, name: str, t: Optional[float] = None, **attrs) -> "_NoopSpan":
        return self

    def set_attr(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def end(self, t: Optional[float] = None) -> None:
        return None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<NoopSpan>"


#: the singleton every disabled path returns
NOOP = _NoopSpan()


class Span:
    """One node of a sampled trace: name, parent link, monotonic start,
    attributes, bounded events.  ``end()`` freezes the duration and
    (for the root) hands the finished trace to the tracer's ring.

    Allocation discipline: a sampled dispatch constructs six of these
    and the marginal tail cost of tracing is GC pressure, not CPU — so
    ``attrs``/``events`` stay ``None`` until something is stored, the
    trace id renders lazily at export, and ``child_at`` takes no kwargs
    (a ``**attrs`` signature allocates a dict per call even when
    empty)."""

    __slots__ = (
        "_rec", "span_id", "parent_id", "name",
        "t0", "t1", "attrs", "events", "_dropped", "_tls_prev",
    )

    sampled = True

    def __init__(
        self,
        rec: "_TraceRec",
        name: str,
        parent_id: int,
        t: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        global _SPANS_CREATED
        _SPANS_CREATED += 1
        self._rec = rec
        # id allocation + registration inlined (single-writer per
        # request, so no lock): this constructor runs six times per
        # sampled dispatch and call overhead was the profile's top line
        self.span_id = rec._next_id
        rec._next_id += 1
        rec.spans.append(self)
        self.parent_id = parent_id
        self.name = name
        self.t0 = time.perf_counter() if t is None else t
        self.t1: Optional[float] = None
        self.attrs: Optional[Dict[str, Any]] = attrs
        self.events: Optional[List[Dict[str, Any]]] = None
        self._dropped = 0
        self._tls_prev: Any = None

    @property
    def trace_id(self) -> str:
        return self._rec.trace_id

    # -- tree --------------------------------------------------------------
    def child(self, name: str, t: Optional[float] = None, **attrs) -> "Span":
        """Start a child span.  ``t`` backdates the start (stage spans
        rebuilt from already-taken perf_counter timestamps)."""
        return Span(self._rec, name, self.span_id, t=t, attrs=attrs or None)

    def child_at(self, name: str, t: float) -> "Span":
        """Attribute-less child backdated to ``t`` — the stage-span fast
        path (no kwargs dict)."""
        return Span(self._rec, name, self.span_id, t=t)

    def event(self, name: str, t: Optional[float] = None, **attrs) -> "Span":
        """Attach a point-in-time event (bounded; drops are counted)."""
        evs = self.events
        if evs is None:
            evs = self.events = []
        elif len(evs) >= MAX_EVENTS:
            self._dropped += 1
            return self
        # raw float here; rounding happens once at export (as_dict) —
        # round() costs ~1 µs each under this container and events sit
        # on the request path
        ev: Dict[str, Any] = {
            "name": name,
            "t_s": (time.perf_counter() if t is None else t) - self._rec.t0,
        }
        if attrs:
            ev.update(attrs)
        evs.append(ev)
        return self

    def set_attr(self, key: str, value: Any) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    # -- lifecycle ---------------------------------------------------------
    def end(self, t: Optional[float] = None) -> None:
        if self.t1 is not None:
            return  # idempotent: `with` + explicit end must not double-finish
        self.t1 = time.perf_counter() if t is None else t
        if self._dropped:
            self.set_attr("events_dropped", self._dropped)
        if self.span_id == 0:
            self._rec.finish(self.t1)

    def __enter__(self) -> "Span":
        # thread-local activation: deep sites (closure advance, store
        # write internals) attach events via event_if_active without a
        # span parameter reaching them
        self._tls_prev = getattr(_tls, "span", None)
        _tls.span = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tls.span = self._tls_prev
        if exc is not None and (self.attrs is None or "error" not in self.attrs):
            self.set_attr("error", type(exc).__name__)
        self.end()
        return False

    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def as_dict(self, default_t1: Optional[float] = None) -> Dict[str, Any]:
        """Render for export.  Runs at dump/scrape time, NOT on the
        request path — rounding lives here.  ``default_t1`` stands in
        for a child that was never explicitly ended (the root's end
        time, so an unclosed child can't grow until export)."""
        t1 = self.t1
        if t1 is None:
            t1 = default_t1 if default_t1 is not None else time.perf_counter()
        d: Dict[str, Any] = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0_s": round(self.t0 - self._rec.t0, 9),
            "dur_s": round(t1 - self.t0, 9),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = [
                {**ev, "t_s": round(ev["t_s"], 9)} for ev in self.events
            ]
        return d


class _TraceRec:
    """Book-keeping for one in-flight sampled trace (root + registered
    descendants).  Spans of one request may be touched from the request
    thread only — the same single-writer discipline a Context has — so
    the only lock here is the tracer ring's.

    The trace id string renders lazily (``trace_id``): the eager
    sequence number is one atomic ``next()`` and the string only exists
    when something reads it (export).  The render is deterministic from (pid, seq,
    tracer salt), so concurrent readers agree without a lock."""

    __slots__ = ("tracer", "seq", "_tid", "name", "t0", "wall_t0", "spans",
                 "_next_id")

    def __init__(self, tracer: "Tracer", name: str) -> None:
        self.tracer = tracer
        self.seq = next(tracer._seq)
        self._tid: Optional[str] = None
        self.name = name
        self.t0 = time.perf_counter()
        self.wall_t0 = time.time()
        self.spans: List[Span] = []
        self._next_id = 0

    @property
    def trace_id(self) -> str:
        tid = self._tid
        if tid is None:
            tid = self._tid = _render_trace_id(self.tracer._salt, self.seq)
        return tid

    def finish(self, t1: float) -> None:
        self.tracer._record(self, t1)


def _render_trace_id(salt: int, seq: int) -> str:
    """pid-seq-mix: unique within a process lifetime via seq, unique
    across restarts via the tracer's per-construction random salt —
    deterministic given (salt, seq) so lazy rendering is race-free."""
    return f"{_PID_HEX}-{seq:08x}-{(seq * 0x9E3779B1 ^ salt) & 0xFFFFFFFF:08x}"


def render_finished(item) -> Dict[str, Any]:
    """One retained ring item → its export dict.  Items are either
    pre-rendered dicts (tail-kept root-only traces) or (rec, t1) live
    records."""
    if isinstance(item, dict):
        return item
    rec, t1 = item
    d: Dict[str, Any] = {
        "trace_id": rec.trace_id,
        "name": rec.name,
        "start_unix_s": round(rec.wall_t0, 6),
        "duration_s": round(t1 - rec.t0, 9),
        "spans": [sp.as_dict(default_t1=t1) for sp in rec.spans],
    }
    return d


class Tracer:
    """Head-sampling tracer with a bounded ring of finished traces.

    ``sample_rate`` in [0, 1] is the head decision; ``slow_threshold_s``
    is the tail rule (``maybe_keep_slow``); ``capacity`` bounds the
    ring.  Counters ride the shared metrics registry:
    ``trace.started`` / ``trace.kept`` / ``trace.tail_kept`` /
    ``trace.unsampled``."""

    def __init__(
        self,
        sample_rate: float = 1.0,
        slow_threshold_s: Optional[float] = 0.100,
        capacity: int = 512,
        registry: Optional[_metrics.Metrics] = None,
        seed: Optional[int] = None,
    ) -> None:
        import itertools

        self.sample_rate = float(sample_rate)
        self.slow_threshold_s = slow_threshold_s
        self._m = registry or _metrics.default
        self._rng = random.Random(seed)
        self._salt = self._rng.getrandbits(32)
        self._seq = itertools.count(1)  # GIL-atomic next(); no hot-path lock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(capacity), 1))

    # -- trace start -------------------------------------------------------
    def start_trace(self, name: str, **attrs) -> Span:
        if self.sample_rate <= 0.0 or (
            self.sample_rate < 1.0 and self._rng.random() >= self.sample_rate
        ):
            self._m.inc("trace.unsampled")
            return NOOP
        self._m.inc("trace.started")
        rec = _TraceRec(self, name)
        return Span(rec, name, parent_id=-1, t=rec.t0, attrs=attrs or None)

    # -- tail rule ---------------------------------------------------------
    def keep_slow(self, name: str, duration_s: float, **attrs) -> bool:
        """Record a root-only trace for an unsampled-but-slow request.
        Returns True when kept (duration ≥ slow_threshold_s)."""
        thr = self.slow_threshold_s
        if thr is None or duration_s < thr:
            return False
        self._m.inc("trace.tail_kept")
        attrs["tail_kept"] = True
        item = {
            "trace_id": _render_trace_id(self._salt, next(self._seq)),
            "name": name,
            "start_unix_s": round(time.time() - duration_s, 6),
            "duration_s": round(duration_s, 9),
            "tail_kept": True,
            "spans": [{
                "span_id": 0, "parent_id": -1, "name": name,
                "t0_s": 0.0, "dur_s": round(duration_s, 9),
                "attrs": attrs,
            }],
        }
        with self._lock:
            self._ring.append(item)
        return True

    # -- retention ---------------------------------------------------------
    def _record(self, rec: _TraceRec, t1: float) -> None:
        """Root ended: retain the live record.  Rendering (span dicts,
        rounding) is deferred to ``traces()`` — a finished trace's spans
        never mutate again, so export-time rendering reads frozen data,
        and the request path pays one deque append."""
        self._m.inc("trace.kept")
        with self._lock:
            self._ring.append((rec, t1))

    # -- export ------------------------------------------------------------
    def traces(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._ring)
        return [render_finished(it) for it in items]

    def dump_jsonl(self, path: Optional[str] = None) -> str:
        """One JSON object per line per finished trace (newest last).
        With ``path``, also writes the dump there."""
        out = "\n".join(json.dumps(t) for t in self.traces())
        if out:
            out += "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(out)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# ---------------------------------------------------------------------------
# Module-level surface (the hot-path entry points)
# ---------------------------------------------------------------------------


def configure(
    sample_rate: float = 1.0,
    slow_threshold_s: Optional[float] = 0.100,
    capacity: int = 512,
    registry: Optional[_metrics.Metrics] = None,
    seed: Optional[int] = None,
) -> Tracer:
    """Install (and return) the process-global tracer.  ``sample_rate``
    is the head decision; ``slow_threshold_s=None`` disables the tail
    rule."""
    global _TRACER
    _TRACER = Tracer(
        sample_rate=sample_rate, slow_threshold_s=slow_threshold_s,
        capacity=capacity, registry=registry, seed=seed,
    )
    return _TRACER


def disable() -> None:
    """Remove the global tracer: every entry point returns to the
    one-branch NOOP path."""
    global _TRACER
    _TRACER = None


def install(tracer: Optional[Tracer]) -> None:
    """Install an existing tracer (or ``None`` to disable) without
    constructing a new one — the overhead harness flips one tracer
    in and out per rep and must not allocate while doing so."""
    global _TRACER
    _TRACER = tracer


def get() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def spans_created() -> int:
    """Process-lifetime count of real Span allocations — the witness for
    the zero-cost-when-disabled contract."""
    return _SPANS_CREATED


def root_span(name: str, **attrs) -> Span:
    """Start a request trace, or return ``NOOP`` in one branch when no
    tracer is installed / the head sample says no."""
    tr = _TRACER
    if tr is None:
        return NOOP
    return tr.start_trace(name, **attrs)


def tail_clock() -> float:
    """perf_counter() when a tracer with a tail rule is active, else 0.0
    — callers on the NOOP path feed the result to ``maybe_keep_slow``
    without paying the clock read when tracing is off."""
    tr = _TRACER
    if tr is None or tr.slow_threshold_s is None:
        return 0.0
    return time.perf_counter()


def maybe_keep_slow(name: str, t0: float, **attrs) -> None:
    """Tail rule for NOOP-path requests: ``t0`` from ``tail_clock()``
    (0.0 ⇒ tracing was off at request start — nothing to do)."""
    if t0 == 0.0:
        return
    tr = _TRACER
    if tr is None or tr.slow_threshold_s is None:
        return
    tr.keep_slow(name, time.perf_counter() - t0, **attrs)


# -- Context propagation ----------------------------------------------------


def ctx_with_span(ctx, span):
    """The span rides the request Context — but the NOOP span rides for
    free: the SAME context comes back (no child-context dict)."""
    if span is NOOP:
        return ctx
    return ctx.with_value(SPAN_KEY, span)


def span_of(ctx) -> Any:
    """The context's span, or ``NOOP``.  One branch when tracing is
    disabled (the context chain is not even walked)."""
    if _TRACER is None:
        return NOOP
    sp = ctx.value(SPAN_KEY)
    return sp if sp is not None else NOOP


# -- thread-local current span (deep sites without a Context) ---------------


def current() -> Any:
    """The span most recently activated via ``with span:`` on this
    thread, or ``NOOP``."""
    if _TRACER is None:
        return NOOP
    sp = getattr(_tls, "span", None)
    return sp if sp is not None else NOOP


def event_if_active(name: str, **attrs) -> None:
    """Attach an event to the thread's active span, if any — the hook
    for sites that never see a Context (closure advance, store write
    internals).  One load + branch when tracing is disabled."""
    if _TRACER is None:
        return
    sp = getattr(_tls, "span", None)
    if sp is not None:
        sp.event(name, **attrs)



# -- incident hooks ----------------------------------------------------------

#: the installed flight recorder (None: none).  The recorder itself —
#: the ring of finished traces and the incident bundles — is not part of
#: the port yet; anomaly sites call the two hooks below regardless
_RECORDER: Optional[Any] = None


def trigger_incident(name: str, **info) -> Optional[str]:
    """Anomaly sites call this: one load + branch when no recorder is
    installed, else fire the named trigger.  Returns the incident id
    when one captures."""
    r = _RECORDER
    if r is None:
        return None
    return r.trigger(name, **info)


def note_anomaly(kind: str) -> None:
    """Windowed anomaly event (e.g. one shed): one load + branch when no
    recorder is installed, else feeds the recorder's spike detector."""
    r = _RECORDER
    if r is not None:
        r.note(kind)


# -- profiler correlation ----------------------------------------------------

class _NullCtx:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullCtx()


def annotate_dispatch(span) -> Any:
    """A context manager for a dispatch's device window: while a
    ``torch.profiler`` trace is recording, a ``record_function`` range named
    by the request's trace id (``gochugaru:<trace_id>``, or
    ``gochugaru:untraced`` for unsampled requests), so the harvested
    device trace carries request attribution (an NVTX range under
    ``torch.autograd.profiler.emit_nvtx``).  Otherwise a shared null
    context: no allocation."""
    import torch

    if not torch.autograd._profiler_enabled():
        return _NULL_CTX
    name = f"gochugaru:{span.trace_id}" if span is not NOOP else "gochugaru:untraced"
    return torch.profiler.record_function(name)
