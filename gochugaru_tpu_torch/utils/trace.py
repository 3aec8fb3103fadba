"""Request-scoped tracing: spans, head sampling with a keep-slow tail
rule, the flight recorder, and profiler-correlated dispatch.

Design constraints, in order (the same ordering utils/faults.py states):

1. **Zero cost when disabled.**  The span entry points sit on the
   latency dispatch path.  With no tracer installed, ``root_span``
   is one module-global load + branch returning the ``NOOP`` singleton;
   every method on ``NOOP`` is a no-op returning ``NOOP``; Context
   propagation (``ctx_with_span``) returns the SAME context — no dict
   churn, no allocation.  Tests assert the identity
   (``span is trace.NOOP``) and that ``spans_created()`` does not move.
2. **Head-based sampling, keep-slow tail rule.**  The keep/drop decision
   is made at trace START (``sample_rate``): unsampled requests run the
   NOOP path end-to-end.  The tail rule catches what head sampling
   misses: callers on the NOOP path report their measured duration via
   ``maybe_keep_slow``; a request slower than ``slow_threshold_s`` is
   recorded as a root-only trace flagged ``tail_kept``.  (A tail-kept
   trace has no child spans but carries the request attributes and
   duration; raise the sample rate to get full trees.)
3. **Bounded.**  Finished traces land in a ring (``capacity``); span
   events cap at ``MAX_EVENTS`` per span with a drop counter.

Spans form a tree: ``root_span`` starts a trace, ``span.child`` nests,
timestamps are ``time.perf_counter()`` so durations subtract exactly the
way the utils/metrics.py stage timers subtract — a stage span built from
the SAME t0/t1 the timer used agrees with the timer bit-for-bit.

Context propagation: the active span rides request Context values
(utils/context.py) across API layers, and a thread-local "current span"
(set by ``with span:``) lets deep sites that never see a Context — the
incremental closure advance, the store write path — attach events via
``event_if_active``.

Profiler correlation: ``annotate_dispatch(span)`` wraps a dispatch in a
``torch.profiler.record_function`` range named by the trace id while a
profiler session is active (``profiler_session``: the
``GOCHUGARU_TRACE_DIR`` marker) or ``torch.profiler`` is recording, so
the device trace carries request attribution.

Flight recorder: head sampling answers "why was THIS check slow" but not
"what was the system doing when the breaker tripped" — by the time an
anomaly fires, the interesting requests are the ones head sampling
already dropped.  ``FlightRecorder`` is a second, always-on bounded
ring: when a recorder is installed (``install_recorder``), every request
gets a REAL span tree even when the head sample says no (``flight_only``
traces — retained in the recorder's ring at full fidelity, never
exported to ``/traces`` unless they trip the slow-tail threshold).  A
**trigger bus** rides on top: anomaly sites — SLO burn (utils/slo.py), a
CircuitBreaker trip (utils/admission.py), a shed-rate spike
(``note_anomaly``), a pinned-path recapture (engine/latency.py), a watch
resume storm (client.py) — call ``trigger_incident(name)``, which
freezes the ring and dumps an **incident bundle** (the retained traces,
a full typed metrics snapshot, registered context providers like the
admission cost model) as JSONL under the incident dir, rate-limited per
trigger.  utils/telemetry.py serves the bundles at ``/debug/incidents``.
The disabled path is unchanged: no tracer installed ⇒ every entry point
is one load + branch, recorder or not.
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

#: the installed flight recorder (None ⇒ anomaly sites are one load +
#: branch; requests the head sample drops stay on the NOOP path)
_RECORDER: Optional["FlightRecorder"] = None

#: cached profiler-session dir (GOCHUGARU_TRACE_DIR), refreshed by
#: profiler_session()/refresh_profiler() — not re-read per dispatch
_PROFILER_DIR: Optional[str] = os.environ.get("GOCHUGARU_TRACE_DIR") or None

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
        # raw float here; rounding happens once at export (as_dict):
        # events sit on the request path
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
    when something reads it — export, or ``annotate_dispatch`` inside a
    profiler session.  The render is deterministic from (pid, seq,
    tracer salt), so concurrent readers agree without a lock."""

    __slots__ = ("tracer", "seq", "_tid", "name", "t0", "wall_t0", "spans",
                 "_next_id", "flight_only", "tail_kept")

    def __init__(self, tracer: "Tracer", name: str) -> None:
        self.tracer = tracer
        self.seq = next(tracer._seq)
        self._tid: Optional[str] = None
        self.name = name
        self.t0 = time.perf_counter()
        self.wall_t0 = time.time()
        self.spans: List[Span] = []
        self._next_id = 0
        #: True ⇒ the head sample said no and this trace exists only for
        #: the flight recorder's ring (never the /traces export ring,
        #: unless it trips the slow-tail threshold at finish)
        self.flight_only = False
        #: True ⇒ a flight-only trace that blew the slow threshold and
        #: exported anyway — rendered as ``tail_kept`` so /traces
        #: consumers filtering on the documented flag still see it
        self.tail_kept = False

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
    records; the SAME renderer serves the tracer's /traces ring and the
    flight recorder's incident bundles, so the two cannot disagree about
    what a trace looks like."""
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
    if rec.flight_only:
        d["flight_only"] = True
    if rec.tail_kept:
        d["tail_kept"] = True
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
            if _RECORDER is None:
                return NOOP
            # flight-recorder path: the head sample dropped this request
            # from the EXPORT ring, but the always-on recorder retains
            # the last N finished roots at full fidelity regardless —
            # so "what was happening when the breaker tripped" has an
            # answer even at a 0% sample rate
            rec = _TraceRec(self, name)
            rec.flight_only = True
            return Span(rec, name, parent_id=-1, t=rec.t0, attrs=attrs or None)
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
        r = _RECORDER
        if r is not None:
            r.record(item)
        return True

    # -- retention ---------------------------------------------------------
    def _record(self, rec: _TraceRec, t1: float) -> None:
        """Root ended: retain the live record.  Rendering (span dicts,
        rounding) is deferred to ``traces()`` — a finished trace's spans
        never mutate again, so export-time rendering reads frozen data,
        and the request path pays one deque append (two with a flight
        recorder installed).  Flight-only traces stay out of the export
        ring — unless they blow the slow-tail threshold, in which case
        the FULL tree exports (strictly better than the root-only
        tail-kept record the NOOP path produces)."""
        r = _RECORDER
        if rec.flight_only:
            self._m.inc("trace.flight_kept")
            thr = self.slow_threshold_s
            if thr is not None and t1 - rec.t0 >= thr:
                self._m.inc("trace.tail_kept")
                rec.tail_kept = True
                with self._lock:
                    self._ring.append((rec, t1))
        else:
            self._m.inc("trace.kept")
            with self._lock:
                self._ring.append((rec, t1))
        if r is not None:
            r.record((rec, t1))

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
# Flight recorder: always-on retention + anomaly-triggered incident dumps
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded always-on ring of the last N finished root traces, plus
    the anomaly trigger bus that freezes it into incident bundles.

    Retention is fed by the installed tracer (``Tracer._record`` routes
    every finished root here, including the flight-only trees built for
    requests the head sample dropped).  ``trigger(name)`` captures an
    incident: the ring is snapshotted SYNCHRONOUSLY at trigger time (the
    "freeze" — under load, post-anomaly traffic would otherwise evict
    the very traces the trigger fired about), then rendering, the
    metrics dump, and the file write run on a short-lived daemon thread
    so no anomaly site ever blocks a request on disk I/O.  After a short
    ``grace_s`` the capture ALSO appends roots that finished since the
    freeze — usually the failing request itself, whose root span was
    still open when the breaker tripped mid-dispatch.

    Per-trigger cooldown rate-limits dump storms; ``max_incidents``
    bounds the files kept on disk; the last few bundles are additionally
    kept in memory so ``/debug/incidents`` serves them without a
    configured directory.

    ``note(kind)`` is the spike detector: anomaly sites that are normal
    in ones (a shed) but an incident in bursts call it per event, and a
    burst of ``spike_threshold`` within ``spike_window_s`` fires a
    ``<kind>.spike`` trigger.

    ``add_context(name, fn)`` registers extra state providers dumped
    into every bundle (the client wires the admission cost model and
    gate/breaker state here)."""

    def __init__(
        self,
        incident_dir: Optional[str] = None,
        capacity: int = 64,
        cooldown_s: float = 30.0,
        grace_s: float = 0.25,
        max_incidents: int = 32,
        keep_bundles: int = 4,
        spike_threshold: int = 32,
        spike_window_s: float = 1.0,
        registry: Optional[_metrics.Metrics] = None,
        clock=time.monotonic,
    ) -> None:
        import itertools

        #: bundles dump here (created lazily); None ⇒ in-memory only.
        #: GOCHUGARU_INCIDENT_DIR is the zero-plumbing default, so a
        #: child process dumps without any wiring of its own
        self.incident_dir = (
            incident_dir
            if incident_dir is not None
            else (os.environ.get("GOCHUGARU_INCIDENT_DIR") or None)
        )
        self.capacity = max(int(capacity), 1)
        self.cooldown_s = cooldown_s
        self.grace_s = grace_s
        self.max_incidents = max(int(max_incidents), 1)
        self.keep_bundles = max(int(keep_bundles), 1)
        self.spike_threshold = max(int(spike_threshold), 1)
        self.spike_window_s = spike_window_s
        self._m = registry or _metrics.default
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._last_fire: Dict[str, float] = {}
        self._notes: Dict[str, deque] = {}
        self._seq = itertools.count(1)
        self._context: Dict[str, Any] = {}
        self._pending: List[threading.Thread] = []
        self._paths: List[str] = []
        #: incident metadata, oldest first (mutated in place by the
        #: capture thread once the bundle lands)
        self.incidents: List[Dict[str, Any]] = []
        self._bundles: Dict[str, str] = {}
        self._bundle_order: List[str] = []

    # -- retention (called by the tracer per finished root) --------------
    def record(self, item) -> None:
        with self._lock:
            self._ring.append(item)

    def traces(self) -> List[Dict[str, Any]]:
        """Render the current ring (newest last) — debugging surface and
        the test hook; bundles render from a trigger-time snapshot."""
        with self._lock:
            items = list(self._ring)
        return [render_finished(it) for it in items]

    def add_context(self, name: str, fn) -> None:
        """Register a zero-arg provider whose result is dumped into every
        incident bundle under ``context.<name>`` (exceptions are caught
        and recorded — a broken provider must not lose the bundle)."""
        with self._lock:
            self._context[name] = fn

    def add_context_group(self, providers: Dict[str, Any], cap: int = 8) -> bool:
        """Register a RELATED set of providers atomically under
        collision-free keys: the first group gets the bare names, later
        groups a ``#N`` suffix (keyed off the first name's existing
        registrations on THIS recorder).  Returns False once ``cap``
        groups are registered — providers are never unregistered, so an
        unbounded registrant pattern (a client per job) must not grow
        the context or pin its registrants' state forever."""
        if not providers:
            return False
        with self._lock:
            first = next(iter(providers))
            n = sum(
                1 for k in self._context
                if k == first or k.startswith(first + "#")
            )
            if n >= cap:
                return False
            suffix = "" if n == 0 else f"#{n + 1}"
            for name, fn in providers.items():
                self._context[f"{name}{suffix}"] = fn
        return True

    # -- spike detection --------------------------------------------------
    def note(self, kind: str) -> Optional[str]:
        """One anomaly event of ``kind`` (e.g. a shed).  Fires a
        ``<kind>.spike`` trigger when ``spike_threshold`` events land
        within ``spike_window_s`` — events are normal in ones and an
        incident in bursts."""
        now = self._clock()
        with self._lock:
            dq = self._notes.get(kind)
            if dq is None:
                dq = self._notes[kind] = deque()
            dq.append(now)
            while dq and now - dq[0] > self.spike_window_s:
                dq.popleft()
            n = len(dq)
            if n < self.spike_threshold:
                return None
            dq.clear()  # one spike per burst; cooldown guards refires
        return self.trigger(
            f"{kind}.spike", count=n, window_s=self.spike_window_s
        )

    # -- the trigger bus ---------------------------------------------------
    def trigger(self, name: str, **info) -> Optional[str]:
        """Fire one anomaly trigger: freeze the ring and capture an
        incident bundle (on a daemon thread).  Returns the incident id,
        or None when the per-trigger cooldown suppressed it."""
        now = self._clock()
        with self._lock:
            last = self._last_fire.get(name)
            if last is not None and now - last < self.cooldown_s:
                self._m.inc("incidents.suppressed")
                return None
            self._last_fire[name] = now
            seq = next(self._seq)
        self._m.inc("incidents.triggered")
        self._m.inc(f"incidents.triggered.{name}")
        iid = f"{int(time.time() * 1000):013d}-{seq:03d}-{name}"
        meta: Dict[str, Any] = {
            "id": iid,
            "trigger": name,
            "unix_s": round(time.time(), 6),
            "info": info,
            "state": "capturing",
        }
        # the FREEZE is synchronous: snapshot the ring NOW, at the
        # moment of the anomaly — under load, waiting even the short
        # capture grace would let post-anomaly traffic evict the very
        # traces the trigger fired about (the capture thread appends
        # roots that finish DURING the grace on top of this snapshot)
        with self._lock:
            frozen = list(self._ring)
        t = threading.Thread(
            target=self._capture, args=(meta, frozen),
            name="gochugaru-incident", daemon=True,
        )
        with self._lock:
            self.incidents.append(meta)
            del self.incidents[: -4 * self.max_incidents]
            # prune only threads that RAN and finished: a created-but-
            # not-yet-started thread (ident is None) reports not-alive
            # too, and dropping it here would let flush() return before
            # a concurrent trigger's capture ever starts
            self._pending = [
                x for x in self._pending
                if x.is_alive() or x.ident is None
            ]
            self._pending.append(t)
        t.start()
        return iid

    def flush(self, timeout: float = 10.0) -> None:
        """Wait for in-flight capture threads (tests and drain paths).
        Polls rather than bare-joining: a concurrent trigger may hold a
        created-but-not-yet-started thread (join would raise), and new
        captures may start while we wait."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                live = [
                    x for x in self._pending
                    if x.is_alive() or x.ident is None
                ]
            if not live:
                return
            for t in live:
                if t.ident is not None:
                    t.join(timeout=max(
                        0.0, min(0.25, deadline - time.monotonic())
                    ))
            time.sleep(0.002)

    # -- capture -----------------------------------------------------------
    def _capture(self, meta: Dict[str, Any], frozen: list) -> None:
        try:
            if self.grace_s > 0:
                # let roots in flight AT the trigger (usually the failing
                # request itself — a breaker trips mid-dispatch, before
                # its root span ends) finish into the ring
                time.sleep(self.grace_s)
            with self._lock:
                ring_now = list(self._ring)
                providers = list(self._context.items())
            # trigger-time snapshot PLUS roots that finished during the
            # grace — the frozen traces can never be displaced by
            # post-anomaly traffic, however hot the ring runs
            seen = {id(it) for it in frozen}
            items = frozen + [it for it in ring_now if id(it) not in seen]
            traces = [render_finished(it) for it in items]
            counters, gauges, timers = self._m.typed_snapshot()
            hists = self._m.hist_snapshot()
            context: Dict[str, Any] = {}
            for k, fn in providers:
                try:
                    context[k] = fn()
                except Exception as e:  # a broken provider loses itself only
                    context[k] = {"provider_error": type(e).__name__}
            # decision provenance: every bundle carries the last-N
            # authorization DECISIONS (utils/decisions.py) — "what was
            # being decided when the breaker tripped / the denial-rate
            # SLO burned" ships inside the bundle, not in a separate
            # store an operator has to correlate by timestamp
            decisions = None
            try:
                from . import decisions as _decisions

                dlog = _decisions.get()
                if dlog is not None:
                    decisions = dlog.tail(32)
            except Exception:  # provenance must never lose the bundle
                decisions = None
            head = {
                "kind": "incident",
                "id": meta["id"],
                "trigger": meta["trigger"],
                "unix_s": meta["unix_s"],
                "info": meta["info"],
                "trace_ids": [t.get("trace_id") for t in traces],
                # the headline process state an operator reads first —
                # all re-dumped in full inside the metrics line below
                "breaker_state": gauges.get("breaker.state"),
                "admission_inflight": gauges.get("admission.inflight"),
                "serve_queue_depth": gauges.get("serve.queue_depth"),
                "device_bytes": gauges.get("snapshot.device_bytes"),
                "context": context,
            }
            if decisions is not None:
                head["decisions"] = decisions
            # default=repr: a provider returning a numpy scalar (or a
            # span attr holding one) must degrade to its repr, not lose
            # the whole bundle to a TypeError mid-capture
            lines = [json.dumps(head, default=repr)]
            for tr in traces:
                lines.append(json.dumps({"kind": "trace", **tr},
                                        default=repr))
            # timers dump as count/total + the shared quantiles, not raw
            # rings — a bundle is a diagnosis artifact, not a data lake
            tdump = {}
            for k, (n, total, samples) in timers.items():
                row = {"count": n, "total_s": round(total, 9)}
                if samples:
                    for q in _metrics.SNAPSHOT_QUANTILES:
                        row[_metrics.quantile_suffix(q)] = round(
                            _metrics.nearest_rank(samples, q), 9
                        )
                tdump[k] = row
            lines.append(json.dumps({
                "kind": "metrics",
                "counters": counters,
                "gauges": gauges,
                "timers": tdump,
            }, default=repr))
            if hists:
                lines.append(json.dumps({
                    "kind": "hists",
                    "hists": {
                        k: {
                            "buckets": list(bs), "counts": counts,
                            "count": n, "sum": round(total, 9),
                            "exemplars": ex,
                        }
                        for k, (bs, counts, n, total, ex) in hists.items()
                    },
                }, default=repr))
            bundle = "\n".join(lines) + "\n"
            path = None
            if self.incident_dir:
                try:
                    os.makedirs(self.incident_dir, exist_ok=True)
                    path = os.path.join(
                        self.incident_dir, f"incident_{meta['id']}.jsonl"
                    )
                    with open(path, "w") as f:
                        f.write(bundle)
                except OSError as e:
                    meta["write_error"] = type(e).__name__
                    path = None
            evict: List[str] = []
            with self._lock:
                meta.update(
                    state="captured", path=path, traces=len(traces),
                    trace_ids=head["trace_ids"],
                )
                self._bundles[meta["id"]] = bundle
                self._bundle_order.append(meta["id"])
                while len(self._bundle_order) > self.keep_bundles:
                    self._bundles.pop(self._bundle_order.pop(0), None)
                if path is not None:
                    self._paths.append(path)
                    while len(self._paths) > self.max_incidents:
                        evict.append(self._paths.pop(0))
            # unlink OUTSIDE the lock: record() contends on it from
            # every finished root span, and a slow filesystem must not
            # stall request threads in span end() behind an os.remove
            for old in evict:
                try:
                    os.remove(old)
                except OSError:
                    pass
            self._m.inc("incidents.captured")
        except Exception as e:  # pragma: no cover - capture must not raise
            meta["state"] = f"failed:{type(e).__name__}"
            self._m.inc("incidents.capture_errors")

    # -- read side (telemetry /debug/incidents) ---------------------------
    def incident_index(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(m) for m in self.incidents]

    def bundle(self, iid: str) -> Optional[str]:
        """The JSONL bundle for an incident id: in-memory when still
        retained, else re-read from its file."""
        with self._lock:
            b = self._bundles.get(iid)
            path = next(
                (m.get("path") for m in self.incidents if m["id"] == iid),
                None,
            )
        if b is not None:
            return b
        if path:
            try:
                with open(path) as f:
                    return f.read()
            except OSError:
                return None
        return None


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
    """Remove the global tracer AND the flight recorder: every entry
    point returns to the one-branch NOOP path (a recorder without a
    tracer would retain nothing anyway — flight-only spans are built by
    the tracer)."""
    global _TRACER, _RECORDER
    _TRACER = None
    _RECORDER = None


def install_recorder(rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install (``None`` uninstalls) the process-global flight recorder.
    Requires an installed tracer to retain traces — ``with_telemetry``
    (client.py) installs a 0%-head-sample tracer when none exists, so
    flight recording costs span bookkeeping but exports nothing to
    ``/traces`` except slow-tail trees."""
    global _RECORDER
    _RECORDER = rec
    return rec


def recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def trigger_incident(name: str, **info) -> Optional[str]:
    """Anomaly sites call this: one load + branch when no recorder is
    installed, else fire the named trigger (rate-limited per name by the
    recorder's cooldown).  Returns the incident id when one captures."""
    r = _RECORDER
    if r is None:
        return None
    return r.trigger(name, **info)


def note_anomaly(kind: str) -> None:
    """Windowed anomaly event (e.g. one shed): one load + branch when no
    recorder is installed, else feeds the recorder's spike detector —
    a burst fires a ``<kind>.spike`` incident."""
    r = _RECORDER
    if r is not None:
        r.note(kind)


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


# -- profiler correlation ---------------------------------------------------


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


def refresh_profiler() -> Optional[str]:
    """Re-read GOCHUGARU_TRACE_DIR (the profiler-session marker) into
    the cached module flag; returns the active dir or None."""
    global _PROFILER_DIR
    _PROFILER_DIR = os.environ.get("GOCHUGARU_TRACE_DIR") or None
    return _PROFILER_DIR


def profiler_active() -> bool:
    return _PROFILER_DIR is not None


def annotate_dispatch(span) -> Any:
    """A context manager for a dispatch's device window: while a profiler
    session is active (``GOCHUGARU_TRACE_DIR``) or ``torch.profiler`` is
    recording, a ``record_function`` range named by the request's trace
    id (``gochugaru:<trace_id>``, or ``gochugaru:untraced`` for
    unsampled requests), so the device trace carries request
    attribution.  Otherwise a shared null context: no allocation."""
    import torch

    if _PROFILER_DIR is None and not torch.autograd._profiler_enabled():
        return _NULL_CTX
    name = f"gochugaru:{span.trace_id}" if span is not NOOP else "gochugaru:untraced"
    return torch.profiler.record_function(name)


class profiler_session:
    """Marks a profiler session active for this process (sets
    GOCHUGARU_TRACE_DIR and the cached flag) for the duration: a harness
    wraps its ``torch.profiler.profile`` window in this so every
    dispatch inside is request-annotated."""

    def __init__(self, trace_dir: str) -> None:
        self.trace_dir = trace_dir
        self._prev: Optional[str] = None

    def __enter__(self) -> "profiler_session":
        global _PROFILER_DIR
        self._prev = os.environ.get("GOCHUGARU_TRACE_DIR")
        os.environ["GOCHUGARU_TRACE_DIR"] = self.trace_dir
        _PROFILER_DIR = self.trace_dir
        return self

    def __exit__(self, *exc) -> bool:
        global _PROFILER_DIR
        if self._prev is None:
            os.environ.pop("GOCHUGARU_TRACE_DIR", None)
        else:
            os.environ["GOCHUGARU_TRACE_DIR"] = self._prev
        _PROFILER_DIR = self._prev
        return False
