"""Admission control for the dispatch path: bounded in-flight gate,
deadline-budget shedding, and a circuit breaker for the latency path.

The north star is a serving system, and a serving system's failure mode
under overload must be *load shedding*, not queue growth: a dispatch
gate that refuses work with ``ShedError`` (an ``UnavailableError``
subclass) converts overload into client-side exponential backoff through
the existing retry envelope — the same contract a gRPC server states by
returning ``codes.Unavailable``.  Samyama's unified in-database design
(PAPERS.md) leans on exactly this to keep hardware-accelerated paths
honest under overload; Graphulo benchmarks the degraded mode explicitly.

Copied from the reference package (host-only).  The serving batcher and
the fleet replica it mentions are not part of the port yet.

Three mechanisms, composed by the client (client.py ``check``):

- **DispatchGate** — a bounded in-flight counter.  ``admit()`` raises
  ``ShedError`` when ``max_inflight`` dispatches are already in the
  engine; no queueing, no blocking.  Counter: ``admission.sheds``.
- **Deadline budget** — ``check_deadline`` sheds a dispatch whose
  context deadline cannot cover the expected dispatch cost (client-local
  EWMA of recent dispatch times, floored by ``deadline_floor_s``): a
  check that would blow its deadline is rejected before H2D, not after
  the kernel has burned the budget.  Counter:
  ``admission.deadline_sheds``.
- **CircuitBreaker** — trips OPEN after ``breaker_threshold``
  *consecutive* transient dispatch failures; while open, latency-mode
  traffic routes back to the batch path (the latency path's pinned
  kernels and staging buffers are the most state-coupled dispatch
  surface, so it is first to lose trust).  After ``breaker_cooldown_s``
  the breaker HALF-OPENs and admits probes; one success closes it, one
  failure re-trips.  Counters: ``breaker.trips``, ``breaker.half_opens``,
  ``breaker.closes``; gauge ``breaker.state`` (0/1/2 =
  closed/half-open/open).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

from . import metrics as _metrics
from . import trace as _trace
from .context import Context
from .errors import DeadlineExceededError, ShedError

#: breaker states (also the ``breaker.state`` gauge values)
CLOSED, HALF_OPEN, OPEN = 0, 1, 2

#: EWMA weight of the newest dispatch-cost sample
_EWMA_ALPHA = 0.2


class CostModel:
    """The ONE expected-dispatch-cost estimate the deadline shed and the
    serving batcher's hold-back share (serve/batcher.py).

    The original scalar EWMA was tuned for caller-formed batches: one
    number regardless of batch size.  A micro-batch former needs "what
    will a tier-1024 dispatch cost" to decide whether holding a request
    another 500 µs blows its deadline — so the model keeps one EWMA per
    ladder tier (keyed by the tier's integer size, so tuned non-pow2
    ladders work unchanged; seeded from the scalar estimate until the
    tier has its own samples) on top of the overall scalar, and both
    consumers read the SAME object: there is no second EWMA to drift.

    ``decay()`` halves every estimate — the deadline shed's cold-start
    escape hatch (see ``AdmissionController.check_deadline``)."""

    def __init__(self, floor_s: float = 0.0) -> None:
        self.floor_s = floor_s
        self._lock = threading.Lock()
        self._overall: Optional[float] = None
        self._by_tier: dict = {}

    def observe(self, seconds: float, tier: Optional[int] = None) -> None:
        """Tier-less samples (caller-formed dispatches) feed the overall
        scalar; tier-tagged samples (the batcher's coalesced dispatches)
        feed ONLY their tier — a 4096-tier batch costing 10x a small
        dispatch must not inflate the estimate the tier-less deadline
        shed reads, or small deadline-bearing requests shed spuriously
        whenever serving traffic runs hot."""
        with self._lock:
            if tier is None:
                if self._overall is None:
                    self._overall = seconds
                else:
                    self._overall += _EWMA_ALPHA * (seconds - self._overall)
            else:
                cur = self._by_tier.get(tier)
                if cur is None:
                    self._by_tier[tier] = seconds
                else:
                    self._by_tier[tier] = cur + _EWMA_ALPHA * (seconds - cur)

    def expected_s(self, tier: Optional[int] = None) -> float:
        """Expected dispatch seconds — the tier's own EWMA when it has
        samples, else the overall estimate, else (tier-less with only
        tiered samples) the CHEAPEST tier's estimate: a request not yet
        assigned a tier could land on the cheapest one, so shedding
        against anything costlier would over-shed.  Floored by
        ``floor_s``."""
        with self._lock:
            est = None
            if tier is not None:
                est = self._by_tier.get(tier)
            if est is None:
                est = self._overall
            if est is None and self._by_tier:
                est = min(self._by_tier.values())
        return max(self.floor_s, est or 0.0)

    def has_samples(self) -> bool:
        with self._lock:
            return self._overall is not None or bool(self._by_tier)

    def state(self) -> dict:
        """Introspection snapshot — dumped into flight-recorder incident
        bundles (utils/trace.py) so "what did the system THINK a dispatch
        cost when it tripped" is part of the diagnosis record."""
        with self._lock:
            return {
                "floor_s": self.floor_s,
                "overall_s": self._overall,
                "by_tier_s": dict(sorted(self._by_tier.items())),
            }

    def decay(self) -> None:
        """Halve the estimate the TIER-LESS readout is built from —
        learning happens on admitted dispatches only, so a one-off
        cold-start outlier must not lock deadline-bearing traffic out
        forever.  Only the channel the shed actually read decays: the
        overall scalar when it has samples, else the cheapest tier (the
        min-fallback ``expected_s(None)`` returns).  Accurate per-tier
        estimates the serving hold-back relies on are NOT collateral —
        repeated caller-formed sheds must not teach the batcher that a
        4096-tier dispatch is free."""
        with self._lock:
            if self._overall is not None:
                self._overall /= 2.0
            elif self._by_tier:
                k = min(self._by_tier, key=self._by_tier.get)
                self._by_tier[k] /= 2.0


@dataclass(frozen=True)
class AdmissionConfig:
    """Tuning for the client's admission controller."""

    #: concurrent dispatches admitted before shedding (0 disables the gate)
    max_inflight: int = 64
    #: consecutive transient dispatch failures that trip the breaker
    #: (0 disables the breaker)
    breaker_threshold: int = 5
    #: seconds OPEN before the breaker half-opens a probe
    breaker_cooldown_s: float = 0.25
    #: floor on the expected-dispatch-cost estimate used for deadline
    #: shedding; 0.0 means "shed only on observed history" (a fresh
    #: client never deadline-sheds until it has its own samples)
    deadline_floor_s: float = 0.0
    #: False disables deadline-budget shedding entirely (requests whose
    #: deadline already passed still fail in the retry envelope itself)
    deadline_shed: bool = True


class DispatchGate:
    """Bounded in-flight dispatch counter.  Shed-don't-queue: a full gate
    raises immediately so the caller's retry envelope backs off instead
    of this layer buffering unboundedly."""

    def __init__(
        self, max_inflight: int, registry: Optional[_metrics.Metrics] = None
    ) -> None:
        self.max_inflight = max_inflight
        self._m = registry or _metrics.default
        self._lock = threading.Lock()
        self._inflight = 0

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @contextmanager
    def admit(self, span=_trace.NOOP):
        if self.max_inflight > 0:
            shed_at = None
            with self._lock:
                if self._inflight >= self.max_inflight:
                    self._m.inc("admission.sheds")
                    shed_at = self._inflight
                else:
                    self._inflight += 1
                    inflight = self._inflight
                    self._m.set_gauge("admission.inflight", inflight)
            if shed_at is not None:
                # everything below runs OUTSIDE the gate lock: a shed
                # burst crossing the spike threshold spawns an incident
                # capture thread, and that spawn must not serialize the
                # admits/releases the gate exists to keep moving (the
                # same hoist the breaker's trip trigger does)
                span.event(
                    "admission.shed", error="ShedError", inflight=shed_at
                )
                span.set_attr("shed_error", "ShedError")
                # one shed is overload working as designed; a BURST of
                # sheds is an incident — the flight recorder's spike
                # detector decides which this is
                _trace.note_anomaly("shed")
                raise ShedError(
                    f"dispatch admission: {shed_at} in-flight"
                    f" >= max_inflight {self.max_inflight}"
                )
            span.event("admission.admit", inflight=inflight)
        else:
            span.event("admission.admit", inflight=-1)
        try:
            yield
        finally:
            if self.max_inflight > 0:
                with self._lock:
                    self._inflight -= 1
                    self._m.set_gauge("admission.inflight", self._inflight)


class CircuitBreaker:
    """Consecutive-transient-failure breaker gating the latency path.

    ``allow_latency()`` answers "may this dispatch use the latency-mode
    path right now"; ``record_success``/``record_failure`` feed it from
    dispatch outcomes.  ``clock`` is injectable so tests drive the
    cooldown deterministically."""

    def __init__(
        self,
        threshold: int,
        cooldown_s: float,
        registry: Optional[_metrics.Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._m = registry or _metrics.default
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._m.set_gauge("breaker.state", CLOSED)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow_latency(self) -> bool:
        if self.threshold <= 0:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = HALF_OPEN
                    self._m.inc("breaker.half_opens")
                    self._m.set_gauge("breaker.state", HALF_OPEN)
                    return True  # this dispatch is the probe
                return False
            return True  # HALF_OPEN: probes flow until an outcome lands

    def record_success(self, probe: bool = False) -> None:
        """Feed one successful dispatch.  ``probe`` says the dispatch
        actually ran on the latency path: only a successful latency
        *probe* may close an open breaker — a batch-path success says
        nothing about the latency path's health, so while OPEN the
        breaker keeps rerouting until the half-open probe succeeds."""
        if self.threshold <= 0:
            return
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN and probe:
                self._state = CLOSED
                self._m.inc("breaker.closes")
                self._m.set_gauge("breaker.state", CLOSED)

    def record_failure(self) -> None:
        """Feed one *transient* dispatch failure (callers classify first:
        permanent errors say nothing about path health)."""
        if self.threshold <= 0:
            return
        tripped = False
        with self._lock:
            self._consecutive_failures += 1
            consecutive = self._consecutive_failures
            if self._state == HALF_OPEN:
                # failed probe: straight back to OPEN, fresh cooldown
                self._state = OPEN
                self._opened_at = self._clock()
                self._m.inc("breaker.trips")
                self._m.set_gauge("breaker.state", OPEN)
                tripped = True
            elif (
                self._state == CLOSED
                and self._consecutive_failures >= self.threshold
            ):
                self._state = OPEN
                self._opened_at = self._clock()
                self._m.inc("breaker.trips")
                self._m.set_gauge("breaker.state", OPEN)
                tripped = True
        if tripped:
            # flight-recorder trigger OUTSIDE the lock (the capture
            # thread spawn must not serialize other dispatch outcomes):
            # a breaker trip freezes the last N request traces — the
            # consecutive failures that tripped it are in the ring
            _trace.trigger_incident(
                "breaker.trip", consecutive=consecutive,
                threshold=self.threshold,
            )


class AdmissionController:
    """The client-facing bundle: gate + breaker + deadline budget."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        registry: Optional[_metrics.Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config or AdmissionConfig()
        self._m = registry or _metrics.default
        self._clock = clock
        self.gate = DispatchGate(self.config.max_inflight, registry=self._m)
        self.breaker = CircuitBreaker(
            self.config.breaker_threshold,
            self.config.breaker_cooldown_s,
            registry=self._m,
            clock=clock,
        )
        #: the shared dispatch-cost model (per-tier EWMA + overall);
        #: client-local — None samples until the first dispatch so a
        #: fresh client never sheds on other clients' history.  The
        #: serving batcher (serve/batcher.py) reads and feeds the SAME
        #: object for its hold-back decisions — one cost model, two
        #: consumers, no duplicated EWMA
        self.cost = CostModel(self.config.deadline_floor_s)

    def report(self) -> dict:
        """Backpressure snapshot: what a fleet replica publishes in its
        health payload (fleet/replica.py) so the router can see each
        member's admission state alongside its freshness."""
        return {
            "inflight": self.gate.inflight,
            "max_inflight": self.config.max_inflight,
            "breaker": self.breaker.state,
        }

    # -- deadline budget -------------------------------------------------
    def expected_cost_s(self, tier: Optional[int] = None) -> float:
        return self.cost.expected_s(tier)

    def observe_cost(self, seconds: float, tier: Optional[int] = None) -> None:
        self.cost.observe(seconds, tier)

    def check_deadline(self, ctx: Context, span=_trace.NOOP) -> None:
        """Shed a dispatch whose deadline cannot cover the expected cost
        — before any device work (pre-H2D), not after the kernel has
        spent the budget.  Raises ``DeadlineExceededError`` (classified,
        retriable; the retry envelope converts it into a bounded wait
        that expires exactly at the context deadline).

        Every shed HALVES the estimate: the EWMA learns from admitted
        dispatches only, and a one-off cold-start outlier (snapshot
        materialization, first-compile) must not lock deadline-bearing
        traffic out forever — after a few decaying sheds the estimate
        drops under real deadlines and requests flow again, re-teaching
        the EWMA from warm samples."""
        if not self.config.deadline_shed:
            return
        dl = ctx.deadline()
        if dl is None:
            return
        remaining = dl - self._clock()
        est = self.expected_cost_s()
        if remaining <= 0 or (est > 0.0 and remaining < est):
            if remaining > 0:
                # the ESTIMATE caused this shed: decay it
                self.cost.decay()
            self._m.inc("admission.deadline_sheds")
            _trace.note_anomaly("shed")
            span.event(
                "admission.deadline_shed",
                remaining_s=round(max(remaining, 0.0), 6),
                expected_s=round(est, 6),
            )
            raise DeadlineExceededError(
                f"deadline budget: {max(remaining, 0.0) * 1000:.1f} ms remain,"
                f" dispatch expected to take {est * 1000:.1f} ms"
            )
