"""Declarative SLOs evaluated as multi-window burn rates.

The serving stack publishes latency through timer rings and failure
modes through counters (utils/metrics.py), but nothing answered "is the
service inside its objectives RIGHT NOW, and how fast is it spending its
error budget" — the question an on-call (and the flight recorder's
trigger bus) actually asks.  This module is the standard SRE shape:

- an **SLO** declares either a latency objective over an existing timer
  ("p99 of ``serve.request_s`` ≤ 50 ms" ⇒ at most 1% of requests may
  exceed 50 ms) or an error/shed budget over counters ("sheds ≤ 5% of
  submissions");
- the **burn rate** of a window is (bad fraction over the window) ÷
  (budgeted bad fraction): burn 1.0 spends the budget exactly at the
  sustainable rate, burn 10 exhausts a day's budget in ~2.4 hours;
- **multi-window** evaluation (one short, one long window) is the
  standard de-noiser: the long window proves the burn is sustained, the
  short window proves it is still happening — an alert needs BOTH above
  threshold, so a brief spike (short only) or an old, recovered incident
  (long only) does not page.

Latency burn is computed from EXACT over-objective counts, not quantile
estimates: the engine arms ``Metrics.set_timer_threshold`` for each
latency SLO, so every ``observe()`` classifies its sample against the
objective at record time and the per-window "bad" count is a plain
counter delta (the timer sample ring has no timestamps, so windowed
quantiles over it would be guesses).

``SLOEngine`` samples the cumulative (bad, total) pairs on a background
cadence (``tick_s``), keeps a bounded history, publishes per-window
``slo.*`` gauges, serves ``report()`` to the telemetry ``/slo``
endpoint, and — on the False→True breach edge — fires an ``slo.burn``
incident through the flight recorder's trigger bus (utils/trace.py), so
a burning SLO freezes the last N request traces that caused it.

Copied from the reference package (host-only).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import metrics as _metrics
from . import trace as _trace

import time


@dataclass(frozen=True)
class SLO:
    """One declared objective.  Use the ``latency_slo``/``ratio_slo``
    constructors; the dataclass itself is the engine's internal shape.

    ``kind`` is "latency" (bad = timer observations over
    ``objective_s``; budget = 1 − quantile/100) or "ratio" (bad/total =
    counter sums; budget declared directly)."""

    name: str
    kind: str
    #: budgeted bad fraction (latency: 1 − quantile/100; ratio: given)
    budget: float
    #: latency kind: the metrics timer the objective binds to
    timer: str = ""
    #: latency kind: the objective in seconds
    objective_s: float = 0.0
    #: latency kind: the quantile the objective is stated at ([0,100])
    quantile: float = 99.0
    #: ratio kind: counter names summed into the bad numerator
    bad: Tuple[str, ...] = field(default_factory=tuple)
    #: ratio kind: counter names summed into the total denominator
    #: (bad counters NOT implicitly included — list them if they are
    #: not already part of the total)
    total: Tuple[str, ...] = field(default_factory=tuple)


def latency_slo(
    name: str, timer: str, objective_ms: float, quantile: float = 99.0
) -> SLO:
    """"p<quantile> of <timer> ≤ objective_ms" — at most
    (1 − quantile/100) of observations may exceed the objective."""
    if not 0.0 < quantile < 100.0:
        raise ValueError(f"quantile must be in (0, 100), got {quantile}")
    return SLO(
        name=name, kind="latency", budget=1.0 - quantile / 100.0,
        timer=timer, objective_s=objective_ms / 1000.0, quantile=quantile,
    )


def ratio_slo(
    name: str, bad: Sequence[str], total: Sequence[str], budget: float
) -> SLO:
    """"sum(bad) ≤ budget × sum(total)" over each window."""
    if not 0.0 < budget <= 1.0:
        raise ValueError(f"budget must be in (0, 1], got {budget}")
    return SLO(
        name=name, kind="ratio", budget=budget,
        bad=tuple(bad), total=tuple(total),
    )


def default_slos() -> Tuple[SLO, ...]:
    """The serving stack's stock objectives — deliberately generous (an
    SLO that pages on a CPU proxy's ordinary jitter teaches operators to
    ignore it); override per deployment via ``with_telemetry(slos=…)``.

    - per-surface latency: direct checks (``checks.dispatch``), the
      coalesced serving path (``serve.request_s``), and the pinned
      latency tier (``latency.dispatch_s`` — the north-star surface,
      held to a tighter objective);
    - shed budget: sheds across the admission gate and the serve queue
      vs. offered work;
    - transient-fault budget: retry-envelope activity vs. requested
      checks (a fault storm burns this one);
    - denial-rate budget: denied verdicts vs. all verdicts (the
      per-strategy ``check.verdicts.*`` counters, utils/decisions.py) —
      a sustained denial spike is the authorization-domain anomaly an
      operator wants paged on (bad schema push, revoked-edges sweep,
      token confusion), and the breach edge freezes the flight ring
      with the deciding traces AND the last-N decisions in the bundle.
      Generous on purpose: burn-threshold 2 × budget 0.25 ⇒ a sustained
      ≥50% denial fraction pages, ordinary deny-heavy traffic doesn't.
    """
    return (
        latency_slo("check.dispatch", "checks.dispatch", objective_ms=50.0),
        latency_slo("serve.request", "serve.request_s", objective_ms=50.0),
        latency_slo("latency.dispatch", "latency.dispatch_s",
                    objective_ms=20.0),
        ratio_slo(
            "shed",
            bad=("admission.sheds", "serve.sheds"),
            total=("checks.requested", "serve.submissions"),
            budget=0.05,
        ),
        ratio_slo(
            "transient_faults",
            bad=("retry.retries",),
            total=("checks.requested", "serve.submissions"),
            budget=0.01,
        ),
        ratio_slo(
            "denial_rate",
            bad=("check.verdicts.denied",),
            total=("check.verdicts.allowed", "check.verdicts.denied"),
            budget=0.25,
        ),
    )


class SLOEngine:
    """Multi-window burn-rate evaluator over the live metrics registry.

    ``windows`` (seconds, ascending) are evaluated per SLO per tick; an
    SLO is **breached** when EVERY window's burn ≥ ``burn_threshold``
    (the multi-window AND).  Gauges per tick:

    - ``slo.<name>.burn_<w>s`` — burn rate per window
    - ``slo.<name>.breached`` — 0/1
    - ``slo.breached`` — count of breached SLOs (0 ⇒ healthy)

    On the False→True breach edge the engine fires an ``slo.burn``
    incident through the flight-recorder trigger bus and bumps
    ``slo.breaches``.  ``tick()`` is callable directly (tests drive the
    clock); ``start=True`` runs it on a daemon thread every ``tick_s``.
    """

    def __init__(
        self,
        slos: Optional[Sequence[SLO]] = None,
        registry: Optional[_metrics.Metrics] = None,
        windows: Sequence[float] = (30.0, 300.0),
        burn_threshold: float = 2.0,
        tick_s: float = 1.0,
        clock=time.monotonic,
        start: bool = True,
    ) -> None:
        self.slos: Tuple[SLO, ...] = tuple(
            slos if slos is not None else default_slos()
        )
        self._m = registry or _metrics.default
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError("at least one window required")
        self.burn_threshold = float(burn_threshold)
        self.tick_s = float(tick_s)
        self._clock = clock
        self._lock = threading.Lock()
        # history per SLO: (t, bad_cum, total_cum), bounded to the
        # longest window (+ slack for jittered ticks)
        hist_len = int(self.windows[-1] / max(self.tick_s, 1e-3)) + 8
        self._hist: Dict[str, deque] = {
            s.name: deque(maxlen=hist_len) for s in self.slos
        }
        self._breached: Dict[str, bool] = {s.name: False for s in self.slos}
        self._last_report: Dict[str, Any] = {
            "healthy": True, "slos": [], "windows_s": list(self.windows),
            "burn_threshold": self.burn_threshold, "ticks": 0,
        }
        self._ticks = 0
        timer_objectives: Dict[str, float] = {}
        for s in self.slos:
            if s.kind == "latency":
                # the over-objective counter is PER TIMER: two latency
                # SLOs binding the same timer at different objectives
                # would silently share one threshold (last writer wins)
                # and compute at least one burn against the wrong
                # objective — reject the misconfiguration loudly
                prev = timer_objectives.get(s.timer)
                if prev is not None and prev != s.objective_s:
                    raise ValueError(
                        f"multiple latency SLOs bind timer {s.timer!r}"
                        f" at different objectives ({prev}s vs"
                        f" {s.objective_s}s) — one objective per timer"
                    )
                timer_objectives[s.timer] = s.objective_s
                # exact over-objective counting at observe() time — the
                # burn numerator is a counter delta, not a ring estimate
                self._m.set_timer_threshold(s.timer, s.objective_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # evaluate once up front: /slo must never serve an empty report
        # in the gap before the first background tick
        self.tick()
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="gochugaru-slo", daemon=True
            )
            self._thread.start()

    # -- sampling ----------------------------------------------------------
    def _cumulative(self, s: SLO) -> Tuple[float, float]:
        if s.kind == "latency":
            n, over = self._m.timer_counts(s.timer)
            return float(over), float(n)
        bad = sum(self._m.counter(c) for c in s.bad)
        total = sum(self._m.counter(c) for c in s.total)
        return bad, total

    @staticmethod
    def _window_delta(
        hist: deque, now: float, w: float
    ) -> Tuple[float, float, float]:
        """(bad_delta, total_delta, actual_window_s) between the newest
        sample and the oldest one inside the window (or the oldest held,
        while history is still shorter than the window)."""
        newest = hist[-1]
        base = hist[0]
        for item in hist:
            if now - item[0] <= w:
                base = item
                break
        return (
            newest[1] - base[1],
            newest[2] - base[2],
            max(newest[0] - base[0], 0.0),
        )

    # -- evaluation --------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate every SLO once; returns (and caches) the report the
        ``/slo`` endpoint serves."""
        now = self._clock() if now is None else now
        report_slos: List[Dict[str, Any]] = []
        breached_names: List[str] = []
        edges: List[Dict[str, Any]] = []
        with self._lock:
            self._ticks += 1
            for s in self.slos:
                bad, total = self._cumulative(s)
                hist = self._hist[s.name]
                hist.append((now, bad, total))
                row: Dict[str, Any] = {
                    "name": s.name,
                    "kind": s.kind,
                    "budget": s.budget,
                    "windows": {},
                }
                if s.kind == "latency":
                    row["timer"] = s.timer
                    row["objective_ms"] = round(s.objective_s * 1000.0, 3)
                    row["quantile"] = s.quantile
                else:
                    row["bad"] = list(s.bad)
                    row["total"] = list(s.total)
                breach = True
                for w in self.windows:
                    db, dt, actual = self._window_delta(hist, now, w)
                    frac = (db / dt) if dt > 0 else 0.0
                    burn = frac / s.budget
                    key = f"{format(w, 'g')}s"
                    # a window still WARMING (history shorter than the
                    # window) cannot confirm a breach: until the long
                    # window holds w seconds of history, every window
                    # computes the SAME delta off hist[0] and the
                    # multi-window AND de-noising is void — a cold-start
                    # compile blip would page instantly, the exact
                    # behavior the two-window rule exists to prevent
                    warmed = actual >= w - 1.5 * self.tick_s
                    row["windows"][key] = {
                        "burn": round(burn, 4),
                        "bad": db,
                        "total": dt,
                        "window_s": round(actual, 3),
                    }
                    if not warmed:
                        row["windows"][key]["warming"] = True
                        breach = False
                    self._m.set_gauge(f"slo.{s.name}.burn_{key}", burn)
                    if burn < self.burn_threshold:
                        breach = False
                # a window with zero traffic cannot burn; require traffic
                # in the short window for a breach (an idle process is
                # healthy, not silently failing its objectives)
                short = row["windows"][f"{format(self.windows[0], 'g')}s"]
                if short["total"] <= 0:
                    breach = False
                row["breached"] = breach
                self._m.set_gauge(f"slo.{s.name}.breached", float(breach))
                prev = self._breached[s.name]
                self._breached[s.name] = breach
                if breach:
                    breached_names.append(s.name)
                    if not prev:
                        self._m.inc("slo.breaches")
                        worst = max(
                            wv["burn"] for wv in row["windows"].values()
                        )
                        edges.append({
                            "slo": s.name, "burn": round(worst, 3),
                            "budget": s.budget,
                        })
                report_slos.append(row)
            self._m.set_gauge("slo.breached", float(len(breached_names)))
            report = {
                "healthy": not breached_names,
                "breached": breached_names,
                "slos": report_slos,
                "windows_s": list(self.windows),
                "burn_threshold": self.burn_threshold,
                "tick_s": self.tick_s,
                "ticks": self._ticks,
            }
            self._last_report = report
        # breach-edge incidents fire OUTSIDE the engine lock: the
        # capture-thread spawn must not serialize /slo and /healthz
        # readers on report() — the same hoist every other trigger site
        # (gate, breaker, batcher shed) applies
        for e in edges:
            _trace.trigger_incident("slo.burn", **e)
        return report

    def report(self) -> Dict[str, Any]:
        """The most recent tick's evaluation (the ``/slo`` payload)."""
        with self._lock:
            return self._last_report

    def breached(self) -> List[str]:
        with self._lock:
            return [n for n, b in self._breached.items() if b]

    # -- lifecycle ---------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # pragma: no cover - a tick must never kill
                self._m.inc("slo.tick_errors")  # the evaluator thread

    @property
    def closed(self) -> bool:
        """True once ``close()`` ran — endpoint holders (telemetry's
        ``/slo``, ``readiness_report``) check this so a client whose
        shared engine was later disabled reports "disabled" instead of
        serving the closed engine's frozen last report as live."""
        return self._stop.is_set()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        # a closed engine's verdict must not outlive it: a stale
        # slo.<name>.breached=1 on /metrics would page forever on a
        # breach that ended (a replacement engine republishes its own
        # set on its constructor tick)
        self._m.clear_gauges("slo.")


#: process-global engine (mirrors trace._TRACER / trace._RECORDER): the
#: gauges it writes and the timer thresholds it arms live on the shared
#: registry, so two engines evaluating independent histories would fight
#: over the same slo.* series and double-fire breach edges — one engine
#: per process, shared by every with_telemetry client
_ENGINE: Optional[SLOEngine] = None


def install_engine(engine: Optional[SLOEngine]) -> Optional[SLOEngine]:
    """Install (``None`` uninstalls) the process-global SLO engine; a
    previously installed engine is closed first — there must never be
    two evaluators racing over the same ``slo.*`` gauges.

    Replacement ordering is handled HERE, not by callers: in
    ``install_engine(SLOEngine(...))`` the new engine's constructor tick
    publishes gauges before the old engine's ``close()`` clears the
    ``slo.*`` prefix, so after closing the old one the new engine is
    re-ticked to republish — /metrics never loses the slo series for a
    tick window."""
    global _ENGINE
    prev = _ENGINE
    if prev is not None and prev is not engine:
        prev.close()
    _ENGINE = engine
    if engine is not None and prev is not None and prev is not engine:
        engine.tick()
    return engine


def get_engine() -> Optional[SLOEngine]:
    return _ENGINE


__all__ = [
    "SLO",
    "SLOEngine",
    "default_slos",
    "get_engine",
    "install_engine",
    "latency_slo",
    "ratio_slo",
]
