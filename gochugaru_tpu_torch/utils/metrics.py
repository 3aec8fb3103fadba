"""First-class counters and timers.

The reference has no observability at all (SURVEY.md §5); the north-star
metric here demands measurement, so the client and engine publish counters
(checks dispatched, batch occupancy, closure/BFS overflow fallbacks, device
dispatch time) through this registry.  ``torch.profiler`` remains the
deep tool; these are the cheap always-on numbers.

Timers keep a bounded ring of raw samples alongside the running
count/total, so tail latency is a first-class readout: ``percentile``
answers "what is my p99 right now" from the live process, and
``snapshot`` publishes ``.p50_s``/``.p90_s``/``.p99_s``/``.p999_s`` per
timer (one shared nearest-rank definition, one sorted pass).  The
telemetry exporter (utils/telemetry.py) renders the same registry as
Prometheus text, and utils/trace.py adds request-scoped spans on top —
counters stay the cheap always-on layer underneath.  The north-star
metric is a p99, and a mean cannot stand in for it — the latency-mode
dispatch path (engine/latency.py) publishes its per-stage budget through
these samples.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: the percentiles ``snapshot`` publishes per timer (one sorted pass)
SNAPSHOT_QUANTILES = (50.0, 90.0, 99.0, 99.9)


def nearest_rank(sorted_samples, q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence — the
    ONE definition ``percentile``, ``snapshot`` and the telemetry
    exporter (utils/telemetry.py) all share, so their p99s cannot
    disagree.  ``q`` in [0, 100]; no numpy dependency here."""
    n = len(sorted_samples)
    i = min(n - 1, max(0, int(round(q / 100.0 * (n - 1)))))
    return sorted_samples[i]


def quantile_suffix(q: float) -> str:
    """'p50_s'/'p90_s'/'p99_s'/'p999_s'-style key suffix for a [0,100]
    percentile (99.9 → 'p999_s')."""
    return "p" + format(q, "g").replace(".", "") + "_s"


class Metrics:
    #: per-timer sample-ring capacity: enough that a p99 is the ~20th
    #: worst sample (not the max of a handful), small enough that a
    #: long-lived serving process holds a few KB per timer
    SAMPLE_CAP = 2048

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._timings: Dict[str, list] = defaultdict(lambda: [0, 0.0])  # [n, total_s]
        self._samples: Dict[str, list] = defaultdict(list)  # ring of raw seconds
        #: explicit per-ring write cursor.  NOT derived from the timing
        #: count: an in-flight timer racing ``reset()`` recreates the
        #: ``_timings`` entry out of step with ``_samples`` (count says
        #: "overwrite slot n" while the ring is empty again) — the
        #: cursor lives and dies with its ring, so the two cannot skew
        self._scursor: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, float] = {}  # last-set values (breaker state)
        #: fixed-bucket histograms: name → [ascending bucket uppers,
        #: per-bucket counts (len+1, last = overflow), count, sum,
        #: per-bucket exemplars (len+1, last trace that landed in the
        #: bucket, or None)].  Buckets freeze at first observe — a
        #: histogram whose buckets drift mid-run cannot be merged or
        #: compared
        self._hists: Dict[str, list] = {}
        #: per-timer over-objective thresholds (utils/slo.py): observe()
        #: counts samples above the threshold into ``_over`` so an SLO
        #: burn rate is computed from EXACT per-window counts, not a
        #: quantile estimate over an unstamped ring
        self._thr: Dict[str, float] = {}
        self._over: Dict[str, int] = defaultdict(int)

    def inc(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += delta

    def set_gauge(self, name: str, value: float) -> None:
        """Last-write-wins instantaneous value (e.g. ``breaker.state``:
        0=closed, 1=half-open, 2=open; ``admission.inflight``)."""
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def clear_gauges(self, prefix: str) -> None:
        """Drop every gauge under ``prefix`` (per-snapshot breakdowns
        republished wholesale each prepare — stale keys would survive a
        table being dropped from the snapshot)."""
        with self._lock:
            for k in [k for k in self._gauges if k.startswith(prefix)]:
                del self._gauges[k]

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timings[name]
            t[0] += 1
            t[1] += seconds
            s = self._samples[name]
            if len(s) < self.SAMPLE_CAP:
                s.append(seconds)
            else:
                cur = self._scursor[name]
                s[cur] = seconds
                self._scursor[name] = (cur + 1) % self.SAMPLE_CAP
            thr = self._thr.get(name)
            if thr is not None and seconds > thr:
                self._over[name] += 1

    def set_timer_threshold(self, name: str, seconds: Optional[float]) -> None:
        """Arm (or with ``None`` disarm) over-objective counting for a
        timer: every ``observe(name, s)`` with ``s > seconds`` also bumps
        the timer's over-counter.  The SLO engine (utils/slo.py) reads
        (count, over) pairs per tick, so a latency burn rate is exact —
        "of the N requests observed this window, M blew the objective" —
        instead of estimated from the sample ring."""
        with self._lock:
            if seconds is None:
                self._thr.pop(name, None)
            else:
                self._thr[name] = float(seconds)

    def timer_counts(self, name: str) -> Tuple[int, int]:
        """(total observations, over-threshold observations) for a timer
        — both cumulative, both monotone, the SLO engine's raw feed."""
        with self._lock:
            return self._timings[name][0] if name in self._timings else 0, \
                self._over.get(name, 0)

    def observe_hist(
        self,
        name: str,
        value: float,
        buckets: Tuple[float, ...],
        trace_id: Optional[str] = None,
    ) -> None:
        """Count ``value`` into a fixed-bucket histogram (bucket uppers
        are inclusive, Prometheus ``le`` semantics; values past the last
        bucket land in the +Inf overflow slot).  The serving batcher's
        batch-occupancy distribution is the motivating consumer — a
        p99 summary can't show bimodality (half the batches full, half
        nearly empty averages to a lie), a histogram can.

        ``trace_id`` records an EXEMPLAR: the last trace that landed in
        the bucket, rendered by the telemetry exporter as an OpenMetrics
        exemplar — so a fat tail bucket links directly to a recorded
        trace instead of to a guess."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                bs = tuple(sorted(float(b) for b in buckets))
                h = self._hists[name] = [
                    bs, [0] * (len(bs) + 1), 0, 0.0, [None] * (len(bs) + 1)
                ]
            bs, counts = h[0], h[1]
            i = len(bs)
            for j, b in enumerate(bs):
                if value <= b:
                    i = j
                    break
            counts[i] += 1
            h[2] += 1
            h[3] += value
            if trace_id is not None:
                h[4][i] = (trace_id, float(value), time.time())

    def hist_snapshot(
        self,
    ) -> Dict[str, Tuple[Tuple[float, ...], List[int], int, float, list]]:
        """name → (bucket uppers, per-bucket counts incl. +Inf overflow,
        total count, sum, per-bucket exemplars) — the telemetry exporter
        renders these as Prometheus ``histogram`` series with cumulative
        ``le`` labels (exemplars attach in OpenMetrics mode).  Each
        exemplar is (trace_id, observed value, unix seconds) or None."""
        with self._lock:
            return {
                k: (h[0], list(h[1]), h[2], h[3], list(h[4]))
                for k, h in self._hists.items()
            }

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counters_prefixed(self, prefix: str) -> Dict[str, float]:
        """Every counter under ``prefix`` — the tagged-family accessor
        (per-strategy verdict counters ``check.verdicts.*``, decision
        drop counters ``decisions.*``) for endpoints and tests that want
        one family without a full snapshot."""
        with self._lock:
            return {
                k: v for k, v in self._counters.items()
                if k.startswith(prefix)
            }

    def percentile(self, name: str, q: float) -> Optional[float]:
        """The q-th percentile (seconds) over the timer's sample ring, or
        None when the timer has no samples.  Honest within the ring: at
        ≥ SAMPLE_CAP observations it is the p-of-the-last-SAMPLE_CAP, a
        sliding window — exactly what a serving SLO wants."""
        with self._lock:
            s = self._samples.get(name)
            if not s:
                return None
            s = list(s)  # sort outside the lock observe() contends on
        return nearest_rank(sorted(s), q)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            samples = {k: list(v) for k, v in self._samples.items() if v}
            for k, (n, total) in self._timings.items():
                out[f"{k}.count"] = n
                out[f"{k}.total_s"] = total
                if n:
                    out[f"{k}.mean_s"] = total / n
            for k, h in self._hists.items():
                cum = 0
                for b, c in zip(h[0], h[1]):
                    cum += c
                    out[f"{k}.le_{format(b, 'g')}"] = cum
                out[f"{k}.count"] = h[2]
                out[f"{k}.sum"] = h[3]
        for k, s in samples.items():
            # one sorted pass per timer, every published quantile off it;
            # sorting happens outside the lock the latency path's
            # observe() contends on, off a ring copy
            s = sorted(s)
            for q in SNAPSHOT_QUANTILES:
                out[f"{k}.{quantile_suffix(q)}"] = nearest_rank(s, q)
        return out

    def typed_snapshot(
        self,
    ) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, Tuple[int, float, List[float]]]]:
        """(counters, gauges, timers) with types preserved — the
        telemetry exporter needs to know a counter from a gauge from a
        timer to emit correct Prometheus TYPE lines.  Timers map to
        (count, total_s, ascending-sorted sample ring)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers = {
                k: (n, total, list(self._samples.get(k, ())))
                for k, (n, total) in self._timings.items()
            }
        # sort the ring copies AFTER releasing the lock: a /metrics
        # scrape sorting every 2048-sample ring must not stall the
        # latency path's observe() behind the registry lock
        return counters, gauges, {
            k: (n, total, sorted(s)) for k, (n, total, s) in timers.items()
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()
            self._samples.clear()
            self._scursor.clear()
            self._gauges.clear()
            self._hists.clear()
            # thresholds are CONFIG (armed by the SLO engine) and survive
            # a reset; the over-counters are data and do not
            self._over.clear()


#: Process-global default registry.
default = Metrics()


def peak_rss_mb() -> float:
    """Process peak resident set size in MiB: the max of
    ``getrusage(RUSAGE_SELF).ru_maxrss`` (KiB on Linux) and
    ``/proc/self/status`` VmHWM.  The host-sharded build's memory claim
    is a MEASURED per-process number (benchmarks emit it as a
    ``peak_rss_mb`` column; parallel/multihost.py's RSS dryrun compares
    it across process counts) — a high-water mark, so capture readings
    at phase boundaries and difference them."""
    import resource

    peak_kib = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    peak_kib = max(peak_kib, float(line.split()[1]))
                    break
    except OSError:
        pass
    return round(peak_kib / 1024.0, 1)
