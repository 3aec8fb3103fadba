"""Structured decision log: the authorization-domain audit surface.

The observability stack answers "why was this check *slow*" (spans,
flight recorder, perf ledgers) but kept no record of what was *decided*:
who asked, for what, what the verdict was, at which revision, under
which consistency strategy.  This module is that record — the per-tenant
audit surface the multi-tenant roadmap item names, and the first thing
an operator greps during an authorization incident.

Design follows the trace.py ordering of constraints:

1. **Zero cost when disarmed.**  No log installed ⇒ every ``record_*``
   entry point is one module-global load + branch.  The per-strategy
   VERDICT COUNTERS (``check.verdicts.{allowed,denied}`` plus
   ``.<strategy>`` and ``.cache_hit`` tags) are separate and always on —
   two to six counter bumps per *batch*, so denial-rate spikes are
   alertable (the stock ``denial_rate`` SLO in utils/slo.default_slos)
   even with no log armed.
2. **Sampled always-on ring, always-keep-denied.**  The head sample
   decides per decision; DENIED verdicts are kept regardless (the
   slow-tail analogue: "why was this user denied" must always have an
   answer), bounded per batch by ``denied_keep_max`` so a bulk denial
   sweep cannot flood the ring.
3. **Bounded everywhere.**  The ring is a deque; the optional JSONL sink
   rotates at ``rotate_bytes`` keeping ``rotate_keep`` files; entries a
   failed sink write loses are COUNTED (``decisions.dropped``), never
   silently gone — the bench_compare direction registry watches that
   counter.

Each entry records: client id, resource, permission, subject, verdict,
revision, consistency strategy, cache_hit / dedup_parked provenance,
latency, and the dispatch trace id (joining the decision to its span
tree and, through histogram exemplars, to /metrics).

Surfaces: ``/decisions`` (utils/telemetry.py) serves the ring as JSONL
with a counter summary head; incident bundles (utils/trace.py) carry the
last-N decisions so "what was being decided when the breaker tripped"
ships inside the bundle; vcache-served verdicts log ``cache_hit: true``
with the pinned revision — ``client.explain`` re-derives their trees
against that revision (engine/explain.py).

Copied from the reference package (host-only).
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

__all__ = [
    "DecisionLog",
    "count_verdicts",
    "enabled",
    "get",
    "install",
    "record_cols",
    "record_rels",
    "strategy_name",
]

#: module-level fast path: None ⇒ record_* is one load + branch
_LOG: Optional["DecisionLog"] = None


def strategy_name(cs) -> str:
    """Short tag of a consistency Strategy (or None → "direct")."""
    if cs is None:
        return "direct"
    req = getattr(cs, "requirement", None)
    v = getattr(req, "value", None)
    return {
        "fully_consistent": "full",
        "minimize_latency": "min_latency",
        "at_least_as_fresh": "at_least",
        "at_exact_snapshot": "snapshot",
    }.get(v, v or "direct")


def count_verdicts(
    m: _metrics.Metrics,
    allowed: int,
    denied: int,
    strategy: str,
    cache_hits: int = 0,
) -> None:
    """Always-on verdict counters: plain totals (the denial-rate SLO's
    feed), per-strategy tags, and the cache-hit tag.  A handful of
    counter bumps per BATCH — never per check."""
    if allowed:
        m.inc("check.verdicts.allowed", allowed)
        m.inc(f"check.verdicts.allowed.{strategy}", allowed)
    if denied:
        m.inc("check.verdicts.denied", denied)
        m.inc(f"check.verdicts.denied.{strategy}", denied)
    if cache_hits:
        m.inc("check.verdicts.cache_hit", cache_hits)


class DecisionLog:
    """Bounded decision ring + optional rotating JSONL sink.

    ``sample_rate`` is the head decision per ALLOWED decision; denied
    decisions always record (up to ``denied_keep_max`` per batch).  The
    sink is written synchronously under the lock in small batches —
    decision volume is sampling-bounded, and a lost write counts into
    ``decisions.dropped`` instead of raising into a serving path."""

    def __init__(
        self,
        capacity: int = 2048,
        *,
        sample_rate: float = 1.0,
        sink_path: Optional[str] = None,
        rotate_bytes: int = 4 << 20,
        rotate_keep: int = 4,
        denied_keep_max: int = 64,
        registry: Optional[_metrics.Metrics] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.capacity = max(int(capacity), 1)
        self.sample_rate = float(sample_rate)
        self.sink_path = sink_path
        self.rotate_bytes = int(rotate_bytes)
        self.rotate_keep = max(int(rotate_keep), 1)
        self.denied_keep_max = max(int(denied_keep_max), 1)
        self._m = registry or _metrics.default
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._sink = None
        self._sink_bytes = 0

    # -- recording -------------------------------------------------------
    def sampled(self) -> bool:
        r = self.sample_rate
        return r >= 1.0 or (r > 0.0 and self._rng.random() < r)

    def record(self, entries: List[Dict[str, Any]]) -> None:
        """Append already-built entries (ring + sink).  Entries are
        caller-sampled; this only stores and counts."""
        if not entries:
            return
        m = self._m
        lines: Optional[List[str]] = None
        with self._lock:
            for e in entries:
                self._ring.append(e)
            if self.sink_path is not None:
                lines = []
                for e in entries:
                    try:
                        lines.append(json.dumps(e, default=repr))
                    except (TypeError, ValueError):
                        m.inc("decisions.dropped")
                self._write_locked(lines)
        m.inc("decisions.recorded", len(entries))

    def _write_locked(self, lines: List[str]) -> None:
        if not lines:
            return
        try:
            if self._sink is None:
                self._sink = open(self.sink_path, "a")
                self._sink_bytes = self._sink.tell()
            buf = "\n".join(lines) + "\n"
            self._sink.write(buf)
            self._sink.flush()
            self._sink_bytes += len(buf)
            if self._sink_bytes >= self.rotate_bytes:
                self._rotate_locked()
        except OSError:
            self._m.inc("decisions.dropped", len(lines))
            try:
                if self._sink is not None:
                    self._sink.close()
            except OSError:
                pass
            self._sink = None

    def _rotate_locked(self) -> None:
        """path → path.1 → … → path.<rotate_keep> (oldest removed)."""
        self._sink.close()
        self._sink = None
        self._sink_bytes = 0
        oldest = f"{self.sink_path}.{self.rotate_keep}"
        try:
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.rotate_keep - 1, 0, -1):
                src = f"{self.sink_path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.sink_path}.{i + 1}")
            os.replace(self.sink_path, f"{self.sink_path}.1")
            self._m.inc("decisions.rotated")
        except OSError:
            self._m.inc("decisions.rotate_errors")

    # -- read side -------------------------------------------------------
    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._ring)
        if n is None:
            return items
        n = int(n)
        # items[-0:] would be the WHOLE ring, and a negative n the head
        return items[-n:] if n > 0 else []

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def stats(self) -> Dict[str, Any]:
        m = self._m
        with self._lock:
            ring = len(self._ring)
        return {
            "ring": ring,
            "capacity": self.capacity,
            "sample_rate": self.sample_rate,
            "sink": self.sink_path,
            "recorded": m.counter("decisions.recorded"),
            "sampled_out": m.counter("decisions.sampled_out"),
            "denied_kept": m.counter("decisions.denied_kept"),
            "denied_capped": m.counter("decisions.denied_capped"),
            "dropped": m.counter("decisions.dropped"),
            "rotated": m.counter("decisions.rotated"),
        }

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None


# ---------------------------------------------------------------------------
# Module surface (the hot-path entry points)
# ---------------------------------------------------------------------------


def install(log: Optional[DecisionLog]) -> Optional[DecisionLog]:
    """Install (``None`` uninstalls) the process-global decision log —
    the trace.py tracer discipline: one per process, shared by every
    client, so /decisions and incident bundles see one stream."""
    global _LOG
    prev = _LOG
    _LOG = log
    if prev is not None and prev is not log:
        prev.close()
    return log


def set_recording(log: Optional[DecisionLog]) -> Optional[DecisionLog]:
    """Swap the installed log WITHOUT closing the previous one — the
    per-rep A/B toggle (explain_smoke, tpu_watch): ``install(None)``
    would close the JSONL sink, so every armed rep would pay a file
    reopen inside the timed window that a steady-state log never pays.
    Returns the previously installed log."""
    global _LOG
    prev = _LOG
    _LOG = log
    return prev


def get() -> Optional[DecisionLog]:
    return _LOG


def enabled() -> bool:
    return _LOG is not None


#: Process identity stamped on every entry (fleet serving: a replica
#: process sets its replica id at startup, so merged decision streams
#: attribute each verdict to the process that served it).  None (the
#: single-process default) adds nothing to entries.
_IDENTITY: Optional[str] = None


def set_identity(identity: Optional[str]) -> None:
    """Set (None clears) the ``replica`` label on subsequent entries."""
    global _IDENTITY
    _IDENTITY = identity


def identity() -> Optional[str]:
    return _IDENTITY


def _entry(
    resource: str, permission: str, subject: str, allowed: bool, *,
    revision, strategy: str, cache_hit: bool, dedup_parked: bool,
    latency_s: float, trace_id: Optional[str], client_id,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    e: Dict[str, Any] = {
        "unix_s": round(time.time() if now is None else now, 6),
        "resource": resource,
        "permission": permission,
        "subject": subject,
        "verdict": "allowed" if allowed else "denied",
        "strategy": strategy,
        "latency_ms": round(latency_s * 1000.0, 4),
    }
    if revision is not None:
        e["revision"] = int(revision)
    if cache_hit:
        e["cache_hit"] = True
    if dedup_parked:
        e["dedup_parked"] = True
    if trace_id:
        e["trace_id"] = trace_id
    if client_id is not None:
        e["client"] = str(client_id)
    if _IDENTITY is not None:
        e["replica"] = _IDENTITY
    return e


def record_rels(
    rels,
    verdicts,
    *,
    revision=None,
    strategy=None,
    cache_hits=None,
    dedup_parked: bool = False,
    latency_s: float = 0.0,
    trace_id: Optional[str] = None,
    client_id=None,
) -> None:
    """Record a relationship batch's decisions: sampled allowed entries
    plus every denied one (bounded), one load + branch when no log is
    installed.  ``cache_hits`` is an optional per-item bool sequence."""
    log = _LOG
    if log is None:
        return
    m = log._m
    sname = strategy if isinstance(strategy, str) else strategy_name(strategy)
    now = time.time()
    entries: List[Dict[str, Any]] = []
    denied_kept = 0
    denied_capped = 0
    sampled_out = 0
    for i, r in enumerate(rels):
        allowed = bool(verdicts[i])
        if not allowed:
            if denied_kept >= log.denied_keep_max:
                denied_capped += 1
                continue
            denied_kept += 1
        elif not log.sampled():
            sampled_out += 1
            continue
        entries.append(_entry(
            f"{r.resource_type}:{r.resource_id}",
            r.resource_relation,
            (f"{r.subject_type}:{r.subject_id}#{r.subject_relation}"
             if r.subject_relation else f"{r.subject_type}:{r.subject_id}"),
            allowed,
            revision=revision, strategy=sname,
            cache_hit=bool(cache_hits[i]) if cache_hits is not None else False,
            dedup_parked=dedup_parked, latency_s=latency_s,
            trace_id=trace_id, client_id=client_id, now=now,
        ))
    if denied_kept:
        m.inc("decisions.denied_kept", denied_kept)
    if denied_capped:
        # the always-keep-denied guarantee was CAPPED this batch — a
        # distinct counter, never folded into sampling, so the audit
        # hole is visible ("why was user X denied" may have no entry)
        m.inc("decisions.denied_capped", denied_capped)
    if sampled_out:
        m.inc("decisions.sampled_out", sampled_out)
    log.record(entries)


def record_cols(
    n: int,
    verdicts,
    decode,
    *,
    revision=None,
    strategy=None,
    cache_hits=None,
    latency_s: float = 0.0,
    trace_id: Optional[str] = None,
    client_id=None,
) -> None:
    """Columnar mirror: sample FIRST, decode interned ids only for the
    entries actually kept (``decode(i) -> (resource, permission,
    subject)``), so a 100k-row bulk batch pays string reconstruction for
    a handful of rows, not the batch."""
    log = _LOG
    if log is None:
        return
    m = log._m
    sname = strategy if isinstance(strategy, str) else strategy_name(strategy)
    now = time.time()
    entries: List[Dict[str, Any]] = []
    denied_kept = 0
    denied_capped = 0
    sampled_out = 0
    for i in range(n):
        allowed = bool(verdicts[i])
        if not allowed:
            if denied_kept >= log.denied_keep_max:
                denied_capped += 1
                continue
            denied_kept += 1
        elif not log.sampled():
            sampled_out += 1
            continue
        try:
            resource, permission, subject = decode(i)
        except Exception:
            m.inc("decisions.dropped")
            continue
        entries.append(_entry(
            resource, permission, subject, allowed,
            revision=revision, strategy=sname,
            cache_hit=bool(cache_hits[i]) if cache_hits is not None else False,
            dedup_parked=False, latency_s=latency_s,
            trace_id=trace_id, client_id=client_id, now=now,
        ))
    if denied_kept:
        m.inc("decisions.denied_kept", denied_kept)
    if denied_capped:
        m.inc("decisions.denied_capped", denied_capped)
    if sampled_out:
        m.inc("decisions.sampled_out", sampled_out)
    log.record(entries)
