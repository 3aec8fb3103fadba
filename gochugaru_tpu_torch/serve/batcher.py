"""Continuous-batching serving front-end: an async micro-batch former
over the pinned tier ladder.

Every headline number so far was measured on pre-formed giant batches,
but the north-star workload arrives as thousands of concurrent small
Check/CheckMany calls — request-shaped, not batch-shaped.  This module
closes that gap with the idiom inference servers use (continuous
batching): concurrent submissions coalesce into the next pow2 tier slot
of the pinned latency ladder (engine/latency.py), so the device always
sees one of the shapes it already has a pinned CUDA graph for — no
recapture by construction, whatever the traffic does.

Two daemon threads per batcher, so batch FORMATION overlaps in-flight
device DISPATCH (form tier N+1 while N runs):

- the **former** watches the submission queues and flushes a batch when
  (a) the target tier slot fills, (b) the deadline-aware hold-back says
  waiting longer would miss the earliest queued deadline (expected cost
  per tier from the SHARED ``utils/admission.CostModel`` — the same
  estimate the deadline shed uses, no duplicated EWMA), or (c) the
  max-hold timer expires.  Formation drains per-client FIFO queues
  round-robin — **per-client fair admission**: one bulk caller cannot
  starve interactive clients out of a formed batch, because every
  client with pending work gets a turn per rotation.
- the **dispatcher** pops formed batches from a depth-1 queue and runs
  them through the injected dispatch callables (the client's
  ``_evaluate_rels``/``_evaluate_columns`` — breaker-gated, classified
  failures, host-oracle resolution), then slices verdicts back onto
  each submission's future.

Overload sheds, never queues unboundedly: a submission that would push
the pending-check depth past ``queue_max`` raises ``ShedError`` (an
``UnavailableError``, so the caller's retry envelope backs off — the
same contract the admission gate states), and a submission whose
deadline cannot cover the expected queue+dispatch cost sheds before it
ever queues.  When the latency-path CircuitBreaker is OPEN, the former
RE-FORMS for the batch path: target sizing switches from the pinned
tier ladder to ``batch_path_max`` (re-tier, don't replay the pinned
shapes), and the client evaluation reroutes onto the throughput path —
zero requests lost or duplicated across the transition (each future
resolves exactly once; rejected futures re-submit through the caller's
envelope).

Fault sites ``batcher.form`` (fires BEFORE any dequeue — a form fault
leaves the queue intact and the former retries) and
``batcher.dispatch`` (classified onto the batch's futures) ride the
chaos registry (utils/faults.py).

Copied from the reference package (host-only).
"""

from __future__ import annotations

import heapq
import queue as _queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine import vcache as _vcache
from ..engine.latency import tier_for
from ..utils import faults
from ..utils import metrics as _metrics
from ..utils import perf as _perf
from ..utils import trace as _trace
from ..utils.admission import OPEN, CostModel
from ..utils.errors import (
    BulkCheckItemError,
    DeadlineExceededError,
    ShedError,
    UnavailableError,
    classify_dispatch_exception,
)


@dataclass(frozen=True)
class ServeConfig:
    """Tuning for the micro-batch former."""

    #: max seconds a queued submission may wait before a partial batch
    #: flushes anyway (the hold-back ceiling)
    hold_max_s: float = 0.002
    #: pending CHECKS (not submissions) before submit() sheds with
    #: ``ShedError`` — the queue-depth shed path
    queue_max: int = 16_384
    #: safety slack subtracted from deadline budgets in the hold-back
    #: decision (clock granularity + wakeup jitter)
    deadline_margin_s: float = 0.0005
    #: formed-batch size cap while the breaker routes to the batch
    #: path (re-tier target; must be ≥ the top latency tier)
    batch_path_max: int = 8_192
    #: ask the client evaluation for the pinned latency path (engines
    #: whose latency path declines still serve on the throughput path)
    use_latency: bool = True
    #: formed batches buffered between former and dispatcher: 1 means
    #: one batch forms while one dispatches (the overlap)
    form_queue_depth: int = 1
    #: seconds close() waits for the drain before rejecting leftovers
    drain_timeout_s: float = 10.0
    #: check deduplication (engine/vcache.py): identical checks in one
    #: formed batch dispatch once (the evaluate layer collapses them and
    #: fans verdicts back out), a submission duplicating a batch already
    #: in flight parks on that batch's resolution (no queue slot, no
    #: tier lane), and the residual unique misses land on the SMALLEST
    #: covering pinned tier — effective tier occupancy counts unique
    #: work and padding shrinks with it, while the former keeps forming
    #: the next batch from the queue in parallel.  False restores the
    #: pre-dedup former byte-for-byte (the bench A/B baseline lever)
    dedup: bool = True


#: guards lazy waiter-event creation on SubmitFuture (module-global: a
#: per-future lock would put the allocation back on the submit path)
_FUT_EV_LOCK = threading.Lock()


class SubmitFuture:
    """The coalesced-result handle one submission awaits.  Resolves
    exactly once (a double resolve is a bug, asserted); ``result``
    honors context cancellation/deadline while waiting.

    The wakeup Event is created LAZILY by the first waiter: a
    threading.Event costs ~8µs to build, and at serving rates most
    futures resolve before anyone blocks on them — the submit path
    (front-end critical on the 1-core proxy) must not pay for a wait
    that usually never happens."""

    __slots__ = ("_done", "_ev", "_value", "_error", "t_submit", "t_done",
                 "dedup_parked")

    def __init__(self, t_submit: float) -> None:
        self._done = False
        self._ev: Optional[threading.Event] = None
        self._value = None
        self._error: Optional[BaseException] = None
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        #: True when this submission PARKED on an in-flight twin batch
        #: (engine/vcache.Singleflight) — decision-log provenance: its
        #: verdicts never passed the evaluate layer themselves, so the
        #: serving handle records them with ``dedup_parked: true``
        self.dedup_parked = False

    def done(self) -> bool:
        return self._done

    def _settle(self) -> None:
        self._done = True
        ev = self._ev
        if ev is None:
            # a waiter may be creating its event right now: re-check
            # under the same lock the waiter holds while creating it
            with _FUT_EV_LOCK:
                ev = self._ev
        if ev is not None:
            ev.set()

    def _resolve(self, value, t_done: float) -> None:
        assert not self._done, "future resolved twice"
        self._value = value
        self.t_done = t_done
        self._settle()

    def _reject(self, err: BaseException, t_done: float) -> None:
        assert not self._done, "future resolved twice"
        self._error = err
        self.t_done = t_done
        self._settle()

    def result(self, ctx=None, timeout: Optional[float] = None):
        """Block until the coalesced answer (or its error) arrives.
        ``ctx`` cancellation/deadline interrupts the wait."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._done and self._ev is None:
            with _FUT_EV_LOCK:
                if self._ev is None:
                    self._ev = threading.Event()
        while not self._done:
            if ctx is not None:
                err = ctx.err()
                if err is not None:
                    raise err
            step = 0.05
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise DeadlineExceededError(
                        "timed out waiting for coalesced result"
                    )
                step = min(step, remaining)
            self._ev.wait(step)
        if self._error is not None:
            raise self._error
        return self._value


class _Submission:
    """One queued Check/CheckMany: either a list of Relationships or a
    pre-interned column triple, atomic in formation (a submission's
    checks never split across formed batches — its future gets one
    contiguous verdict slice)."""

    __slots__ = (
        "client_id", "kind", "rels", "cols", "n", "deadline", "future",
        "queued",
    )

    def __init__(self, client_id, kind, rels, cols, n, deadline, future):
        self.client_id = client_id
        self.kind = kind  # "rels" | "cols"
        self.rels = rels
        self.cols = cols
        self.n = n
        self.deadline = deadline  # absolute monotonic, or None
        self.future = future
        self.queued = True


class _FormedBatch:
    __slots__ = ("subs", "total", "kind", "target", "reason", "t_formed",
                 "tier")

    def __init__(self, subs, total, kind, target, reason, t_formed, tier):
        self.subs = subs
        self.total = total
        self.kind = kind
        self.target = target
        self.reason = reason
        self.t_formed = t_formed
        self.tier = tier  # ladder tier the batch lands on, or None


#: flush reasons → counter names (serve.flush_*)
_FLUSH_FULL = "full"
_FLUSH_DEADLINE = "deadline"
_FLUSH_MAXHOLD = "maxhold"
_FLUSH_DRAIN = "drain"

#: ``serve.request_latency`` histogram uppers (seconds, submit→resolve).
#: The serve.request_s timer ring gives sliding-window quantiles; the
#: histogram gives the bucket-resolved tail — cumulative, mergeable, and
#: (through the exporter's OpenMetrics exemplars) each bucket links to
#: the last dispatch trace that landed in it
REQUEST_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)


class MicroBatcher:
    """The former/dispatcher pair.  Dispatch is injected so the batcher
    serves any engine shape (single-chip, latency-mode, partitioned
    mesh) and unit tests can drive formation deterministically
    (``start=False`` + ``form_batch``/``dispatch_batch``).

    ``cost`` is the SHARED ``utils/admission.CostModel`` (the client's
    ``AdmissionController.cost``): the hold-back reads per-tier
    expected dispatch cost from it and the dispatcher feeds measured
    batch costs back, so the deadline shed and the hold-back can never
    disagree about what a dispatch costs."""

    def __init__(
        self,
        *,
        tiers: Sequence[int],
        cost: Optional[CostModel] = None,
        breaker=None,
        admission=None,
        config: Optional[ServeConfig] = None,
        dispatch_rels: Optional[Callable] = None,
        dispatch_cols: Optional[Callable] = None,
        registry: Optional[_metrics.Metrics] = None,
        start: bool = True,
        inflight_dedup: bool = True,
    ) -> None:
        self.config = config or ServeConfig()
        self.tiers = tuple(sorted(int(t) for t in tiers))
        if not self.tiers:
            raise ValueError("empty tier ladder")
        self._top = self.tiers[-1]
        if self.config.batch_path_max < self._top:
            raise ValueError("batch_path_max must cover the top tier")
        self._cost = cost if cost is not None else CostModel()
        self._breaker = breaker
        self._adm = admission
        self._dispatch_rels = dispatch_rels
        self._dispatch_cols = dispatch_cols
        self._m = registry or _metrics.default
        #: cross-batch singleflight window (engine/vcache.py) — built
        #: whenever the pinned strategy tolerates serving a duplicate
        #: from its in-flight twin (everything but Full); whether it is
        #: USED is read from ``self.config.dedup`` at each submit/
        #: dispatch, so the online tuner can toggle dedup by swapping
        #: the config without rebuilding the batcher
        self._sf = _vcache.Singleflight(self._m) if inflight_dedup else None
        #: occupancy histogram buckets: the ladder itself plus half/
        #: quarter marks, so "flushed at 61 of 256" is visible
        self._fill_buckets = tuple(sorted(
            {t for t in self.tiers}
            | {max(1, t // 2) for t in self.tiers}
            | {max(1, t // 4) for t in self.tiers}
        ))
        #: per-tier occupancy buckets (``serve.occupancy.t{tier}``):
        #: live-lane counts at fixed fractions of the tier, precomputed
        #: here because a histogram's buckets freeze at first observe —
        #: the tuner reads these to place a tighter (possibly non-pow2)
        #: tier where the occupancy mass actually sits
        self._occ_buckets = {
            t: tuple(sorted({
                max(1, round(t * f))
                for f in (0.0625, 0.125, 0.1875, 0.25, 0.375, 0.5,
                          0.625, 0.75, 0.875, 1.0)
            }))
            for t in self.tiers
        }
        self._cond = threading.Condition()
        #: client_id → FIFO of _Submission (insertion-ordered dict: the
        #: round-robin rotation walks it)
        self._queues: "OrderedDict[Any, deque]" = OrderedDict()
        self._depth = 0  # queued CHECKS
        self._rr = 0  # round-robin rotation cursor
        self._dl_heap: List[Tuple[float, int, _Submission]] = []
        self._dl_seq = 0
        self._closed = False
        self._form_q: "_queue.Queue" = _queue.Queue(
            maxsize=max(1, self.config.form_queue_depth)
        )
        self._threads: List[threading.Thread] = []
        self._former_t: Optional[threading.Thread] = None
        self._disp_t: Optional[threading.Thread] = None
        if start:
            self._former_t = threading.Thread(
                target=self._former_loop,
                name="gochugaru-serve-former", daemon=True,
            )
            self._disp_t = threading.Thread(
                target=self._dispatcher_loop,
                name="gochugaru-serve-dispatcher", daemon=True,
            )
            self._threads = [self._former_t, self._disp_t]
            for t in self._threads:
                t.start()

    # -- submission ------------------------------------------------------
    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth

    def submit_rels(self, client_id, rels, ctx=None) -> SubmitFuture:
        return self._submit(client_id, "rels", rels=list(rels),
                            n=len(rels), ctx=ctx)

    def submit_columns(
        self, client_id, q_res, q_perm, q_subj, ctx=None
    ) -> SubmitFuture:
        cols = (
            np.ascontiguousarray(q_res, np.int32),
            np.ascontiguousarray(q_perm, np.int32),
            np.ascontiguousarray(q_subj, np.int32),
        )
        return self._submit(client_id, "cols", cols=cols,
                            n=int(cols[0].shape[0]), ctx=ctx)

    def _submit(self, client_id, kind, *, rels=None, cols=None, n=0,
                ctx=None) -> SubmitFuture:
        t_submit = time.perf_counter()
        fut = SubmitFuture(t_submit)
        if n == 0:
            fut._resolve([] if kind == "rels" else np.zeros(0, bool), t_submit)
            return fut
        if n > self._top:
            raise ValueError(
                f"submission of {n} checks exceeds the top tier"
                f" {self._top} — batch-shaped work belongs on the"
                " throughput path, not the micro-batcher"
            )
        self._m.inc("serve.submissions")
        span = _trace.span_of(ctx) if ctx is not None else _trace.NOOP
        deadline = None
        if ctx is not None:
            dl = ctx.deadline()
            if dl is not None:
                # context deadlines are time.monotonic-based; queue
                # bookkeeping runs on perf_counter — convert once here
                deadline = t_submit + (dl - time.monotonic())
            # deadline-budget shed through the admission controller:
            # the SAME cost model + counters as the caller-formed path
            if self._adm is not None:
                self._adm.check_deadline(ctx, span=span)
        sf = self._sf if self.config.dedup else None
        if sf is not None and sf.active:
            # cross-batch singleflight: a submission whose rows ALL
            # duplicate the currently-dispatching batch's checks parks
            # on that batch's resolution — no queue slot, no tier lane.
            # One Python-scalar probe rules out the common non-dup case
            # before any per-row key packing happens
            if kind == "cols":
                k0 = _vcache.pack_one(
                    int(cols[1][0]), int(cols[0][0]), int(cols[2][0])
                )
            else:
                k0 = _vcache.rel_key(rels[0])
            if sf.probe(k0):
                if kind == "cols":
                    keys = _vcache.pack_cols(cols[1], cols[0], cols[2])
                else:
                    keys = [_vcache.rel_key(r) for r in rels]
                if sf.try_park(keys, fut, kind, n):
                    fut.dedup_parked = True
                    span.event("serve.dedup_parked", checks=n)
                    return fut
        shed_depth = None
        with self._cond:
            if self._closed:
                raise UnavailableError("serving handle is closed")
            if self._depth + n > self.config.queue_max:
                self._m.inc("serve.sheds")
                shed_depth = self._depth
            else:
                sub = _Submission(
                    client_id, kind, rels, cols, n, deadline, fut
                )
                was_empty = self._depth == 0
                q = self._queues.get(client_id)
                if q is None:
                    q = self._queues[client_id] = deque()
                q.append(sub)
                self._depth += n
                self._m.set_gauge("serve.queue_depth", self._depth)
                if deadline is not None:
                    self._dl_seq += 1
                    heapq.heappush(
                        self._dl_heap, (deadline, self._dl_seq, sub)
                    )
                # wake the former only when this submission can CHANGE
                # its decision: first work after idle, a full target
                # tier, or a new deadline that may tighten the
                # hold-back.  Every other submission rides the former's
                # own timed wait — at tens of thousands of
                # submissions/s, notify-per-submit is the front-end's
                # biggest avoidable cost
                if (
                    was_empty or deadline is not None
                    or self._depth >= self._top
                ):
                    self._cond.notify_all()
        if shed_depth is not None:
            # shed bookkeeping OUTSIDE the condition lock: the spike-
            # threshold-crossing note() spawns an incident capture
            # thread, and that spawn must not serialize submitters and
            # the former/dispatcher loops on the hottest lock at peak
            # load (same hoist as the admission gate's shed path)
            _trace.note_anomaly("shed")
            span.event(
                "serve.shed", depth=shed_depth, submitting=n,
                queue_max=self.config.queue_max,
            )
            raise ShedError(
                f"serve queue depth {shed_depth} + {n} >"
                f" queue_max {self.config.queue_max}"
            )
        return fut

    # -- formation -------------------------------------------------------
    def _batch_path_mode(self) -> bool:
        """OPEN breaker → the pinned latency shapes lost trust: re-form
        for the batch path (HALF_OPEN keeps the ladder — probes must
        land on the pinned shapes to close the breaker)."""
        return self._breaker is not None and self._breaker.state == OPEN

    def _target_cap(self) -> int:
        return (
            self.config.batch_path_max if self._batch_path_mode()
            else self._top
        )

    def _earliest_deadline_locked(self, now: float) -> Optional[float]:
        h = self._dl_heap
        while h and not h[0][2].queued:
            heapq.heappop(h)
        return h[0][0] if h else None

    def _oldest_submit_locked(self) -> Optional[float]:
        # each client queue is FIFO, so the global oldest is among heads
        heads = [q[0].future.t_submit for q in self._queues.values() if q]
        return min(heads) if heads else None

    def _flush_decision_locked(self, now: float):
        """(flush?, reason, wait_s) for the current queue state."""
        cfg = self.config
        cap = self._target_cap()
        if self._closed:
            return True, _FLUSH_DRAIN, 0.0
        if self._depth >= cap:
            return True, _FLUSH_FULL, 0.0
        wait = cfg.hold_max_s
        oldest = self._oldest_submit_locked()
        if oldest is not None:
            held = now - oldest
            if held >= cfg.hold_max_s:
                return True, _FLUSH_MAXHOLD, 0.0
            wait = cfg.hold_max_s - held
        dl = self._earliest_deadline_locked(now)
        if dl is not None:
            # deadline-aware hold-back: flush the moment waiting longer
            # would put the earliest deadline inside the expected
            # dispatch cost for the tier this queue would land on
            tier = tier_for(self.tiers, min(self._depth, self._top))
            est = self._cost.expected_s(tier)
            slack = (dl - now) - est - cfg.deadline_margin_s
            if slack <= 0:
                return True, _FLUSH_DEADLINE, 0.0
            wait = min(wait, slack)
        return False, "", max(wait, 1e-4)

    def form_batch(self) -> Optional[_FormedBatch]:
        """Block until a batch is due, then form and return it (None
        when closed and drained).  The former thread's body; tests call
        it directly for deterministic formation."""
        with self._cond:
            while True:
                if self._depth == 0:
                    if self._closed:
                        return None
                    self._cond.wait(0.05)
                    continue
                now = time.perf_counter()
                flush, reason, wait_s = self._flush_decision_locked(now)
                if not flush:
                    # hold-back with work queued: the wall ledger calls
                    # this queue-wait (submissions sit while the former
                    # deliberately holds) — reported around the wait so
                    # the 21× question shows up as a bucket, not idle
                    self._cond.wait(wait_s)
                    _perf.report_wall("queue_wait", now, time.perf_counter())
                    continue
                # the injection point sits BEFORE any dequeue: a form
                # fault leaves every submission queued — the former
                # pauses and retries, zero requests lost
                try:
                    faults.fire("batcher.form")
                except Exception:
                    self._m.inc("serve.form_faults")
                    self._cond.wait(0.002)
                    # form-fault retry pause: attributed to formation,
                    # not lost to idle (the chaos closure test's subject)
                    _perf.report_wall("form", now, time.perf_counter())
                    continue
                batch = self._form_locked(reason, now)
                t_f1 = time.perf_counter()
                _perf.report_wall("form", now, t_f1)
                self._m.observe("serve.form_s", t_f1 - now)
                return batch

    def _form_locked(self, reason: str, now: float) -> _FormedBatch:
        cfg = self.config
        # deadline-heap hygiene: formed/settled entries are popped only
        # when they surface at the heap head, so sustained
        # deadline-bearing traffic would otherwise grow it without
        # bound — compact when stale entries dominate
        if len(self._dl_heap) > 64:
            live = sum(len(q) for q in self._queues.values())
            if len(self._dl_heap) > max(64, 4 * live):
                self._dl_heap = [
                    e for e in self._dl_heap if e[2].queued
                ]
                heapq.heapify(self._dl_heap)
        cap = self._target_cap()
        batch_path = cap > self._top
        target = (
            cap if batch_path
            else (tier_for(self.tiers, min(self._depth, self._top))
                  or self._top)
        )
        picked: List[_Submission] = []
        total = 0
        kind: Optional[str] = None
        clients = list(self._queues.keys())
        start = self._rr % len(clients)
        order = clients[start:] + clients[:start]
        self._rr += 1
        progress = True
        while progress and total < target:
            progress = False
            for cid in order:
                q = self._queues.get(cid)
                if not q:
                    continue
                head = q[0]
                if head.deadline is not None and head.deadline <= now:
                    # already dead: reject now instead of burning a slot
                    q.popleft()
                    if not q:
                        self._queues.pop(cid, None)
                    head.queued = False
                    self._depth -= head.n
                    self._m.inc("serve.deadline_expired")
                    head.future._reject(
                        DeadlineExceededError(
                            "deadline passed while queued for a batch"
                        ),
                        now,
                    )
                    progress = True
                    continue
                if kind is not None and head.kind != kind:
                    continue
                if total + head.n > target:
                    continue
                q.popleft()
                if not q:
                    self._queues.pop(cid, None)
                head.queued = False
                if kind is None:
                    kind = head.kind
                picked.append(head)
                total += head.n
                self._depth -= head.n
                progress = True
                if total >= target:
                    break
        self._m.set_gauge("serve.queue_depth", self._depth)
        tier = tier_for(self.tiers, total) if not batch_path else None
        if picked:
            m = self._m
            m.inc(f"serve.flush_{reason}")
            if batch_path:
                m.inc("serve.reformed_batchpath")
            for s in picked:
                m.observe("serve.queue_wait_s", now - s.future.t_submit)
            oldest = min(s.future.t_submit for s in picked)
            m.observe("serve.hold_s", now - oldest)
            m.observe_hist("serve.batch_fill", total, self._fill_buckets)
            if tier is not None:
                m.observe_hist(
                    "serve.occupancy", total / tier,
                    (0.25, 0.5, 0.75, 0.9, 1.0),
                )
                # per-tier live-lane histogram — the tuner's primary
                # input ("tier 1024 p90 occupancy 131" reads off this)
                m.observe_hist(
                    f"serve.occupancy.t{tier}", total,
                    self._occ_buckets[tier],
                )
        return _FormedBatch(picked, total, kind, target, reason, now, tier)

    # -- dispatch --------------------------------------------------------
    def dispatch_batch(self, batch: _FormedBatch) -> None:
        """Run one formed batch through the injected evaluation and
        settle every future exactly once.  Dispatch failures classify
        onto the retry taxonomy and reject the batch's futures — the
        submitters' envelopes re-submit, so a transient fault (or the
        breaker tripping mid-queue) loses nothing.

        With dedup on, the batch's key→row map opens a singleflight
        WINDOW for the duration of the dispatch: submissions arriving
        meanwhile whose rows all duplicate in-flight checks park on it
        and settle here, from the same verdicts (engine/vcache.py
        Singleflight) — the window closes on every exit path."""
        m = self._m
        if not batch.subs:
            return
        t0 = time.perf_counter()
        # wall ledger: formed→dispatch-start is the formed batch's queue
        # wait; the dispatch window itself reports as ``filter`` (host
        # concat/slice/settle) with the device stages — reported by the
        # latency path from the same stamps its budget uses — overlaying
        # it at higher priority, so filter ends up the host-side residue
        _perf.report_wall("queue_wait", batch.t_formed, t0)
        sp = _trace.root_span(
            "serve.dispatch",
            batch=batch.total, target=batch.target, reason=batch.reason,
            kind=batch.kind, submissions=len(batch.subs),
            occupancy=round(batch.total / batch.target, 4),
        )
        sf = self._sf if self.config.dedup else None
        window_open = False
        verdicts = None
        try:
            try:
                faults.fire("batcher.dispatch")
                use_latency = self.config.use_latency and batch.tier is not None
                if batch.kind == "cols":
                    if len(batch.subs) == 1:
                        q_res, q_perm, q_subj = batch.subs[0].cols
                    else:
                        q_res = np.concatenate([s.cols[0] for s in batch.subs])
                        q_perm = np.concatenate([s.cols[1] for s in batch.subs])
                        q_subj = np.concatenate([s.cols[2] for s in batch.subs])
                    if sf is not None:
                        keys = _vcache.pack_cols(q_perm, q_res, q_subj)
                        if isinstance(keys, np.ndarray):
                            ks = np.sort(keys)
                            # unique-work count off the same sort the
                            # window probes use — effective occupancy
                            unique = int(
                                1 + (ks[1:] != ks[:-1]).sum()
                            ) if ks.shape[0] else 0
                            sf.open_cols(keys, ks)
                        else:
                            key_map = dict(zip(keys, range(len(keys))))
                            unique = len(key_map)
                            sf.open_map(key_map)
                        sp.set_attr("unique", unique)
                        m.inc("serve.unique_checks", unique)
                        window_open = True
                    verdicts = self._dispatch_cols(
                        q_res, q_perm, q_subj, use_latency, sp
                    )
                else:
                    rels = [r for s in batch.subs for r in s.rels]
                    if sf is not None:
                        kl = [_vcache.rel_key(r) for r in rels]
                        key_map = dict(zip(kl, range(len(kl))))
                        sp.set_attr("unique", len(key_map))
                        m.inc("serve.unique_checks", len(key_map))
                        sf.open_map(key_map)
                        window_open = True
                    verdicts = self._dispatch_rels(rels, use_latency, sp)
            except BulkCheckItemError as e:
                # a per-item oracle failure is batch-relative: slice it
                # back onto submissions.  Fully-evaluated submissions
                # resolve normally, the failing one gets ITS OWN
                # submission-relative BulkCheckItemError (no
                # cross-submitter verdict leakage, no out-of-range
                # index), and never-evaluated ones reject retriable so
                # their envelopes re-submit — they weren't at fault
                m.inc("serve.dispatch_errors")
                sp.set_attr("error", "BulkCheckItemError")
                t1 = time.perf_counter()
                off = 0
                for s in batch.subs:
                    if off + s.n <= e.index:
                        s.future._resolve(e.results[off:off + s.n], t1)
                    elif off <= e.index:
                        s.future._reject(
                            BulkCheckItemError(
                                e.index - off, e.results[off:e.index],
                                e.__cause__ or e,
                            ),
                            t1,
                        )
                    else:
                        s.future._reject(UnavailableError(
                            "batch aborted by another submission's"
                            " per-item failure"
                        ), t1)
                    off += s.n
                return
            except Exception as e:
                classified = classify_dispatch_exception(e)
                err = classified if classified is not None else e
                m.inc("serve.dispatch_errors")
                sp.set_attr("error", type(err).__name__)
                t1 = time.perf_counter()
                for s in batch.subs:
                    s.future._reject(err, t1)
                return
            dt = time.perf_counter() - t0
            # feed the shared cost model at this batch's ladder tier —
            # the hold-back's estimate learns from real coalesced
            # dispatches, not just caller-formed ones.  Batch-path
            # (breaker-open) batches have no ladder tier; they tag with
            # their target cap instead of the tier-less channel, which
            # is reserved for CALLER-formed dispatch costs (see
            # CostModel.observe)
            self._cost.observe(
                dt, tier=batch.tier if batch.tier is not None else batch.target
            )
            m.observe("serve.dispatch_s", dt)
            t1 = time.perf_counter()
            # exemplar: the batch's dispatch trace id, so a fat latency
            # bucket on /metrics links straight to a recorded trace
            # (flight-only spans carry ids too — the recorder retains
            # them even when the head sample dropped the trace)
            tid = sp.trace_id if sp.sampled else None
            off = 0
            for s in batch.subs:
                s.future._resolve(verdicts[off:off + s.n], t1)
                lat = t1 - s.future.t_submit
                m.observe("serve.request_s", lat)
                m.observe_hist(
                    "serve.request_latency", lat,
                    REQUEST_LATENCY_BUCKETS, trace_id=tid,
                )
                off += s.n
            m.inc("serve.batches")
            m.inc("serve.checks", batch.total)
        finally:
            # settle-exactly-once backstop: a BaseException escaping the
            # paths above (interpreter shutdown, a settle-path bug) must
            # not strand futures mid-dispatch — whoever is still waiting
            # gets a classified rejection instead of a hang.  The
            # singleflight window settles the same way: on success the
            # parked futures resolve from this batch's verdicts, on any
            # failure they reject retriable and their envelopes
            # re-submit
            for s in batch.subs:
                if not s.future.done():
                    s.future._reject(
                        UnavailableError("serve dispatch aborted"),
                        time.perf_counter(),
                    )
            if window_open:
                sf.close(
                    verdicts,
                    None if verdicts is not None else UnavailableError(
                        "deduplicated twin's batch failed; re-submit"
                    ),
                    time.perf_counter(),
                )
            _perf.report_wall("filter", t0, time.perf_counter())
            sp.end()

    # -- threads ---------------------------------------------------------
    def _reject_batch(self, batch: _FormedBatch, err: BaseException) -> None:
        now = time.perf_counter()
        for s in batch.subs:
            if not s.future.done():
                s.future._reject(err, now)

    def _former_loop(self) -> None:
        try:
            while True:
                batch = self.form_batch()
                if batch is None:
                    break
                # hand off without blocking forever: if the dispatcher
                # died, this thread — not close(), which can't reach an
                # in-hand batch — must settle the batch's futures.  The
                # handoff wait (former blocked behind a busy dispatcher)
                # is attributed to the ``form`` wall bucket: it is a
                # formation stall, and leaving it to the idle residual
                # would make the tuner read dispatch backpressure as
                # headroom
                t_h0 = time.perf_counter()
                while True:
                    try:
                        self._form_q.put(batch, timeout=0.25)
                        break
                    except _queue.Full:
                        d = self._disp_t
                        if d is not None and not d.is_alive():
                            self._reject_batch(batch, UnavailableError(
                                "serve dispatcher thread died"
                            ))
                            break
                _perf.report_wall("form", t_h0, time.perf_counter())
        except BaseException:  # never leave submitters hanging on a
            self._emergency_stop()  # dead former — close() rejects them
            raise
        finally:
            try:  # drain sentinel; a full queue is fine — the
                self._form_q.put_nowait(None)  # dispatcher also polls
            except _queue.Full:  # _closed + former-dead as its exit
                pass

    def _dispatcher_loop(self) -> None:
        try:
            while True:
                try:
                    batch = self._form_q.get(timeout=0.25)
                except _queue.Empty:
                    # sentinel-less exit: a dead/finished former sends
                    # nothing more, so closed + empty queue = done
                    f = self._former_t
                    if self._closed and (f is None or not f.is_alive()):
                        return
                    continue
                if batch is None:
                    return
                self.dispatch_batch(batch)
        except BaseException:
            self._emergency_stop()
            raise

    def _emergency_stop(self) -> None:
        self._m.inc("serve.thread_crashes")
        threading.Thread(target=self.close, daemon=True).start()

    # -- lifecycle -------------------------------------------------------
    def apply_config(self, config: ServeConfig) -> None:
        """Swap the serve config atomically (the online tuner's apply
        path).  ServeConfig is frozen and ``self.config`` is read fresh
        at every decision point, so a single attribute store is the
        whole transaction; the former is woken so a SHORTER hold-back
        takes effect on the batch it is currently holding rather than
        one hold later.  Dedup toggles the same way: the singleflight
        window object persists, ``config.dedup`` gates its use."""
        if config.batch_path_max < self._top:
            raise ValueError("batch_path_max must cover the top tier")
        self.config = config
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        """Drain: flush everything queued, stop both threads, reject
        any straggler futures (classified, so callers back off rather
        than hang)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=self.config.drain_timeout_s)
        leftovers: List[_Submission] = []
        while True:  # formed-but-undispatched batches (a dead dispatcher)
            try:
                b = self._form_q.get_nowait()
            except _queue.Empty:
                break
            if b is not None:
                leftovers.extend(s for s in b.subs if not s.future.done())
        if self._sf is not None:
            # a window left open by a killed dispatcher: fail its parked
            # futures closed instead of stranding them
            self._sf.close(None, UnavailableError(
                "serving handle closed before dispatch"
            ), time.perf_counter())
        with self._cond:
            for q in self._queues.values():
                leftovers.extend(s for s in q if not s.future.done())
            self._queues.clear()
            self._depth = 0
            self._m.set_gauge("serve.queue_depth", 0)
        now = time.perf_counter()
        for s in leftovers:
            s.queued = False
            s.future._reject(
                UnavailableError("serving handle closed before dispatch"),
                now,
            )
