"""Group-commit write pipeline: the write-side mirror of the serving
micro-batcher (serve/batcher.py).

Every revision costs fixed machinery regardless of how many tuples it
carries — a closure advance, a device table reship, a snapshot finish,
a replication frame.  One-transaction-at-a-time writes pay that
machinery per transaction; production write streams (PAPER.md §3.2:
~10k writes/s sustained while serving reads) amortize it across a
GROUP.  This module forms the groups:

- ``GroupCommitter`` coalesces concurrent ``submit(txn)`` calls and
  commits each group through ``Store.write_group`` — ONE collapsed
  last-writer-wins delta, ONE log entry, per-transaction zookies minted
  inside the group (base+1..base+k) so client-visible revision
  semantics are unchanged.  Two daemon threads, so group FORMATION
  overlaps the in-flight group APPLICATION (the serve-side former/
  dispatcher overlap, transplanted): the former drains the submission
  queue into the next group while the applier holds the store lock for
  the previous one.  The deadline-aware hold-back reuses the admission
  ``CostModel`` (utils/admission.py) — a DEDICATED instance fed by
  group-apply walls, so write-apply EWMAs never pollute the read-path
  deadline shed's estimate.

- ``ChainCompactor`` is the background half of the LSM story: today a
  long delta chain materializes only when the static
  ``max(lsm_compact_min, E/8)`` trip fires INSIDE apply_delta — a
  synchronous O(E) merge landing on whichever writer crosses the bound.
  The compactor polls the newest resident generation off the request
  path and materializes the chain early (at a soft fraction of the hard
  trip), so week-long write streams keep probe depth bounded without
  any writer ever paying the merge.  ``LsmSnapshot._materialize`` is
  idempotent under its own lock, so compacting OUTSIDE the store lock
  races safely with a reader touching a lazy column.

Telemetry: ``write.group_size`` (store-side histogram, writes per
group), ``write.group_form_wall`` (formation wall histogram),
``write.flush_{full,deadline,maxhold,drain}`` counters,
``store.lsm_overlay_rows`` / ``store.lsm_chain_len`` gauges,
``store.bg_compactions`` counter — and a ``write_path`` /perf section
(utils/perf.py register_report_section) next to the read-side buckets.

Copied from the reference package (host-only).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

from ..utils import metrics as _metrics
from ..utils import perf as _perf
from ..utils.admission import CostModel
from ..utils.errors import DeadlineExceededError, ShedError, UnavailableError
from .delta import LSM_COMPACT_MIN


@dataclass(frozen=True)
class GroupCommitConfig:
    """Tuning for the group-commit former and the chain compactor."""

    #: transactions per group before the former flushes on "full"
    max_group: int = 256
    #: max seconds a queued transaction may wait before a partial group
    #: flushes anyway (the hold-back ceiling)
    hold_max_s: float = 0.002
    #: safety slack subtracted from deadline budgets in the hold-back
    #: decision (clock granularity + wakeup jitter)
    deadline_margin_s: float = 0.0005
    #: pending transactions before submit() sheds with ``ShedError``
    queue_max: int = 8_192
    #: seconds close() waits for the drain before rejecting leftovers
    drain_timeout_s: float = 10.0
    #: chain-compactor poll interval (seconds); 0 disables the worker
    compact_poll_s: float = 0.05
    #: soft trip as a fraction of the hard max(lsm_compact_min, E/8)
    #: bound: the compactor materializes early so apply_delta never has
    #: to do it synchronously on a writer
    compact_fraction: float = 0.5


#: formation-wall histogram uppers (seconds, first-submission→formed)
GROUP_FORM_WALL_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
)

#: flush reasons → counter names (write.flush_*)
_FLUSH_FULL = "full"
_FLUSH_DEADLINE = "deadline"
_FLUSH_MAXHOLD = "maxhold"
_FLUSH_DRAIN = "drain"

#: guards lazy waiter-event creation on WriteFuture (module-global, same
#: rationale as the serve batcher's: the submit path must not pay an
#: Event construction for a wait that usually never happens)
_FUT_EV_LOCK = threading.Lock()


class WriteFuture:
    """The zookie handle one submitted transaction awaits.  Resolves
    exactly once: with the minted revision token, or with the exception
    that ejected the transaction (precondition, CREATE conflict,
    validation) or failed its whole group (injected fault, store
    error)."""

    __slots__ = ("_done", "_ev", "_value", "_error", "t_submit", "t_done")

    def __init__(self, t_submit: float) -> None:
        self._done = False
        self._ev: Optional[threading.Event] = None
        self._value: Optional[str] = None
        self._error: Optional[BaseException] = None
        self.t_submit = t_submit
        self.t_done: Optional[float] = None

    def done(self) -> bool:
        return self._done

    def _settle(self) -> None:
        self._done = True
        ev = self._ev
        if ev is None:
            with _FUT_EV_LOCK:
                ev = self._ev
        if ev is not None:
            ev.set()

    def _resolve(self, value: str, t_done: float) -> None:
        assert not self._done, "write future resolved twice"
        self._value = value
        self.t_done = t_done
        self._settle()

    def _reject(self, err: BaseException, t_done: float) -> None:
        assert not self._done, "write future resolved twice"
        self._error = err
        self.t_done = t_done
        self._settle()

    def result(self, ctx=None, timeout: Optional[float] = None) -> str:
        """Block until the zookie (or the ejection error) arrives.
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
                        "timed out waiting for group commit"
                    )
                step = min(step, remaining)
            self._ev.wait(step)
        if self._error is not None:
            raise self._error
        return self._value


class _WriteSub:
    __slots__ = ("txn", "deadline", "future", "t_queued")

    def __init__(self, txn, deadline, future, t_queued):
        self.txn = txn
        self.deadline = deadline  # absolute monotonic, or None
        self.future = future
        self.t_queued = t_queued


class _FormedGroup:
    __slots__ = ("subs", "reason", "t_formed")

    def __init__(self, subs, reason, t_formed):
        self.subs = subs
        self.reason = reason
        self.t_formed = t_formed


class GroupCommitter:
    """Coalesce concurrent write transactions into atomic store groups."""

    def __init__(
        self,
        store,
        config: Optional[GroupCommitConfig] = None,
        *,
        registry: Optional[_metrics.Metrics] = None,
    ) -> None:
        self._store = store
        self._cfg = config if config is not None else GroupCommitConfig()
        self._m = registry if registry is not None else _metrics.default
        # dedicated estimator, shared CLASS with the admission gate: the
        # hold-back asks "would holding this txn past its deadline,
        # given what a group apply costs" with the same EWMA machinery
        # the read shed uses — but write-apply samples must not inflate
        # the read path's expected dispatch cost, so no shared instance
        self._cost = CostModel()
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._closing = False
        self._apply_q: _queue.Queue = _queue.Queue(maxsize=1)
        _perf.register_report_section("write_path", self._report_section)
        self._former = threading.Thread(
            target=self._former_loop, name="group-commit-former", daemon=True
        )
        self._applier = threading.Thread(
            target=self._applier_loop, name="group-commit-applier", daemon=True
        )
        self._former.start()
        self._applier.start()

    # -- submit ----------------------------------------------------------
    def submit(self, txn, *, deadline: Optional[float] = None) -> WriteFuture:
        """Queue one transaction for the next group; returns the future
        its zookie (or ejection error) arrives on.  Sheds with
        ``ShedError`` past ``queue_max`` pending transactions — bounded
        queues, same contract as the serving front-end."""
        now = time.monotonic()
        fut = WriteFuture(now)
        with self._cond:
            if self._closing:
                raise UnavailableError("group committer is closed")
            if len(self._pending) >= self._cfg.queue_max:
                raise ShedError(
                    f"write queue at capacity ({self._cfg.queue_max})"
                )
            self._pending.append(_WriteSub(txn, deadline, fut, now))
            self._cond.notify_all()
        return fut

    def write(self, txn, ctx=None, *, timeout: Optional[float] = None) -> str:
        """Submit and wait — the drop-in replacement for ``store.write``
        the client routes through when group commit is on."""
        deadline = None
        if ctx is not None:
            dl = getattr(ctx, "deadline", None)
            if callable(dl):
                dl = dl()
            if dl is not None:
                deadline = float(dl)
        return self.submit(txn, deadline=deadline).result(ctx, timeout)

    # -- formation -------------------------------------------------------
    def _flush_decision_locked(self, now: float):
        """(flush?, reason, wait_s) for the current queue state."""
        if not self._pending:
            return False, None, None
        if len(self._pending) >= self._cfg.max_group:
            return True, _FLUSH_FULL, None
        oldest = self._pending[0]
        held = now - oldest.t_queued
        if held >= self._cfg.hold_max_s:
            return True, _FLUSH_MAXHOLD, None
        wait = self._cfg.hold_max_s - held
        earliest = min(
            (s.deadline for s in self._pending if s.deadline is not None),
            default=None,
        )
        if earliest is not None:
            # deadline-aware hold-back: flush once waiting longer would
            # push the earliest deadline past the expected apply cost
            slack = (
                (earliest - now)
                - self._cost.expected_s()
                - self._cfg.deadline_margin_s
            )
            if slack <= 0:
                return True, _FLUSH_DEADLINE, None
            wait = min(wait, slack)
        return False, None, max(wait, 0.0)

    def _form_group(self) -> Optional[_FormedGroup]:
        """Block until a group is due, then drain it from the queue.
        Returns None when closing with nothing left to drain."""
        with self._cond:
            while True:
                now = time.monotonic()
                if self._closing:
                    if not self._pending:
                        return None
                    flush, reason = True, _FLUSH_DRAIN
                else:
                    flush, reason, wait = self._flush_decision_locked(now)
                if flush:
                    subs = []
                    while self._pending and len(subs) < self._cfg.max_group:
                        subs.append(self._pending.popleft())
                    t_formed = time.monotonic()
                    self._m.inc(f"write.flush_{reason}")
                    self._m.observe("write.form_s", t_formed - subs[0].t_queued)
                    self._m.observe_hist(
                        "write.group_form_wall",
                        t_formed - subs[0].t_queued,
                        GROUP_FORM_WALL_BUCKETS,
                    )
                    return _FormedGroup(subs, reason, t_formed)
                self._cond.wait(
                    self._cfg.hold_max_s if wait is None else wait
                )

    def _former_loop(self) -> None:
        while True:
            try:
                group = self._form_group()
            except Exception:  # emergency stop: never kill the thread
                time.sleep(0.002)
                continue
            if group is None:
                self._apply_q.put(None)  # drain sentinel for the applier
                return
            self._apply_q.put(group)

    # -- application -----------------------------------------------------
    def _apply_group(self, group: _FormedGroup) -> None:
        t0 = time.monotonic()
        try:
            outcomes = self._store.write_group([s.txn for s in group.subs])
        except BaseException as e:
            # whole-group failure (injected fault, store error): every
            # member rejects with the same error — the group was atomic,
            # nothing applied, a retry resubmits cleanly
            now = time.monotonic()
            for s in group.subs:
                if not s.future.done():
                    s.future._reject(e, now)
            return
        t1 = time.monotonic()
        self._cost.observe(t1 - t0)
        self._m.inc("write.groups")
        self._m.inc("write.txns", len(group.subs))
        self._m.observe("write.apply_s", t1 - t0)
        for s, out in zip(group.subs, outcomes):
            if isinstance(out, BaseException):
                s.future._reject(out, t1)
            else:
                s.future._resolve(out, t1)

    def _applier_loop(self) -> None:
        while True:
            group = self._apply_q.get()
            if group is None:
                return
            try:
                self._apply_group(group)
            except Exception:
                # _apply_group settles futures itself; a failure past
                # that point must not take the applier down
                now = time.monotonic()
                for s in group.subs:
                    if not s.future.done():
                        s.future._reject(
                            UnavailableError("group apply failed"), now
                        )

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        """Drain pending groups and stop both threads.  Submissions the
        drain window cannot flush reject with ``UnavailableError``."""
        with self._cond:
            if self._closing:
                return
            self._closing = True
            self._cond.notify_all()
        self._former.join(timeout=self._cfg.drain_timeout_s)
        self._applier.join(timeout=self._cfg.drain_timeout_s)
        now = time.monotonic()
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
        for s in leftovers:
            if not s.future.done():
                s.future._reject(
                    UnavailableError("group committer closed"), now
                )

    # -- observability ---------------------------------------------------
    def _report_section(self) -> dict:
        """The ``write_path`` /perf section: group formation and apply
        next to the read-side wall buckets."""
        hists = self._m.hist_snapshot()

        def _hist(name):
            h = hists.get(name)
            if h is None:
                return None
            uppers, counts, total, s, _ = h
            return {
                "uppers": list(uppers), "counts": counts,
                "total": total, "sum": s,
            }

        return {
            "groups": self._m.counter("write.groups"),
            "txns": self._m.counter("write.txns"),
            "flush": {
                r: self._m.counter(f"write.flush_{r}")
                for r in (_FLUSH_FULL, _FLUSH_DEADLINE, _FLUSH_MAXHOLD,
                          _FLUSH_DRAIN)
            },
            "group_size": _hist("write.group_size"),
            "group_form_wall_s": _hist("write.group_form_wall"),
            "apply_cost": self._cost.state(),
            "chain": {
                "overlay_rows": self._m.gauge("store.lsm_overlay_rows"),
                "chain_len": self._m.gauge("store.lsm_chain_len"),
                "bg_compactions": self._m.counter("store.bg_compactions"),
                "batch_applies": self._m.counter("closure.batch_applies"),
            },
        }


class ChainCompactor:
    """Low-priority worker that materializes long delta chains off the
    request path.

    Polls ``Store.peek_chain()`` and, when the accumulated overlay
    crosses ``compact_fraction`` of the hard ``max(lsm_compact_min,
    E/8)`` trip, merges the chain OUTSIDE the store lock
    (``LsmSnapshot._materialize`` is idempotent under the snapshot's own
    lock, so it races safely with readers touching lazy columns and
    with the trip firing inside apply_delta).  The next apply_delta
    then starts a fresh chain from the merged base — probe depth stays
    bounded instead of ratcheting toward a synchronous O(E) merge on a
    writer."""

    def __init__(
        self,
        store,
        config: Optional[GroupCommitConfig] = None,
        *,
        registry: Optional[_metrics.Metrics] = None,
    ) -> None:
        self._store = store
        self._cfg = config if config is not None else GroupCommitConfig()
        self._m = registry if registry is not None else _metrics.default
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="chain-compactor", daemon=True
        )
        if self._cfg.compact_poll_s > 0:
            self._thread.start()

    def poll_once(self) -> bool:
        """One poll: publish chain gauges, compact if due.  Returns True
        when a compaction ran (exposed for tests and benchmarks that
        drive the compactor deterministically)."""
        got = self._store.peek_chain()
        if got is None:
            self._m.set_gauge("store.lsm_overlay_rows", 0.0)
            self._m.set_gauge("store.lsm_chain_len", 0.0)
            return False
        snap, rows, chain_len = got
        self._m.set_gauge("store.lsm_overlay_rows", float(rows))
        self._m.set_gauge("store.lsm_chain_len", float(chain_len))
        if rows <= 0:
            return False
        cm = getattr(self._store, "lsm_compact_min", None)
        if cm is None:
            cm = LSM_COMPACT_MIN
        trip = max(int(cm), int(snap.num_edges) // 8)
        if rows <= trip * self._cfg.compact_fraction:
            return False
        mat = getattr(snap, "_materialize", None)
        if mat is None:
            return False
        # NEVER compact_ctx here: the device may still hold this
        # revision's delta_info, and renumbering contexts post-handoff
        # would invalidate ids it already consumed
        mat(compact_ctx=False)
        self._m.inc("store.bg_compactions")
        self._m.set_gauge("store.lsm_overlay_rows", 0.0)
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self._cfg.compact_poll_s):
            try:
                self.poll_once()
            except Exception:
                # best-effort worker: a transient race (snapshot evicted
                # mid-poll) must not kill the thread
                continue

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
