"""Open-loop served checks, after ``bench9_serve``'s arrival model: one
Poisson clock at ``rate_checks_per_s``, each arrival a request of
``checks_per_request`` checks (a slice of a pool drawn from the seed) under
one of ``clients`` client ids, submitted as pre-interned columns through
``Client.with_serving(min_latency(), cache=False).submit_columns``.

A request is timed from when it was due, so a late sender or a growing
queue shows in every later request; a shed or failed request counts as
infinitely late.  Every request due in the window is sent, late if need
be, and waited for up to ``drain_s`` past the close.  The sender reads
each answer back as soon as it is in and lets go of its future, keeping
only the answers of the requests sampled for the comparison: a harness
that held every future would grow the collector's oldest generation by
hundreds of thousands of objects a window, and its full collections would
stall the serving threads for tens of milliseconds.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from .. import stats
from .. import traffic as T
from ..system import System


class Window:
    """The arrivals of one window and what came back."""

    def __init__(self, arrivals, starts, cids, sample) -> None:
        self.arrivals, self.starts, self.cids = arrivals, starts, cids
        self.sample = sample  # arrival numbers whose answers are kept
        self.pending = deque()  # (arrival number, future), oldest first
        self.sent = 0
        self.resolved = 0
        self.shed = 0
        self.lat = np.full(arrivals.shape[0], np.inf)
        self.answers = {}


class Cell:
    def __init__(self, run) -> None:
        self.run = run
        self.tr = run.traffic
        self.windows = []
        self.errors = []
        self.next = None

    def setup(self) -> None:
        from gochugaru_tpu_torch import consistency

        run, tr = self.run, self.tr
        check = run.config["check"]
        self.sys = System(run.world, check, run.device)
        run.prepare_s = self.sys.prepare()
        self.draw()
        self.pool = self.sys.columns(*self.pool_idx)
        self.h = self.sys.client.with_serving(cs=consistency.min_latency(), cache=False)
        self._warm()
        self.plan(run.rate, run.seconds)

    def draw(self) -> None:
        """The pool of checks and the measured window's arrivals, by object
        index (no program needed)."""
        c = T.rng(self.run.config["world_seed"], T.STREAM_WORLD_QUERIES)
        self.pool_idx = T.draw_checks(self.run.world, self.run.config["check"], self.tr,
                                      self.tr["pool_checks"], c)

    def plan(self, rate: float, seconds: float, stream: int = T.STREAM_ARRIVALS) -> None:
        """The arrivals of the next window at ``rate`` checks/s: what is sent
        and when drawn from the configuration's ``world_seed``, its order
        from the seed."""
        c = T.rng(self.run.config["world_seed"], stream)
        o = T.rng(self.run.seed, stream)
        n = self.tr["checks_per_request"]
        arrivals = T.poisson_arrivals(rate / n, seconds, c, o)
        m = arrivals.shape[0]
        starts = c.integers(0, self.tr["pool_checks"] - n, m)
        cids = c.integers(0, self.tr["clients"], m)
        p = o.permutation(m)
        sample = set(T.rng(self.run.seed, 100 * T.STREAM_SAMPLE + stream).choice(
            m, min(m, self.tr["sample_requests"]), replace=False).tolist())
        self.next = Window(arrivals, starts[p], cids[p], sample)

    def _warm(self) -> None:
        """Every tier of the latency path captured, then a burst and a paced
        run of requests through the handle, all drained."""
        from gochugaru_tpu_torch.utils.context import background
        from gochugaru_tpu_torch.utils.errors import ShedError

        c = self.sys.client
        lp = c._engine.latency_path(self.sys.dsnap)
        tiers = (c._engine_config or c._engine.config).latency_tiers
        for tier in tiers:
            for _ in range(2):
                lp.dispatch_columns(*(col[:tier] for col in self.pool))
        ctx = background()
        n = self.tr["checks_per_request"]
        futs = []
        w = T.rng(self.run.seed, T.STREAM_CONTROL)
        for count, pace in ((200, 0.0), (48, 0.003)):
            for k in range(count):
                s = int(w.integers(0, self.tr["pool_checks"] - n))
                while True:
                    try:
                        futs.append(self.h.submit_columns(
                            ctx, *(col[s:s + n] for col in self.pool),
                            client_id=k % self.tr["clients"]))
                        break
                    except ShedError:
                        time.sleep(0.005)
                if pace:
                    time.sleep(pace)
        for f in futs:
            f.result(timeout=60.0)

    # -- the window --------------------------------------------------------
    def start(self, t0: float, t1: float, traced: bool = False) -> None:
        if traced:
            self.plan(self.run.rate, t1 - t0, T.STREAM_TRACE)
        self.t0, self.t1 = t0, t1
        self.win, self.next = self.next, None
        self.windows.append(self.win)
        self.thread = threading.Thread(target=self._sender, name="zbench-sender")
        self.thread.start()

    def _sender(self) -> None:
        from gochugaru_tpu_torch.utils.context import background
        from gochugaru_tpu_torch.utils.errors import ShedError

        ctx = background()
        n = self.tr["checks_per_request"]
        pool, w = self.pool, self.win
        for k in range(w.arrivals.shape[0]):
            due = self.t0 + float(w.arrivals[k])
            self._collect(w, block_until=None)
            slack = due - time.perf_counter()
            if slack > 0.0015:
                time.sleep(slack - 0.001)  # let sub-millisecond arrivals bunch
            s = int(w.starts[k])
            try:
                w.pending.append((k, self.h.submit_columns(
                    ctx, pool[0][s:s + n], pool[1][s:s + n], pool[2][s:s + n],
                    client_id=int(w.cids[k]))))
                w.sent += 1
            except ShedError:
                w.shed += 1

    def _collect(self, w: Window, block_until) -> None:
        """Read back the answers in from the oldest pending request on;
        with ``block_until`` wait for each until then."""
        while w.pending:
            k, f = w.pending[0]
            if block_until is None and not f.done():
                return
            try:
                out = f.result(timeout=None if block_until is None
                               else max(0.0, block_until - time.perf_counter()))
            except Exception as e:  # a failed request: infinitely late
                self.errors.append(repr(e))
                w.pending.popleft()
                continue
            w.pending.popleft()
            w.resolved += 1
            w.lat[k] = stats.due_latency_ms(self.t0 + float(w.arrivals[k]), f.t_done)
            if k in w.sample:
                w.answers[k] = np.asarray(out, bool)

    def join(self) -> None:
        self.thread.join()
        self._collect(self.win, block_until=self.t1 + self.tr.get("drain_s", 60.0))

    def close(self) -> None:
        self.h.close()

    # -- what the run reports ------------------------------------------------
    def record(self, run) -> None:
        """The measured window's requests."""
        w = self.windows[0]
        run.attempted = int(w.arrivals.shape[0])
        run.failed = int(np.isinf(w.lat).sum())
        run.request_ms = w.lat.tolist()

    def verify(self, reference) -> dict:
        """Every check of the answered requests among the measured window's
        ``sample_requests``, drawn from the seed before it, against the plain
        reference; and the requests sent in any window whose answer never
        came."""
        w = self.windows[0]
        unanswered = sum(v.sent - v.resolved for v in self.windows)
        pick = sorted(w.answers)
        if not pick:
            return {"mismatches": 0, "unanswered": unanswered, "checks_compared": 0}
        got = np.concatenate([w.answers[a] for a in pick])
        want = self.expected(reference, w, pick)
        return {"mismatches": int((got != want).sum()), "unanswered": unanswered,
                "checks_compared": int(want.shape[0])}

    def expected(self, reference, w: Window, requests) -> np.ndarray:
        """The reference's verdicts of the checks of ``requests`` of ``w``."""
        n = self.tr["checks_per_request"]
        rows = np.concatenate([np.arange(int(w.starts[a]), int(w.starts[a]) + n)
                               for a in requests])
        res, perm, subj = (c[rows] for c in self.pool_idx)
        want = np.zeros(rows.shape[0], bool)
        for p, name in enumerate(self.run.config["check"]["permissions"]):
            m = perm == p
            want[m] = reference.check(name, res[m], subj[m])
        return want
