"""Closed-loop bulk checks: ``callers`` threads, each sending its next
``batch``-check batch as soon as the last one came back.

Each batch goes through ``Client._evaluate_columns_direct`` at the head
snapshot: the flat program and the probe kernels on the card, the rows it
flags settled on the host oracle.  No public call of ``Client`` takes a
columnar batch over the top serving tier, and ``Client.check`` lowers
Relationship objects on the host first (seconds a batch), so this is the
column path the serving layer itself uses, at bulk size.

The batches are a pool drawn from the configuration's ``world_seed``, put
in an order (and their rows in an order) drawn from ``--seed``, and sent
round-robin.  A batch
counts when its final verdicts are back inside the window; one still in
flight when the window closes counts for nothing.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .. import traffic as T
from ..system import System


class Cell:
    def __init__(self, run) -> None:
        self.run = run
        self.tr = run.traffic
        self.done = []  # (batch number, end time, packed verdicts)
        self.started = 0
        self.failed = 0
        self.measured = None  # (started, failed, done) at the measured window's end
        self.errors = []
        self._lock = threading.Lock()
        self.recorder = None

    def setup(self) -> None:
        run, tr = self.run, self.tr
        self.sys = System(run.world, run.config["check"], run.device)
        run.prepare_s = self.sys.prepare()
        self.draw()
        self.pool = [self.sys.columns(*q) for q in self.pool_idx]
        for q in self.pool[: max(2, tr["callers"])]:
            self.sys.evaluate(*q)
        self.sys.sync()
        if run.trace:
            from ..roofline import ProbeRecorder

            self.recorder = ProbeRecorder()
            self.recorder.install()

    def draw(self) -> None:
        """The pool of batches, by object index (no program needed)."""
        run, tr = self.run, self.tr
        c = T.rng(run.config["world_seed"], T.STREAM_WORLD_QUERIES)
        pool = [T.draw_checks(run.world, run.config["check"], tr, tr["batch"], c)
                for _ in range(tr["pool_batches"])]
        o = T.rng(run.seed, T.STREAM_WORLD_QUERIES)
        self.pool_idx = []
        for b in o.permutation(len(pool)):
            rows = o.permutation(tr["batch"])
            self.pool_idx.append(tuple(col[rows] for col in pool[b]))

    # -- the window --------------------------------------------------------
    def start(self, t0: float, t1: float, traced: bool = False) -> None:
        self.t0, self.t1 = t0, t1
        if self.recorder is not None:
            self.recorder.armed = traced
        self.threads = [threading.Thread(target=self._caller, name=f"zbench-caller-{i}")
                        for i in range(self.tr["callers"])]
        for t in self.threads:
            t.start()

    def _caller(self) -> None:
        P = len(self.pool)
        while time.perf_counter() < self.t1:
            with self._lock:
                i = self.started
                self.started += 1
            try:
                out = self.sys.evaluate(*self.pool[i % P])
            except Exception as e:  # counted as failed, reported on stderr
                with self._lock:
                    self.failed += 1
                    self.errors.append(repr(e))
                continue
            t = time.perf_counter()
            if t > self.t1:
                break
            with self._lock:
                self.done.append((i, t, np.packbits(np.asarray(out, bool))))

    def join(self) -> None:
        for t in self.threads:
            t.join()
        if self.measured is None:
            self.measured = (self.started, self.failed, len(self.done))
        if self.recorder is not None:
            self.recorder.armed = False

    # -- what the run reports ------------------------------------------------
    def close(self) -> None:
        if self.recorder is not None:
            self.recorder.uninstall()

    def record(self, run) -> None:
        """The measured window's numbers; the batch ends of both windows."""
        B = self.tr["batch"]
        started, failed, done = self.measured
        run.attempted = started * B
        run.failed = failed * B
        run.batch_ends = [t for _, t, _ in self.done]
        run.batches_evaluated = started
        run.batch = B
        traced = len(self.done) - done
        if traced:
            run.traced_rate = (done * B / run.seconds, traced * B / run.traced_seconds, "checks/s")
        if self.recorder is not None:
            run.probe_bound_ms = self.recorder.mean_bound_ms()

    def verify(self, reference) -> dict:
        """Every row of ``sample_batches`` batches finished in the window,
        drawn from the seed, against the plain reference."""
        B = self.tr["batch"]
        r = T.rng(self.run.seed, T.STREAM_SAMPLE)
        k = min(self.tr["sample_batches"], len(self.done))
        pick = r.choice(len(self.done), k, replace=False) if k else []
        mism = compared = 0
        for j in pick:
            i, _, bits = self.done[int(j)]
            got = np.unpackbits(bits, count=B).astype(bool)
            mism += int((got != self.expected(reference, i % len(self.pool_idx))).sum())
            compared += B
        return {"mismatches": mism, "unanswered": self.failed * B,
                "checks_compared": compared}

    def expected(self, reference, b: int) -> np.ndarray:
        """The reference's verdicts of pool batch ``b``."""
        res, perm, subj = self.pool_idx[b]
        want = np.zeros(res.shape[0], bool)
        for p, name in enumerate(self.run.config["check"]["permissions"]):
            m = perm == p
            want[m] = reference.check(name, res[m], subj[m])
        return want
