"""Closed-loop lookups, after ``bench8_lookup``'s draw: ``callers`` threads,
each sending its next request as soon as the last one is drained.  A
request is LookupResources (``<resource>#<permission>`` for one subject,
uniform) or LookupSubjects (one resource, uniform, for the subject type),
with the chances in ``mix``, each iterator drained to its complete answer.
The requests are a pool of ``pool_requests`` drawn from ``--seed``, more
than a window issues, sent in order, so that every lookup of a window is
a fresh uniform draw.

Every lookup issued in the window counts, from its call to its complete
answer; one that fails counts as infinitely late.  The answers of a share
of the requests, picked from the seed before the window, and the longest
answer, are kept for the comparison.
"""

from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np

from .. import traffic as T
from ..system import System


class Cell:
    def __init__(self, run) -> None:
        self.run = run
        self.tr = run.traffic
        self.rows = []  # (window number, request number, kind, ms)
        self.n_windows = 0
        self.kept = {}  # request number -> answer
        self.sizes = {}  # request number -> answer length
        self.longest = (-1, None)
        self.errors = []
        self.next = 0
        self._lock = threading.Lock()

    def setup(self) -> None:
        from gochugaru_tpu_torch import consistency
        from gochugaru_tpu_torch.utils.context import background

        run, tr = self.run, self.tr
        check = run.config["check"]
        self.check = check
        self.sys = System(run.world, check, run.device)
        run.prepare_s = self.sys.prepare()
        self.cs = consistency.full()
        self.ctx = background()
        self.draw()
        # the shapes this traffic uses: both directions, twice each
        w = T.rng(run.seed, T.STREAM_CONTROL)
        for _ in range(2):
            self._lookup(0, int(w.integers(0, run.world.n(check["subject"]))))
            self._lookup(1, int(w.integers(0, run.world.n(check["resource"]))))
        self.sys.sync()

    def draw(self) -> None:
        """The pool of requests, by object index (no program needed)."""
        run, tr = self.run, self.tr
        check = self.check = run.config["check"]
        n = tr["pool_requests"]
        c = T.rng(run.seed, T.STREAM_WORLD_QUERIES)
        self.kinds = np.where(c.random(n) < tr["mix"]["resources"], 0, 1)
        self.subj = T.draw_objects(run.world, check["subject"], tr.get("subjects", "uniform"), n, c)
        self.res = T.draw_objects(run.world, check["resource"], tr.get("resources", "uniform"), n, c)
        s = T.rng(run.seed, T.STREAM_SAMPLE)
        self.keep = s.random(n) < tr["sample_share"]

    def _lookup(self, kind: int, idx: int):
        c, w, chk = self.sys.client, self.run.world, self.check
        perm = chk["permissions"][0]
        if kind == 0:
            return list(c.lookup_resources(
                self.ctx, self.cs, f"{chk['resource']}#{perm}",
                f"{chk['subject']}:{w.name(chk['subject'], idx)}"))
        return list(c.lookup_subjects(
            self.ctx, self.cs, f"{chk['resource']}:{w.name(chk['resource'], idx)}",
            perm, chk["subject"]))

    # -- the window --------------------------------------------------------
    def start(self, t0: float, t1: float, traced: bool = False) -> None:
        self.t0, self.t1 = t0, t1
        self.n_windows += 1
        self.threads = [threading.Thread(target=self._caller, name=f"zbench-caller-{i}")
                        for i in range(self.tr["callers"])]
        for t in self.threads:
            t.start()

    def _caller(self) -> None:
        n = self.kinds.shape[0]
        win = self.n_windows - 1
        while True:
            t_call = time.perf_counter()
            if t_call >= self.t1:
                return
            with self._lock:
                k = self.next % n
                self.next += 1
            kind = int(self.kinds[k])
            try:
                ids = self._lookup(kind, int(self.subj[k] if kind == 0 else self.res[k]))
            except Exception as e:  # a failed lookup: infinitely late
                with self._lock:
                    self.rows.append((win, k, kind, math.inf))
                    self.errors.append(repr(e))
                continue
            ms = (time.perf_counter() - t_call) * 1e3
            with self._lock:
                self.rows.append((win, k, kind, ms))
                self.sizes[k] = len(ids)
                if self.keep[k]:
                    self.kept[k] = ids
                if len(ids) > len(self.longest[1] or ()):
                    self.longest = (k, ids)

    def join(self) -> None:
        for t in self.threads:
            t.join()

    # -- what the run reports ------------------------------------------------
    def record(self, run) -> None:
        """The measured window's lookups."""
        rows = [r for r in self.rows if r[0] == 0]
        run.attempted = len(rows)
        run.failed = sum(1 for r in rows if math.isinf(r[3]))
        run.lookup_ms = [(("resources", "subjects")[kind], ms) for _, _, kind, ms in rows]
        by = {}
        for _, k, kind, ms in rows:
            by.setdefault(k, []).append(ms)
        slow = sorted(by.items(), key=lambda kv: -max(kv[1]))[:8]
        for k, ms in slow:
            print(f"zbench: lookup {('resources', 'subjects')[int(self.kinds[k])]}"
                  f" #{k}: {len(ms)} runs, {self.sizes.get(k)} ids,"
                  f" {min(ms):.1f}-{max(ms):.1f} ms", file=sys.stderr)
        c = run.counters
        print("zbench: lookup counters " + ", ".join(
            f"{n} {c.get(n, 0.0):g}" for n in (
                "lookups.resources_device", "lookups.subjects_device", "lookups.frontier",
                "lookups.walker", "lookups.fused", "spmm.dispatches", "spmm.fallbacks",
                "spmm.captures")), file=sys.stderr)
        traced = sum(1 for r in self.rows if r[0] == 1)
        if traced:
            run.traced_rate = (len(rows) / run.seconds, traced / run.traced_seconds, "lookups/s")

    def verify(self, reference) -> dict:
        """The kept answers and the longest against the plain reference,
        as sorted lists of object ids."""
        kept = dict(self.kept)
        if self.longest[1] is not None:
            kept[self.longest[0]] = self.longest[1]
        mism = sum(int(sorted(ids) != self.expected(reference, k)) for k, ids in kept.items())
        return {"mismatches": mism, "unanswered": len(self.errors),
                "lookups_compared": len(kept)}

    def expected(self, reference, k: int):
        """The reference's answer to pool request ``k``, as sorted ids."""
        w, chk = self.run.world, self.run.config["check"]
        if self.kinds[k] == 0:
            return sorted(w.name(chk["resource"], i)
                          for i in reference.lookup_resources(int(self.subj[k])))
        return sorted(w.name(chk["subject"], i)
                      for i in reference.lookup_subjects(int(self.res[k])))
