"""Deterministic fault injection: a process-global registry of named
injection sites.

The retry taxonomy (utils/errors.py, utils/retry.py) mirrors the
reference's failure envelope exactly — but until this module existed no
code path ever *raised* the transient errors it classifies, so the
backoff envelope, the partial-result semantics of BulkCheckItemError,
and the watch cursor-resume contract were dead wiring.  Production graph
stores treat failure handling as a benchmarked surface (PAPERS.md:
Graphulo measures degraded-mode throughput explicitly; Samyama leans on
admission control to keep accelerated paths honest under overload); this
registry is the lever that lets tests and benches exercise those paths
end-to-end, deterministically.

Design constraints, in order:

1. **Zero cost when disarmed.**  ``fire(site)`` is called from hot
   dispatch paths (device dispatch, snapshot selection, per-update watch
   delivery).  A module-level ``_ACTIVE`` flag makes the disarmed call a
   single attribute load + branch; no dict lookup, no lock.
2. **Deterministic.**  Every armed site owns its own ``random.Random``
   seeded at arm time, so a chaos run with a fixed seed injects the same
   fault sequence every time — flaky-by-construction tests are worse
   than no tests.
3. **Policy per site.**  Probability (coin per hit), ``times`` (fire at
   most N times), ``after`` (skip the first N hits), or any combination:
   ``arm("device.dispatch", times=1, after=2)`` is "the third dispatch
   fails once".
4. **Classified errors only.**  The default injected error is
   ``UnavailableError`` — the transient class the retry envelope
   understands — so an injection exercises the *production* recovery
   path, not a synthetic one.  Sites may arm any error factory.

Injection sites threaded through the tree (grep ``faults.fire``):

    store.snapshot_for       snapshot-generation selection (store/store.py)
    store.materialize        snapshot swap / rebuild (store/store.py)
    snapshot.finish          snapshot column finalization (store/snapshot.py)
    device.prepare           device-resident snapshot build (engine/device.py)
    prepare.build            first-prepare table build (engine/flat.py)
    closure.delta            incremental closure advance (store/closure.py)
                             AND the group-commit pre-commit point
                             (store/store.py write_group)
    device.dispatch          batched check dispatch (engine/device.py)
    lookup.dispatch          frontier lookup hop dispatch
                             (engine/spmv.py; the client's lookup
                             surface retries these under the envelope)
    latency.dispatch         pinned small-batch dispatch (engine/latency.py;
                             the client's circuit breaker counts these
                             and reroutes latency traffic to the batch
                             path, utils/admission.py)
    batcher.form             serving batch formation, before any dequeue
                             (serve/batcher.py: the former pauses and
                             retries, the queue intact)
    batcher.dispatch         serving batch dispatch (serve/batcher.py:
                             classified onto the batch's futures)
    cache.lookup             verdict-cache lookup, before any cached
                             state is read (engine/vcache.py)
    explain.walk             explain-tree derivation (engine/explain.py;
                             fires BEFORE any tree state exists, so the
                             client envelope's retry can never observe
                             a torn tree)
"""

from __future__ import annotations

import random
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Union

from . import metrics as _metrics
from .errors import UnavailableError

ErrorFactory = Union[BaseException, type, Callable[[str], BaseException]]

#: module-level fast path: False ⇒ fire() returns after one branch.
_ACTIVE = False


class FaultSpec:
    """One armed injection site and its firing policy (mutable counters
    are read back by tests: ``hits`` = times the site was reached while
    armed, ``fired`` = faults actually raised)."""

    __slots__ = ("site", "error", "probability", "times", "after", "rng",
                 "hits", "fired")

    def __init__(
        self,
        site: str,
        error: ErrorFactory,
        probability: float,
        times: Optional[int],
        after: int,
        seed: Optional[int],
    ) -> None:
        self.site = site
        self.error = error
        self.probability = probability
        self.times = times
        self.after = after
        self.rng = random.Random(seed)
        self.hits = 0
        self.fired = 0

    def make_error(self) -> BaseException:
        e = self.error
        if isinstance(e, BaseException):
            return e
        if isinstance(e, type) and issubclass(e, BaseException):
            return e(f"injected fault at {self.site}")
        return e(self.site)  # callable factory

    def should_fire(self) -> bool:
        """Policy decision for one hit (``hits`` already incremented)."""
        if self.hits <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.probability < 1.0 and self.rng.random() >= self.probability:
            return False
        return True


class FaultRegistry:
    """Named injection sites with per-site policies.  One process-global
    ``default`` instance exists; the module-level ``fire``/``arm``/
    ``disarm``/``reset`` helpers operate on it."""

    def __init__(self, registry: Optional[_metrics.Metrics] = None) -> None:
        self._lock = threading.Lock()
        self._specs: Dict[str, FaultSpec] = {}
        self._m = registry or _metrics.default

    # -- arming ----------------------------------------------------------
    def arm(
        self,
        site: str,
        *,
        error: ErrorFactory = UnavailableError,
        probability: float = 1.0,
        times: Optional[int] = None,
        after: int = 0,
        seed: Optional[int] = None,
    ) -> FaultSpec:
        """Arm ``site``.  Defaults inject an ``UnavailableError`` on every
        hit; combine ``probability``/``times``/``after`` for policies
        ("one-shot on the 3rd hit" = ``times=1, after=2``)."""
        spec = FaultSpec(site, error, probability, times, after, seed)
        with self._lock:
            self._specs[site] = spec
        _recompute_active()
        return spec

    def disarm(self, site: str) -> None:
        with self._lock:
            self._specs.pop(site, None)
        _recompute_active()

    def reset(self) -> None:
        """Disarm every site (test teardown)."""
        with self._lock:
            self._specs.clear()
        _recompute_active()

    @contextmanager
    def armed(self, site: str, **kw: Any):
        """``with faults.default.armed("device.dispatch", times=2) as spec:``
        — arm for the block, disarm on exit, yield the spec for counter
        assertions."""
        spec = self.arm(site, **kw)
        try:
            yield spec
        finally:
            self.disarm(site)

    # -- introspection ---------------------------------------------------
    def active(self) -> bool:
        with self._lock:
            return bool(self._specs)

    def spec(self, site: str) -> Optional[FaultSpec]:
        with self._lock:
            return self._specs.get(site)

    def hits(self, site: str) -> int:
        s = self.spec(site)
        return s.hits if s is not None else 0

    def fired(self, site: str) -> int:
        s = self.spec(site)
        return s.fired if s is not None else 0

    # -- the injection point --------------------------------------------
    def maybe_fire(self, site: str) -> None:
        """Raise the armed error for ``site`` if its policy triggers.
        The error is constructed under the lock but raised outside it."""
        with self._lock:
            spec = self._specs.get(site)
            if spec is None:
                return
            spec.hits += 1
            if not spec.should_fire():
                return
            spec.fired += 1
            err = spec.make_error()
        self._m.inc("faults.injected")
        self._m.inc(f"faults.injected.{site}")
        raise err


#: Process-global default registry (mirrors utils/metrics.py ``default``).
default = FaultRegistry()


def _recompute_active() -> None:
    global _ACTIVE
    _ACTIVE = default.active()


def fire(site: str) -> None:
    """The injection point production code calls.  Disarmed cost: one
    module-global load and a branch."""
    if not _ACTIVE:
        return
    default.maybe_fire(site)


def arm(site: str, **kw: Any) -> FaultSpec:
    return default.arm(site, **kw)


def disarm(site: str) -> None:
    default.disarm(site)


def reset() -> None:
    default.reset()


def armed(site: str, **kw: Any):
    return default.armed(site, **kw)
