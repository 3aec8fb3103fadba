"""Consistency strategies (reference: ``consistency/consistency.go``).

A ``Strategy`` selects which materialized graph snapshot a read/check
evaluates against — the PACELC speed-vs-freshness trade-off the reference
documents (consistency/consistency.go:10-17).  Revisions are ZedToken-style
opaque strings minted by writes; here a revision names a materialized
snapshot generation of the tuple store (SURVEY.md §5 "Checkpoint / resume").

- ``full()``        — evaluate at the latest revision, materializing any
                      pending writes first (consistency/consistency.go:29-35).
- ``min_latency()`` — evaluate at the store's preferred (already
                      materialized) revision; the default and fastest
                      (consistency/consistency.go:42-48).
- ``at_least(rev)`` — at least as fresh as ``rev``; read-after-write
                      (consistency/consistency.go:54-62).
- ``snapshot(rev)`` — exactly ``rev`` (consistency/consistency.go:69-77).

The strategy is also the **verdict cache's read policy**
(engine/vcache.policy_for): a check made with ``snapshot``/``at_least``
reads and populates the cache shard of the exact revision the store
resolved, ``min_latency`` hits the freshest resident revision's shard,
and ``full`` bypasses the cache entirely — cached verdicts are always
revision-exact, so no strategy can ever observe a verdict from a
revision it would not have evaluated at.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from .utils.context import Context

#: Context key carrying the overlap key (requestmeta.RequestOverlapKey
#: analogue, consistency/consistency.go:21-23).
OVERLAP_KEY = "io.gochugaru-tpu.overlap-key"


class Requirement(enum.Enum):
    FULL = "fully_consistent"
    MIN_LATENCY = "minimize_latency"
    AT_LEAST = "at_least_as_fresh"
    SNAPSHOT = "at_exact_snapshot"


@dataclass(frozen=True)
class Strategy:
    """The strategy a request uses to trade off freshness with latency
    (consistency/consistency.go:15-17)."""

    requirement: Requirement
    revision: Optional[str] = None


def with_overlap_key(ctx: Context, key: str) -> Context:
    """Attach the hotspot-mitigation overlap key to a context; subsequent
    requests made with the returned context carry it
    (consistency/consistency.go:21-23)."""
    return ctx.with_value(OVERLAP_KEY, key)


def full() -> Strategy:
    """Evaluate at the most recent revision; least performant, guarantees
    read consistency (consistency/consistency.go:29-35)."""
    return Strategy(Requirement.FULL)


def min_latency() -> Strategy:
    """Evaluate at the store's preferred revision; optimal performance and
    the default (consistency/consistency.go:42-48)."""
    return Strategy(Requirement.MIN_LATENCY)


def at_least(revision: str) -> Strategy:
    """Evaluate at the provided revision or newer — avoids read-after-write
    inconsistencies (consistency/consistency.go:54-62)."""
    return Strategy(Requirement.AT_LEAST, revision)


def snapshot(revision: str) -> Strategy:
    """Evaluate at exactly the provided revision
    (consistency/consistency.go:69-77)."""
    return Strategy(Requirement.SNAPSHOT, revision)


def policy_for(strategy: Strategy) -> tuple:
    """Map a strategy onto the fleet *placement* policy (SURVEY §L2b):
    once revisions live on different replica processes, the consistency
    strategy decides which replicas are eligible to serve the read.

    Returns ``(mode, revision)`` where ``revision`` is the strategy's
    revision token (or None) and ``mode`` is one of:

    - ``"head"``     — FULL: only a replica at the authoritative head at
                       dispatch time is fresh enough;
    - ``"any"``      — MIN_LATENCY: any ring member serves (fastest);
    - ``"at_least"`` — AT_LEAST: any replica whose resident head has
                       reached ``revision`` (read-your-writes; zookies
                       raise the floor the same way);
    - ``"exact"``    — SNAPSHOT: the replica must hold exactly
                       ``revision`` (forwarded unchanged — the store's
                       own RevisionUnavailableError semantics apply).
    """
    req = strategy.requirement
    if req == Requirement.FULL:
        return "head", None
    if req == Requirement.MIN_LATENCY:
        return "any", None
    if req == Requirement.AT_LEAST:
        return "at_least", strategy.revision
    if req == Requirement.SNAPSHOT:
        return "exact", strategy.revision
    raise ValueError(f"unknown consistency requirement {req}")


# Go-parity aliases.
Full = full
MinLatency = min_latency
AtLeast = at_least
Snapshot = snapshot
WithOverlapKey = with_overlap_key
