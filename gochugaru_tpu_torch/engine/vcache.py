"""Revision-pinned verdict cache + singleflight dedup for the serving path.

Zanzibar-scale serving lives on two observations: hot (subject, resource,
permission) tuples repeat constantly under skewed traffic, and the
consistency surface (consistency.py) exists precisely so a repeated read
can be answered from a revision-pinned result without re-walking the
graph.  This module supplies both halves:

**VerdictCache** — definite check verdicts keyed on (snapshot revision,
permission slot, resource id, subject id, query-context fingerprint)
under a byte-bounded LRU whose eviction granularity is a whole revision
shard.  Revision keying makes invalidation *structural*: a write mints a
new revision, so a fresh snapshot simply opens a fresh keyspace — there
is no invalidation protocol to get wrong, and a pinned ``Snapshot``
reader keeps hitting its own revision's shard for as long as it stays
resident.  The consistency strategies become the cache's READ POLICY
(``policy_for``): Snapshot/AtLeast reads hit the shard of the revision
the store resolved for them, MinLatency hits the freshest resident
revision (the one ``snapshot_for`` picked), and Full bypasses the cache
entirely — the same PACELC split the reference documents.

Cacheability discipline (the correctness edge):

- caveated verdicts whose caveat read LIVE query context are **never
  cached** — a request carrying ``caveat_context`` bypasses both the
  read and the write for that item (the relationship path detects this
  per item; the columnar path never carries query context);
- context-free caveat outcomes and expiry-gated rows cache with a
  **pinned now_us** recorded on the entry — the same discipline as
  ``LookupCursor.now_us``: a hit serves the verdict as evaluated at the
  pinned time, it never silently re-gates expirations at a later clock.

**Singleflight** — the cross-batch half of check deduplication: while a
formed batch's checks are in flight on the device, the batcher holds an
open *dispatch window* (the batch's key→row map).  A submission arriving
during the window whose rows ALL duplicate in-flight keys **parks** on
the window instead of occupying queue slots and tier lanes; when the
owning batch settles, the verdicts fan back out to every parked future.
The mechanism is deliberately lock-light: the submit path pays one
Python-scalar key probe to rule out the (common) non-duplicate case
before doing any per-row work, columnar windows are a sorted key array
(one bisect per probe, one vectorized searchsorted per park attempt),
and exactly one window is ever open — the serving dispatcher settles
batches strictly in formation order.

Fault site ``cache.lookup`` rides the chaos registry: an armed lookup
raises before any cached state is consulted, the classified error
reaches the caller's retry envelope, and the chaos soak asserts oracle
parity straight through it.

Copied from the reference package (host-only).  A cache on the default
registry registers ``stats`` as the ``vcache`` section of the ``/perf``
report (utils/perf.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import (
    Any, Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence,
)

import numpy as np

from ..consistency import Requirement, Strategy
from ..utils import faults
from ..utils import metrics as _metrics

__all__ = [
    "CachePolicy",
    "Singleflight",
    "VerdictCache",
    "fingerprint_context",
    "pack_cols",
    "pack_one",
    "policy_for",
    "rel_key",
]


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

#: query-context fingerprint of the empty context — the only fingerprint
#: cacheable relationship entries ever carry (live-context items bypass)
EMPTY_CTX_FP = 0


def fingerprint_context(ctx: Optional[Mapping[str, Any]]) -> int:
    """64-bit fingerprint of a query caveat context (0 = empty).  Only
    used to KEY dedup of identical in-flight requests — cache entries
    are never written for non-empty contexts, so a fingerprint collision
    can at worst coalesce two genuinely identical dispatches."""
    if not ctx:
        return EMPTY_CTX_FP
    import hashlib

    from ..rel.relationship import _canonical_caveat_json

    h = hashlib.blake2b(
        _canonical_caveat_json(ctx).encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") or 1


def rel_key(r) -> tuple:
    """Dedup/cache key of a Relationship-shaped check: the full 6-field
    identity (resource triple + subject triple) plus the query-context
    fingerprint.  String-keyed on purpose — it captures subject-relation
    and wildcard identity exactly, with no dependence on interner state."""
    return (r.key(), fingerprint_context(r.caveat_context))


#: exact-packing bounds for the columnar int64 key: slot < 2^15,
#: node ids < 2^24 each → 63 bits, no collision possible
_PACK_SLOT_MAX = 1 << 15
_PACK_NODE_MAX = 1 << 24


def pack_cols(q_perm: np.ndarray, q_res: np.ndarray, q_subj: np.ndarray):
    """Columnar check keys: one int64 ndarray when every id fits the
    exact pack (slot<<48 | res<<24 | subj — the common case by orders of
    magnitude), else a list of (perm, res, subj) tuples.  Both forms are
    EXACT — dedup and cache hits must never alias distinct checks."""
    if q_res.size == 0:
        return np.zeros(0, np.int64)
    pmin = int(q_perm.min())
    nmin = min(int(q_res.min()), int(q_subj.min()))
    pmax = int(q_perm.max())
    nmax = max(int(q_res.max()), int(q_subj.max()))
    if pmin >= 0 and nmin >= 0 and pmax < _PACK_SLOT_MAX and nmax < _PACK_NODE_MAX:
        return (
            (q_perm.astype(np.int64) << 48)
            | (q_res.astype(np.int64) << 24)
            | q_subj.astype(np.int64)
        )
    return list(zip(q_perm.tolist(), q_res.tolist(), q_subj.tolist()))


def pack_one(perm: int, res: int, subj: int):
    """The int64 pack of one (perm, res, subj) triple — the submit
    path's scalar fast probe.  Matches pack_cols' bit layout for
    in-bounds ids; out-of-bounds ids return a tuple that simply won't
    match an int-keyed window (degrades parking, never correctness)."""
    if 0 <= perm < _PACK_SLOT_MAX and 0 <= res < _PACK_NODE_MAX \
            and 0 <= subj < _PACK_NODE_MAX:
        return (perm << 48) | (res << 24) | subj
    return (perm, res, subj)


def keys_list(keys) -> list:
    """Python-object view of pack_cols output (dict-key form)."""
    return keys.tolist() if isinstance(keys, np.ndarray) else keys


# ---------------------------------------------------------------------------
# Read policy (consistency.py strategies → cache behavior)
# ---------------------------------------------------------------------------


class CachePolicy(NamedTuple):
    read: bool
    write: bool


CACHE_OFF = CachePolicy(False, False)
CACHE_RW = CachePolicy(True, True)


def policy_for(strategy: Optional[Strategy]) -> CachePolicy:
    """The consistency strategy IS the cache's read policy:

    - ``Full`` bypasses the cache entirely (read-your-writes at the
      latest revision must see the evaluator, never a resident shard);
    - ``Snapshot``/``AtLeast`` read and write the shard of the exact
      revision the store resolved for them (pinned / at-least-as-fresh);
    - ``MinLatency`` reads the freshest resident revision — which is
      precisely the snapshot ``snapshot_for`` hands back.

    ``None`` (no strategy known at this call site) disables caching."""
    if strategy is None or strategy.requirement == Requirement.FULL:
        return CACHE_OFF
    return CACHE_RW


# ---------------------------------------------------------------------------
# The verdict cache
# ---------------------------------------------------------------------------


class _ColShard:
    """One revision's columnar entries: a SORTED int64 snapshot (keys +
    encoded values, probed by np.searchsorted — ~6× cheaper per row
    than dict gets on the serving path, and the probe holds the GIL for
    C time only) plus an ``extra`` dict absorbing inserts between
    rebuilds.  A rebuild merges extra into the snapshot when it grows
    past max(1024, len/4) — O(n log n) amortized over the growth that
    triggered it.  ``tuple_mode`` worlds (ids past the exact int64
    pack) stay dict-only.

    The (keys, vals) pair is published as ONE tuple attribute (``snap``)
    so lock-free readers can never observe a torn pair — two separate
    attribute stores would let a reader bind the new keys against the
    old values and serve a definite verdict for the WRONG tuple.  A
    reader racing ``extra``'s clear can only see a spurious miss (the
    row re-dispatches), never a wrong hit."""

    __slots__ = ("snap", "extra", "tuple_mode")

    REBUILD_MIN = 1024

    def __init__(self) -> None:
        self.snap = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        self.extra: dict = {}
        self.tuple_mode = False

    def __len__(self) -> int:
        return self.snap[0].shape[0] + len(self.extra)

    def maybe_rebuild(self) -> None:
        keys, vals = self.snap
        if self.tuple_mode or len(self.extra) <= max(
            self.REBUILD_MIN, keys.shape[0] // 4
        ):
            return
        ne = len(self.extra)
        ek = np.fromiter(self.extra.keys(), np.int64, count=ne)
        ev = np.fromiter(self.extra.values(), np.int64, count=ne)
        allk = np.concatenate([keys, ek])
        allv = np.concatenate([vals, ev])
        order = np.argsort(allk, kind="stable")
        allk, allv = allk[order], allv[order]
        if allk.shape[0] > 1:
            keep = np.empty(allk.shape[0], bool)
            keep[0] = True
            np.not_equal(allk[1:], allk[:-1], out=keep[1:])
            allk, allv = allk[keep], allv[keep]
        self.snap = (allk, allv)  # one atomic publish
        self.extra = {}


class VerdictCache:
    """Byte-bounded, revision-sharded LRU of definite check verdicts.

    Entries pin ``now_us``, the evaluation time the verdict was computed
    at (expiry gates re-served at the pinned time, the LookupCursor
    discipline).  Shards evict whole-revision at a time — the
    structural-invalidation property — least-recently-USED revision
    first, so a pinned Snapshot reader's shard stays warm under head
    writes for as long as its reads keep refreshing it.

    Thread-safety: mutation is locked; bulk lookups read the shard's
    snapshot arrays and dicts lock-free (arrays are replaced wholesale,
    never mutated; CPython dict gets are safe against concurrent
    inserts; eviction drops whole shard objects) — the same discipline
    as ``Interner.keys_batch``."""

    #: rough per-entry cost estimates driving the byte bound (key +
    #: value tuple + dict slot overhead)
    COL_ENTRY_BYTES = 96
    REL_ENTRY_BYTES = 320

    def __init__(
        self,
        max_bytes: int = 64 << 20,
        *,
        max_revisions: int = 8,
        registry: Optional[_metrics.Metrics] = None,
    ) -> None:
        self.max_bytes = int(max_bytes)
        self.max_revisions = int(max_revisions)
        self._m = registry or _metrics.default
        self._lock = threading.Lock()
        #: revision → {"c": _ColShard, "r": {rel_key: (bool, now_us)}}
        self._revs: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        self._bytes = 0
        self._entries = 0
        if self._m is _metrics.default:
            # /perf carries the cache's state next to the cost ledger
            # (last-created cache per process wins — the common shape
            # is one); custom-registry caches (tests) stay off it
            from ..utils import perf as _perf

            _perf.register_report_section("vcache", self.stats)

    # -- internals -------------------------------------------------------
    def _shard(self, revision: int, create: bool):
        with self._lock:
            sh = self._revs.get(revision)
            if sh is not None:
                self._revs.move_to_end(revision)
                return sh
            if not create:
                return None
            sh = {"c": _ColShard(), "r": {}}
            self._revs[revision] = sh
            self._evict_locked()
            self._publish_locked()
            return sh

    def _evict_locked(self) -> None:
        while len(self._revs) > self.max_revisions or (
            self._bytes > self.max_bytes and len(self._revs) > 1
        ):
            _, sh = self._revs.popitem(last=False)
            self._bytes -= self._shard_bytes(sh)
            self._entries -= len(sh["c"]) + len(sh["r"])
            self._m.inc("cache.evicted_revisions")
        if self._bytes > self.max_bytes and self._revs:
            # a single over-budget shard: shed half its columnar
            # snapshot (arrays replaced wholesale — concurrent readers
            # keep their reference) and its oldest rel entries
            sh = next(iter(self._revs.values()))
            c = sh["c"]
            ck, cv = c.snap
            drop = len(c.extra) + ck.shape[0] // 2
            if drop:
                c.extra = {}
                half = ck.shape[0] // 2
                c.snap = (  # one atomic publish — see _ColShard
                    np.ascontiguousarray(ck[half:]),
                    np.ascontiguousarray(cv[half:]),
                )
                self._bytes -= drop * self.COL_ENTRY_BYTES
                self._entries -= drop
            d = sh["r"]
            it = iter(list(d))
            while self._bytes > self.max_bytes and d:
                d.pop(next(it), None)
                self._bytes -= self.REL_ENTRY_BYTES
                self._entries -= 1

    @classmethod
    def _shard_bytes(cls, sh) -> int:
        return (len(sh["c"]) * cls.COL_ENTRY_BYTES
                + len(sh["r"]) * cls.REL_ENTRY_BYTES)

    def _publish_locked(self) -> None:
        self._m.set_gauge("cache.bytes", self._bytes)
        self._m.set_gauge("cache.entries", self._entries)
        self._m.set_gauge("cache.revisions", len(self._revs))

    # -- columnar surface ------------------------------------------------
    # Columnar entries store ``(now_us << 1) | verdict`` as int64: the
    # bulk lookup probes the shard's sorted snapshot with searchsorted
    # (pure C, no per-row interpreter frames) and only the residual
    # misses touch the insert dict.

    def lookup_cols(self, revision: int, keys) -> Optional[np.ndarray]:
        """Bulk lookup of packed columnar keys at one revision: an int64
        array of encoded entries with -1 at misses, or None when the
        revision has no shard at all (the common cold case, returned
        cheaply).  Decode: ``verdict = arr & 1``, ``now_us = arr >> 1``.
        Fires the ``cache.lookup`` chaos site before touching state."""
        faults.fire("cache.lookup")
        sh = self._shard(revision, create=False)
        n = len(keys)
        if sh is None:
            self._m.inc("cache.misses", n)
            return None
        c = sh["c"]
        if isinstance(keys, np.ndarray) and not c.tuple_mode:
            out = np.full(n, -1, np.int64)
            ck, cv = c.snap  # ONE attribute read → never a torn pair
            if ck.shape[0]:
                pos = np.minimum(
                    np.searchsorted(ck, keys), ck.shape[0] - 1
                )
                hit = ck[pos] == keys
                out[hit] = cv[pos[hit]]
            if c.extra:
                miss = np.nonzero(out < 0)[0]
                if miss.size:
                    import itertools

                    out[miss] = np.fromiter(
                        map(c.extra.get, keys[miss].tolist(),
                            itertools.repeat(-1)),
                        np.int64, count=miss.size,
                    )
        else:
            import itertools

            out = np.fromiter(
                map(c.extra.get, keys_list(keys), itertools.repeat(-1)),
                np.int64, count=n,
            )
        nh = int((out >= 0).sum())
        if nh:
            self._m.inc("cache.hits", nh)
        if nh != n:
            self._m.inc("cache.misses", n - nh)
        return out

    def get_col(self, revision: int, key) -> Optional[tuple]:
        """One decoded columnar entry — (verdict, now_us) or None
        (tests/introspection; the serving path uses lookup_cols)."""
        sh = self._shard(revision, create=False)
        if sh is None:
            return None
        c = sh["c"]
        v = c.extra.get(key)
        ck, cv = c.snap
        if v is None and isinstance(key, int) and ck.shape[0]:
            p = int(np.searchsorted(ck, key))
            if p < ck.shape[0] and int(ck[p]) == key:
                v = int(cv[p])
        if v is None:
            return None
        return (bool(v & 1), v >> 1)

    def _shard_for_insert_locked(self, revision: int):
        """Resolve-or-create the shard UNDER the already-held lock: a
        separate resolve-then-relock would let a concurrent eviction pop
        the shard in between, and the insert would then account bytes
        into an orphan no eviction can ever reclaim."""
        sh = self._revs.get(revision)
        if sh is None:
            sh = {"c": _ColShard(), "r": {}}
            self._revs[revision] = sh
        else:
            self._revs.move_to_end(revision)
        return sh

    def insert_cols(self, revision: int, keys, verdicts, now_us: int) -> None:
        """Insert verdicts for packed columnar keys (all cacheable: the
        columnar path carries no live query context by construction;
        time-gated verdicts pin ``now_us`` on the entry)."""
        kl = keys_list(keys)
        if not kl:
            return
        enc_t = (int(now_us) << 1) | 1
        enc_f = int(now_us) << 1
        with self._lock:
            c = self._shard_for_insert_locked(revision)["c"]
            if kl and not isinstance(kl[0], int):
                c.tuple_mode = True
            before = len(c.extra)
            d = c.extra
            for k, v in zip(kl, verdicts):
                if k not in d:
                    d[k] = enc_t if v else enc_f
            new = len(d) - before
            if new:
                c.maybe_rebuild()
                self._bytes += new * self.COL_ENTRY_BYTES
                self._entries += new
                self._m.inc("cache.puts", new)
                self._evict_locked()
                self._publish_locked()

    # -- relationship surface --------------------------------------------
    def lookup_rels(self, revision: int, keys: Sequence[Optional[tuple]]):
        """Bulk lookup of relationship keys; a None key marks an item
        that must bypass the cache (live query context) and is counted
        as a bypass, not a miss."""
        faults.fire("cache.lookup")
        sh = self._shard(revision, create=False)
        nby = sum(1 for k in keys if k is None)
        if nby:
            self._m.inc("cache.bypass", nby)
        if sh is None:
            self._m.inc("cache.misses", len(keys) - nby)
            return [None] * len(keys)
        g = sh["r"].get
        vals = [None if k is None else g(k) for k in keys]
        nh = sum(1 for v in vals if v is not None)
        if nh:
            self._m.inc("cache.hits", nh)
        miss = len(keys) - nby - nh
        if miss:
            self._m.inc("cache.misses", miss)
        return vals

    def insert_rels(self, revision: int, items, now_us: int) -> None:
        """Insert (key, verdict) pairs; keys are ``rel_key`` tuples the
        caller already vetted as cacheable (no live query context)."""
        if not items:
            return
        with self._lock:
            d = self._shard_for_insert_locked(revision)["r"]
            new = 0
            for k, v in items:
                if k not in d:
                    d[k] = (bool(v), now_us)
                    new += 1
            if new:
                self._bytes += new * self.REL_ENTRY_BYTES
                self._entries += new
                self._m.inc("cache.puts", new)
                self._evict_locked()
                self._publish_locked()

    def peek_rel(self, revision: int, key) -> Optional[tuple]:
        """Metric-free single-key probe: the explain surface records
        whether a verdict WOULD have been cache-served (provenance)
        without polluting hit/miss counters, firing the chaos site, or
        refreshing the shard's LRU position."""
        with self._lock:
            sh = self._revs.get(revision)
        if sh is None:
            return None
        return sh["r"].get(key)

    # -- lifecycle / introspection ---------------------------------------
    def set_max_bytes(self, max_bytes: int) -> None:
        """Resize the byte budget at runtime — the online tuner's cache
        knob (tune/controller.py).  Shrinking evicts immediately under
        the lock (LRU revision first, same path as insert pressure);
        growing just raises the ceiling and later inserts fill it.
        Concurrent readers are untouched either way — eviction drops
        whole shard objects, never mutates one."""
        with self._lock:
            self.max_bytes = int(max_bytes)
            self._evict_locked()
            self._publish_locked()

    def drop_revision(self, revision: int) -> None:
        """Structural invalidation hook: when the client's dsnap LRU
        evicts a prepared revision, the matching verdict shard drops
        with it (a no-longer-resident revision will not be read again
        by pinned readers — they get PreconditionFailed upstream)."""
        self.drop_revisions((revision,))

    def drop_revisions(self, revisions: Iterable[int]) -> None:
        """Batched structural invalidation — ONE lock acquisition and one
        gauge publish for a whole set of retired revisions.  This is the
        group-commit shape: a committed group retires every evicted /
        non-resident generation it superseded in one call (client dsnap
        LRU, fleet/replica.py serving advance) instead of a
        lock-acquire-per-write storm.  Counts one
        ``cache.group_invalidations`` per call that dropped > 1 shard."""
        with self._lock:
            dropped = 0
            for revision in revisions:
                sh = self._revs.pop(revision, None)
                if sh is not None:
                    self._bytes -= self._shard_bytes(sh)
                    self._entries -= len(sh["c"]) + len(sh["r"])
                    dropped += 1
            if dropped:
                if dropped > 1:
                    self._m.inc("cache.group_invalidations")
                self._publish_locked()

    def clear(self) -> None:
        with self._lock:
            self._revs.clear()
            self._bytes = 0
            self._entries = 0
            self._publish_locked()

    @property
    def resident_revisions(self) -> List[int]:
        with self._lock:
            return list(self._revs)

    def residency(self) -> Dict[str, Any]:
        """The revision-shard residency report a fleet replica publishes
        (fleet/replica.py health): which revisions hold warm verdicts
        here, and the freshest of them — the router's resident-revision
        placement reads the store's generations for correctness and this
        for cache-affinity visibility."""
        with self._lock:
            revs = sorted(self._revs)
        return {
            "revisions": revs,
            "freshest": revs[-1] if revs else None,
            "entries": self._entries,
        }

    def stats(self) -> Dict[str, Any]:
        """Cheap state dump (smokes, tests)."""
        m = self._m
        hits = m.counter("cache.hits")
        misses = m.counter("cache.misses")
        with self._lock:
            return {
                "bytes": self._bytes,
                "entries": self._entries,
                "revisions": list(self._revs),
                "max_bytes": self.max_bytes,
                "hits": hits,
                "misses": misses,
                "bypass": m.counter("cache.bypass"),
                "puts": m.counter("cache.puts"),
                "hit_rate": round(hits / (hits + misses), 4)
                if (hits + misses) else 0.0,
            }


# ---------------------------------------------------------------------------
# Cross-batch singleflight (the dispatch window)
# ---------------------------------------------------------------------------


class Singleflight:
    """One open dispatch window at a time: while a formed batch's checks
    run on the device, its keys are held here; a submission whose rows
    ALL duplicate in-flight keys parks on the window (no queue slot, no
    tier lane) and resolves when the batch settles.

    Columnar windows hold the batch's keys SORTED (one np.sort at open
    — which also yields the unique-work count the occupancy metrics
    want) so the submit-path probe is a scalar bisect and a full park
    attempt is one vectorized searchsorted; the row mapping (argsort)
    is computed lazily on the first successful park.  Relationship
    windows (the low-rate path) use a plain dict.

    ``active``/``probe`` are read lock-free on the submit path (a stale
    answer just means one missed parking opportunity — never a wrong
    answer); parking and settling are locked.  The owner (the serving
    dispatcher) guarantees open → close pairing: ``close`` fans the
    batch's verdicts out to every parked future, or rejects them
    RETRIABLE on batch failure (the parked submitters' envelopes
    re-submit — they were not at fault)."""

    def __init__(self, registry: Optional[_metrics.Metrics] = None) -> None:
        self._lock = threading.Lock()
        self._sorted: Optional[np.ndarray] = None  # cols window
        self._raw: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None  # lazy argsort of _raw
        self._map: Optional[Dict[Any, int]] = None  # rels window
        self._parked: List[tuple] = []
        self._active = False
        self._m = registry or _metrics.default

    @property
    def active(self) -> bool:
        return self._active

    def open_cols(self, keys: np.ndarray, keys_sorted: np.ndarray) -> None:
        """Open a columnar window: ``keys`` in batch-row order plus the
        caller's sorted copy (the dispatcher sorts once for its
        unique-work metric anyway)."""
        with self._lock:
            self._raw = keys
            self._sorted = keys_sorted
            self._order = None
            self._map = None
            self._parked = []
            self._active = True

    def open_map(self, key_to_row: Dict[Any, int]) -> None:
        """Open a relationship window (key → batch row index)."""
        with self._lock:
            self._map = key_to_row
            self._raw = self._sorted = self._order = None
            self._parked = []
            self._active = True

    def probe(self, key) -> bool:
        """Lock-free scalar probe: could this key be in flight?  False
        rules parking out without any per-row work (the common case);
        True is only a hint — try_park re-checks under the lock."""
        if not self._active:
            return False
        ks = self._sorted
        if ks is not None:
            if not isinstance(key, int) or not ks.shape[0]:
                return False
            p = int(np.searchsorted(ks, key))
            return p < ks.shape[0] and int(ks[p]) == key
        km = self._map
        return km is not None and key in km

    def try_park(self, keys, future, kind: str, n: int) -> bool:
        """Park a whole submission on the open window iff EVERY row
        duplicates an in-flight key.  Partial overlap queues normally
        (the overlapping rows become cache hits one batch later)."""
        with self._lock:
            if not self._active:
                return False
            if self._sorted is not None:
                if not isinstance(keys, np.ndarray):
                    return False
                pos = np.minimum(
                    np.searchsorted(self._sorted, keys),
                    self._sorted.shape[0] - 1,
                )
                if not (self._sorted[pos] == keys).all():
                    return False
                if self._order is None:
                    self._order = np.argsort(self._raw, kind="stable")
                rows = self._order[pos]
            else:
                g = self._map.get
                rows = []
                for k in keys_list(keys):
                    i = g(k)
                    if i is None:
                        return False
                    rows.append(i)
            self._parked.append((rows, future, kind, n))
        self._m.inc("serve.dedup_parked", n)
        return True

    def close(self, verdicts, error: Optional[BaseException],
              t_done: float) -> int:
        """Settle the window: resolve every parked future from the
        batch's verdicts (or reject retriable on ``error``).  Returns
        the number of parked submissions settled."""
        with self._lock:
            if not self._active:
                return 0
            parked, self._parked = self._parked, []
            self._raw = self._sorted = self._order = self._map = None
            self._active = False
        from ..utils.errors import UnavailableError

        m = self._m
        for rows, fut, kind, n in parked:
            if fut.done():
                continue
            if error is not None or verdicts is None:
                fut._reject(UnavailableError(
                    "deduplicated twin's batch failed; re-submit"
                ), t_done)
                continue
            if kind == "cols":
                out = np.asarray(verdicts, bool)[np.asarray(rows, np.int64)]
            else:
                out = [bool(verdicts[i]) for i in rows]
            fut._resolve(out, t_done)
            m.inc("serve.checks", n)
            m.observe("serve.request_s", t_done - fut.t_submit)
        return len(parked)
