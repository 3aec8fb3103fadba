"""The Client: the gochugaru Check surface backed by the PyTorch engine.

The counterpart of the reference package's ``client.py``: schema
read/write, transactional writes, reads and deletes by filter, the Watch
stream (``updates``/``updates_since_revision``, resumable exactly once),
bulk import and export (relationships, string columns, interned id
columns), the Check family (``check``/``check_one``/``check_any``/
``check_all``/``check_iter``) and the lookups (``lookup_resources``/
``lookup_subjects`` and their cursor-paged ``*_page`` forms) under the
four consistency strategies, with the reference's overlap-key guard
(``with_overlap_required``) on the same methods.  Check resolution is a
two-tier cascade:

1. **Device**: one dispatch for the batch (engine/device.py: the flat
   program, or the legacy two-phase program for the batches it cannot
   serve; with ``with_latency_mode`` small batches replay a pinned CUDA
   graph at a batch tier, engine/latency.py); definite answers return
   immediately.
2. **Host oracle** for the rows the device flagged: possible-but-not-
   definite results and static-cap overflows.

Every check dispatch runs under the admission controller
(utils/admission.py): a deadline-budget shed, a bounded in-flight gate,
and the circuit breaker that reroutes latency-mode traffic to the batch
path after consecutive transient failures (``with_admission_control``).

Lookups expand candidates on the device over the reverse-CSR tables
(engine/spmv.py) and filter them exactly with the same cascade
(engine/lookup.py).

The engine runs on ``cuda`` unless ``new_evaluator(device="cpu")`` asks
for the CPU; with no CUDA device and no explicit device the constructor
raises.
"""

from __future__ import annotations

import dataclasses as _dataclasses
import threading
import time as _time
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional,
    Sequence, Tuple,
)

from .consistency import OVERLAP_KEY, Strategy
from .engine.device import DeviceEngine, DeviceSnapshot, resolve_device
from .engine.oracle import Oracle, SnapshotOracle, T
from .engine.plan import EngineConfig
from .rel.filter import Filter, PreconditionedFilter
from .rel.relationship import Relationship, RelationshipLike, as_relationship
from .rel.strings import parse_object_set, parse_typed_relation
from .rel.txn import Txn
from .rel.update import Update, UpdateFilter
from .store.snapshot import Snapshot
from .store.store import Store, parse_revision
from .utils import faults
from .utils import metrics as _metrics
from .utils import trace as _trace
from .utils.admission import AdmissionConfig, AdmissionController
from .utils.context import Context
from .utils.errors import (
    AlreadyExistsError, BulkCheckItemError, OverlapKeyMissingError,
    PartialDeletionError, PreconditionFailedError, UnavailableError,
    classify_dispatch_exception,
)
from .utils.retry import retry_retriable_errors

#: Batch/page sizes of the reference's wire tuning
#: (client/client.go:166,295,348,448)
CHECK_CHUNK = 1000
READ_PAGE = 512
DELETE_BATCH = 10_000
#: relationships accumulated per store flush by import_relationships
IMPORT_BUFFER = 2_097_152


@_dataclasses.dataclass(frozen=True)
class WatchConfig:
    """Tuning for ``updates`` / ``updates_since_revision`` subscriptions:
    the interactive-subscriber defaults; a replica tailing a busy stream
    raises both budgets."""

    #: consecutive no-progress resumes before the stream surfaces the
    #: UnavailableError to its consumer
    max_resumes: int = 64
    #: consecutive no-progress resumes that fire the
    #: ``watch.resume_storm`` incident (carrying the stream cursor)
    storm_resumes: int = 8
    #: store poll cadence while the stream is idle
    poll_interval: float = 0.05


class LookupPage(NamedTuple):
    """One page of a cursored lookup (lookup_resources_page /
    lookup_subjects_page): result ids in stable stream order, plus the
    opaque resume cursor (None = stream exhausted)."""

    ids: List[str]
    cursor: Optional[str]


class _Options:
    def __init__(self) -> None:
        self.overlap_required = False
        self.engine_config: Optional[EngineConfig] = None
        self.latency_mode = False
        self.admission: Optional[AdmissionConfig] = None


Option = Callable[[_Options], None]


def with_overlap_required() -> Option:
    """Raise if a request lacks an overlap key (the reference panics,
    client/client.go:84-86,182-191)."""

    def opt(o: _Options) -> None:
        o.overlap_required = True

    return opt


def with_engine_config(cfg: EngineConfig) -> Option:
    """Override the engine's static caps (engine/plan.py)."""

    def opt(o: _Options) -> None:
        o.engine_config = cfg

    return opt


def with_latency_mode() -> Option:
    """Route interactive-sized Check batches through the latency-mode
    path (engine/latency.py): the flat program pinned as a CUDA graph per
    batch tier over static buffers, replayed per dispatch, with a
    per-stage budget published as ``latency.*`` metrics with live
    p50/p99.  Batches the path cannot serve (beyond the top tier, too
    many distinct permissions, no flat tables) take the throughput path
    transparently."""

    def opt(o: _Options) -> None:
        o.latency_mode = True

    return opt


def with_admission_control(config: AdmissionConfig) -> Option:
    """Tune the dispatch admission controller (utils/admission.py): the
    bounded in-flight gate, the deadline-budget shed, and the latency-path
    circuit breaker.  Admission is ON by default with generous limits;
    this option tightens or disables it (``max_inflight=0`` no gate,
    ``breaker_threshold=0`` no breaker, ``deadline_shed=False`` no
    deadline-budget shedding)."""

    def opt(o: _Options) -> None:
        o.admission = config

    return opt


class Client:
    """An in-process authorization client with the gochugaru Check
    surface, evaluating on a torch device."""

    #: prepared-snapshot / oracle cache capacity per client
    SNAPSHOT_CACHE_MAX = 4

    def __init__(self, *opts: Option, device=None) -> None:
        o = _Options()
        for opt in opts:
            opt(o)
        self.device = resolve_device(device)
        self._store = Store()
        self._overlap_required = o.overlap_required
        self._engine_config = o.engine_config
        self._lock = threading.Lock()
        self._engine: Optional[DeviceEngine] = None
        self._engine_schema = None
        self._dsnap_cache: Dict[int, DeviceSnapshot] = {}
        self._oracle_cache: Dict[int, Oracle] = {}
        self._metrics = _metrics.default
        self._latency_mode = o.latency_mode
        #: the gate, the deadline budget and the latency-path breaker
        self._admission = AdmissionController(o.admission)

    @property
    def store(self) -> Store:
        return self._store

    # -- overlap guard (client/client.go:182-191) ------------------------
    def _check_overlap(self, ctx: Context) -> None:
        if self._overlap_required and ctx.value(OVERLAP_KEY) is None:
            raise OverlapKeyMissingError()

    # -- engine / oracle plumbing ----------------------------------------
    def _engine_for(self, snap: Snapshot) -> DeviceEngine:
        with self._lock:
            if self._engine is None or self._engine_schema is not snap.compiled:
                self._engine = DeviceEngine(
                    snap.compiled, self._engine_config, device=self.device
                )
                self._engine_schema = snap.compiled
                self._dsnap_cache.clear()
            return self._engine

    @staticmethod
    def _lru_get(cache: Dict[int, Any], key: int):
        """LRU access: move the hit to the back (dicts preserve order)."""
        v = cache.pop(key, None)
        if v is not None:
            cache[key] = v
        return v

    @classmethod
    def _lru_put(cls, cache: Dict[int, Any], key: int, v: Any) -> None:
        cache[key] = v
        while len(cache) > cls.SNAPSHOT_CACHE_MAX:
            cache.pop(next(iter(cache)))

    def _dsnap_for(self, engine: DeviceEngine, snap: Snapshot) -> DeviceSnapshot:
        with self._lock:
            ds = self._dsnap_cache.pop(snap.revision, None)
            if ds is None or (
                ds.snapshot is not snap
                and getattr(ds, "source_snapshot", None) is not snap
            ):
                # incremental prepare when the previous revision is still
                # resident: base tables stay on the device, only the delta
                # overlay ships (engine/device.py _prepare_delta)
                di = getattr(snap, "delta_info", None)
                prev = (
                    self._dsnap_cache.get(di.prev_revision)
                    if di is not None
                    else None
                )
                ds = engine.prepare(snap, prev=prev)
            self._lru_put(self._dsnap_cache, snap.revision, ds)
            return ds

    def _oracle_for(self, snap: Snapshot) -> Oracle:
        with self._lock:
            o = self._oracle_cache.pop(snap.revision, None)
            if o is None or o.snapshot is not snap:
                o = SnapshotOracle(
                    snap,
                    {
                        name: self._store.caveat_program(name)
                        for name in snap.compiled.schema.caveats
                    },
                )
            self._lru_put(self._oracle_cache, snap.revision, o)
            return o

    # -- schema ----------------------------------------------------------
    def read_schema(self, ctx: Context) -> Tuple[str, str]:
        """The current schema and its revision."""
        return self._store.read_schema()

    def write_schema(self, ctx: Context, schema: str) -> str:
        """Apply the schema; returns the revision it was written at."""
        return self._store.write_schema(schema)

    # -- writes ----------------------------------------------------------
    def write(self, ctx: Context, txn: Txn) -> str:
        """Atomically perform a transaction; returns its revision."""
        return self._store.write(txn)

    def import_relationships(
        self, ctx: Context, rs: Iterable[RelationshipLike]
    ) -> None:
        """Bulk restore; a batch that already exists is re-imported as
        TOUCH under the retry envelope."""
        chunk: List[Relationship] = []

        def flush() -> None:
            if not chunk:
                return
            try:
                self._store.import_relationships(chunk)
            except AlreadyExistsError:
                retry_retriable_errors(
                    ctx,
                    lambda: self._store.import_relationships(chunk, touch=True),
                )
            chunk.clear()

        for r in rs:
            chunk.append(as_relationship(r))
            if len(chunk) >= IMPORT_BUFFER:
                flush()
        flush()

    def import_relationship_columns(
        self,
        ctx: Context,
        *,
        resource_type: str,
        resource_ids: Sequence[str],
        resource_relation: str,
        subject_type: str,
        subject_ids: Sequence[str],
        subject_relation: str = "",
    ) -> None:
        """Columnar bulk restore: one relationship shape, ids as parallel
        string columns (no per-edge objects).  A batch that already
        exists is re-imported as TOUCH under the retry envelope
        (client/client.go:448-463)."""
        self._check_overlap(ctx)
        kw = dict(
            resource_type=resource_type, resource_ids=resource_ids,
            resource_relation=resource_relation,
            subject_type=subject_type, subject_ids=subject_ids,
            subject_relation=subject_relation,
        )
        try:
            self._store.import_columns(**kw)
        except AlreadyExistsError:
            retry_retriable_errors(
                ctx, lambda: self._store.import_columns(**kw, touch=True)
            )

    def import_relationship_id_columns(
        self,
        ctx: Context,
        *,
        resource_ids,
        resource_relation: str,
        subject_ids,
        subject_relation: str = "",
    ) -> None:
        """Pre-interned columnar bulk restore: int node-id columns from
        THIS store's interner (``export_relationship_id_columns``
        chunks).  Rows may mix resource/subject types.  A batch that
        already exists is re-imported as TOUCH under the retry
        envelope."""
        self._check_overlap(ctx)
        kw = dict(
            resource_ids=resource_ids, resource_relation=resource_relation,
            subject_ids=subject_ids, subject_relation=subject_relation,
        )
        try:
            self._store.import_interned_columns(**kw)
        except AlreadyExistsError:
            retry_retriable_errors(
                ctx,
                lambda: self._store.import_interned_columns(**kw, touch=True),
            )

    def export_relationships(
        self, ctx: Context, revision: str
    ) -> Iterator[Relationship]:
        """Stream every relationship at an exact revision — the backup
        half of backup/restore (client/client.go:467-499).  Cancellation
        is honored every READ_PAGE rows."""
        self._check_overlap(ctx)
        count = 0
        for r in self._store.export_at(revision):
            if count % READ_PAGE == 0:
                err = ctx.err()
                if err is not None:
                    raise err
            count += 1
            yield r

    def export_relationship_columns(
        self, ctx: Context, revision: str
    ) -> Iterator[Dict[str, list]]:
        """Columnar export at an exact revision: chunks of parallel
        string/value lists, the mirror of
        ``import_relationship_columns``.  Cancellation is honored between
        chunks."""
        self._check_overlap(ctx)
        for chunk in self._store.export_columns_at(revision):
            err = ctx.err()
            if err is not None:
                raise err
            yield chunk

    def export_relationship_id_columns(
        self, ctx: Context, revision: str
    ) -> Iterator[Dict[str, Any]]:
        """Interned columnar export at an exact revision: chunks of int32
        node-id columns (one (relation, subject-relation) shape a chunk),
        the mirror of ``import_relationship_id_columns``.  Cancellation
        is honored between chunks."""
        self._check_overlap(ctx)
        for chunk in self._store.export_interned_columns_at(revision):
            err = ctx.err()
            if err is not None:
                raise err
            yield chunk

    # -- reads (client/client.go:286-315) --------------------------------
    def read_relationships(
        self, ctx: Context, cs: Strategy, f: Filter
    ) -> Iterator[Relationship]:
        """Stream the relationships matching the filter; context
        cancellation is honored at READ_PAGE boundaries."""
        self._check_overlap(ctx)
        count = 0
        for r in self._store.read(cs, f):
            err = ctx.err()
            if err is not None and count % READ_PAGE == 0:
                raise err
            count += 1
            yield r

    # -- deletes (client/client.go:317-358) ------------------------------
    @staticmethod
    def _as_preconditioned(pf) -> PreconditionedFilter:
        """A bare Filter means a PreconditionedFilter with no
        preconditions (the reference's signature takes the latter)."""
        if isinstance(pf, PreconditionedFilter):
            return pf
        if isinstance(pf, Filter):
            return PreconditionedFilter(pf)
        raise TypeError(
            f"expected Filter or PreconditionedFilter, got {type(pf).__name__}"
        )

    def delete_atomic(self, ctx: Context, pf: PreconditionedFilter) -> str:
        """Remove all matching relationships in one transaction; returns
        its revision.  No retry (client/client.go:322)."""
        self._check_overlap(ctx)
        pf = self._as_preconditioned(pf)
        revision, complete = self._store.delete_by_filter(pf, limit=0)
        if not complete:
            raise PartialDeletionError(
                "delete disallowing partial deletion did not complete"
            )
        return revision

    def delete(self, ctx: Context, pf: PreconditionedFilter) -> None:
        """Remove all matching relationships in batches of DELETE_BATCH,
        each under the retry envelope (client/client.go:340-358)."""
        self._check_overlap(ctx)
        pf = self._as_preconditioned(pf)
        while True:
            _, complete = retry_retriable_errors(
                ctx, lambda: self._store.delete_by_filter(pf, limit=DELETE_BATCH)
            )
            if complete:
                return

    # -- Watch (client/client.go:360-413) --------------------------------
    def updates(
        self, ctx: Context, f: UpdateFilter,
        config: Optional[WatchConfig] = None,
    ) -> Iterator[Update]:
        """Subscribe from the current head (``updates_since_revision``
        with no cursor)."""
        return self.updates_since_revision(ctx, f, "", config=config)

    #: consecutive no-progress stream faults tolerated before the watch
    #: surfaces the UnavailableError to its consumer
    WATCH_MAX_RESUMES = 64
    #: consecutive no-progress resumes that count as a resume storm
    WATCH_STORM_RESUMES = 8

    def updates_since_revision(
        self, ctx: Context, f: UpdateFilter, revision: str,
        *, config: Optional[WatchConfig] = None,
    ) -> Iterator[Update]:
        """Ordered, filtered, resumable updates after ``revision`` (from
        the head when empty); cancel through the context
        (client/client.go:394-411).

        A transient stream failure (``UnavailableError`` from the store
        or the ``watch.stream`` fault site) does not reach the consumer:
        the subscription resumes from the last delivered cursor, exactly
        once — (last fully delivered revision, raw updates delivered of
        the partially delivered one), tracked before the filter so a
        filtered stream resumes at the right raw position; a redelivered
        prefix is skipped.  Each resume counts ``watch.resumes``;
        ``storm_resumes`` consecutive ones without progress fire the
        ``watch.resume_storm`` incident, and more than ``max_resumes``
        surface the error."""
        self._check_overlap(ctx)
        cfg = config if config is not None else WatchConfig(
            max_resumes=self.WATCH_MAX_RESUMES,
            storm_resumes=self.WATCH_STORM_RESUMES,
        )
        if f.object_types and f.relationship_filters:
            raise ValueError(
                "UpdateFilter.object_types and relationship_filters are mutually"
                " exclusive"
            )
        # no cursor → subscribe from the current head (client/client.go:
        # 379-387); a cursor replays everything after it
        since = parse_revision(revision) if revision else self._store.head_revision
        stop = threading.Event()

        def gen() -> Iterator[Update]:
            # one span per subscription; resumes are its events
            wsp = _trace.root_span("watch", since=int(since))
            base = since  # every revision ≤ base fully delivered
            part_rev: Optional[int] = None  # revision partially delivered
            part_n = 0  # raw updates of part_rev already delivered
            no_progress = 0
            delivered = 0
            try:
                while True:
                    if ctx.done():
                        return
                    skip_rev, to_skip, skipped = part_rev, part_n, 0
                    try:
                        for rev, u in self._store.updates_since(
                            base, stop=stop, poll_interval=cfg.poll_interval,
                            cancelled=ctx.done,
                        ):
                            if ctx.done():
                                return
                            if rev != part_rev:
                                if part_rev is not None:
                                    base = part_rev  # moved past it
                                part_rev, part_n = rev, 0
                            if rev == skip_rev and skipped < to_skip:
                                # redelivered prefix: already consumed
                                skipped += 1
                                continue
                            faults.fire("watch.stream")
                            part_n += 1
                            no_progress = 0
                            if f.admits(u):
                                delivered += 1
                                yield u
                        return  # stream ended: stop set or ctx cancelled
                    except UnavailableError:
                        self._metrics.inc("watch.resumes")
                        wsp.event(
                            "watch.resume", error="UnavailableError",
                            no_progress=no_progress + 1,
                            cursor_rev=int(base), cursor_offset=part_n,
                        )
                        no_progress += 1
                        if no_progress == cfg.storm_resumes:
                            _trace.trigger_incident(
                                "watch.resume_storm",
                                no_progress=no_progress,
                                cursor_rev=int(base),
                                cursor_offset=part_n,
                            )
                        if no_progress > cfg.max_resumes:
                            raise
                        # brief context-aware pause, then re-subscribe
                        # from the (base, part_n) cursor
                        ctx.wait(min(0.002 * no_progress, 0.05))
            finally:
                stop.set()
                wsp.set_attr("delivered", delivered)
                wsp.end()

        return gen()

    # -- the Check family ------------------------------------------------
    def check_one(self, ctx: Context, cs: Strategy, r: RelationshipLike) -> bool:
        return self.check(ctx, cs, r)[0]

    def check_any(self, ctx: Context, cs: Strategy, *rs: RelationshipLike) -> bool:
        return any(self.check(ctx, cs, *rs))

    def check_all(self, ctx: Context, cs: Strategy, *rs: RelationshipLike) -> bool:
        return all(self.check(ctx, cs, *rs))

    def check_iter(
        self,
        ctx: Context,
        cs: Strategy,
        rs: Iterable[RelationshipLike],
        *,
        chunk_size: int = CHECK_CHUNK,
    ) -> Iterator[bool]:
        """Batched streaming checks, ``chunk_size`` a dispatch
        (client/client.go:164-180)."""
        batch: List[RelationshipLike] = []
        for r in rs:
            batch.append(r)
            if len(batch) >= chunk_size:
                yield from self.check(ctx, cs, *batch)
                batch.clear()
        if batch:
            yield from self.check(ctx, cs, *batch)

    def check(
        self, ctx: Context, cs: Strategy, *rs: RelationshipLike
    ) -> List[bool]:
        """Batched permission check: one device dispatch at the snapshot
        the strategy selects, host-oracle resolution for flagged rows,
        under the admission controller and the retry envelope."""
        self._check_overlap(ctx)
        rels = [as_relationship(r) for r in rs]
        if not rels:
            return []
        self._metrics.inc("checks.requested", len(rels))
        return retry_retriable_errors(ctx, lambda: self._admitted(
            ctx, lambda: self._evaluate(self._store.snapshot_for(cs), rels)))

    def _admitted(self, ctx: Context, work):
        """The admission envelope of a device-dispatching request: the
        deadline-budget shed before any device work, the bounded
        in-flight gate around ``work()``, and the cost observation that
        feeds the deadline estimate after."""
        adm = self._admission
        span = _trace.span_of(ctx)
        adm.check_deadline(ctx, span=span)
        t_disp = _time.perf_counter()
        with adm.gate.admit(span=span):
            out = work()
        adm.observe_cost(_time.perf_counter() - t_disp)
        return out

    def _evaluate(self, snap: Snapshot, rels: List[Relationship]) -> List[bool]:
        """One device dispatch with classified failures feeding the
        circuit breaker, then host-oracle resolution of flagged rows."""
        adm = self._admission
        engine = self._engine_for(snap)
        dsnap = self._dsnap_for(engine, snap)
        # the breaker: after consecutive transient dispatch failures,
        # latency-mode traffic reroutes onto the batch path until it
        # half-opens a probe
        latency = self._latency_mode
        use_latency = latency and adm.breaker.allow_latency()
        if latency and not use_latency:
            self._metrics.inc("breaker.latency_rerouted")
        # a latency-mode call may fall back to the batch path (a batch
        # beyond the top tier, no flat tables): only a dispatch the
        # latency path SERVED is a probe that may close the breaker
        lp = engine.latency_path(dsnap) if use_latency else None
        lp_n = lp.dispatch_count if lp is not None else 0
        try:
            d, p, ovf = engine.check_batch(dsnap, rels, latency=use_latency)
        except Exception as e:  # classify device dispatch failures
            classified = classify_dispatch_exception(e)
            if isinstance(classified, UnavailableError):
                adm.breaker.record_failure()
                if classified is e:
                    raise
                raise classified from e
            raise
        adm.breaker.record_success(
            probe=lp is not None and lp.dispatch_count > lp_n)
        needs_host = (p & ~d) | ovf
        if not needs_host.any():
            self._metrics.inc("checks.device_definite", len(rels))
            return [bool(x) for x in d]
        oracle = self._oracle_for(snap)
        out: List[bool] = []
        for i, r in enumerate(rels):
            if not needs_host[i]:
                out.append(bool(d[i]))
                continue
            self._metrics.inc(
                "checks.fallback_overflow" if ovf[i]
                else "checks.fallback_conditional"
            )
            try:
                out.append(oracle.check_relationship(r) == T)
            except Exception as e:
                # per-item error: abort with the partial results, as the
                # reference's bulk mapping loop does
                raise BulkCheckItemError(i, out, e) from e
        return out

    # -- lookups (client/client.go:501-599) ------------------------------
    def lookup_resources(
        self, ctx: Context, cs: Strategy, permission: str, subject: str
    ) -> Iterator[str]:
        """Stream resource IDs the subject can access, sorted.
        ``permission`` = "type#perm", ``subject`` = "type:id[#rel]"
        (client/client.go:501-552).

        Device frontier over the reverse-CSR tables (engine/spmv.py) +
        batched exact forward checks.  Transient dispatch faults
        (``lookup.dispatch`` site) retry under the reference's backoff
        envelope like checks do."""
        from .engine.lookup import lookup_resources_device

        self._check_overlap(ctx)
        subj_type, subj_id, subj_rel = parse_object_set(subject)
        obj_type, obj_rel = parse_typed_relation(permission)
        snap = self._store.snapshot_for(cs)
        engine = self._engine_for(snap)
        self._metrics.inc("lookups.resources_device")
        ids = retry_retriable_errors(
            ctx,
            lambda: lookup_resources_device(
                engine, self._dsnap_for(engine, snap),
                obj_type, obj_rel, subj_type, subj_id, subj_rel,
                oracle_factory=lambda: self._oracle_for(snap),
            ),
        )
        for rid in ids:
            err = ctx.err()
            if err is not None:
                raise err
            yield rid

    def lookup_subjects(
        self, ctx: Context, cs: Strategy, resource: str, permission: str,
        subject: str,
    ) -> Iterator[str]:
        """Stream subject IDs holding the permission on the resource,
        sorted.  ``resource`` = "type:id", ``subject`` = "type[#rel]"
        (client/client.go:554-599)."""
        from .engine.lookup import lookup_subjects_device

        self._check_overlap(ctx)
        res_type, res_id, _ = parse_object_set(resource)
        subj_type, _, subj_rel = subject.partition("#")
        snap = self._store.snapshot_for(cs)
        engine = self._engine_for(snap)
        self._metrics.inc("lookups.subjects_device")
        ids = retry_retriable_errors(
            ctx,
            lambda: lookup_subjects_device(
                engine, self._dsnap_for(engine, snap),
                res_type, res_id, permission, subj_type, subj_rel,
                oracle_factory=lambda: self._oracle_for(snap),
            ),
        )
        for sid in ids:
            err = ctx.err()
            if err is not None:
                raise err
            yield sid

    def lookup_resources_page(
        self, ctx: Context, cs: Strategy, permission: str, subject: str,
        *, page_size: int = 1_000, cursor: Optional[str] = None,
    ) -> LookupPage:
        """One cursor-paginated page of LookupResources.  Results arrive
        in stable discovery order as the frontier expands, so the first
        page of a huge answer returns before the fixpoint completes; the
        returned ``cursor`` is revision-pinned and resumes EXACTLY (no
        duplicate or lost IDs), as long as the pinned revision's prepared
        snapshot is still resident (``PreconditionFailedError``
        otherwise)."""
        from .engine.lookup import lookup_resources_page as page

        self._check_overlap(ctx)
        subj_type, subj_id, subj_rel = parse_object_set(subject)
        obj_type, obj_rel = parse_typed_relation(permission)

        def run_page(engine, dsnap, snap, cur):
            return page(
                engine, dsnap, obj_type, obj_rel, subj_type, subj_id,
                subj_rel, page_size=page_size, cursor=cur,
                oracle_factory=lambda: self._oracle_for(snap),
            )

        return self._lookup_page(ctx, cs, cursor, "lookup_resources_page",
                                 run_page)

    def lookup_subjects_page(
        self, ctx: Context, cs: Strategy, resource: str, permission: str,
        subject: str, *, page_size: int = 1_000,
        cursor: Optional[str] = None,
    ) -> LookupPage:
        """One cursor-paginated page of LookupSubjects (see
        lookup_resources_page for the cursor contract)."""
        from .engine.lookup import lookup_subjects_page as page

        self._check_overlap(ctx)
        res_type, res_id, _ = parse_object_set(resource)
        subj_type, _, subj_rel = subject.partition("#")

        def run_page(engine, dsnap, snap, cur):
            return page(
                engine, dsnap, res_type, res_id, permission, subj_type,
                subj_rel, page_size=page_size, cursor=cur,
                oracle_factory=lambda: self._oracle_for(snap),
            )

        return self._lookup_page(ctx, cs, cursor, "lookup_subjects_page",
                                 run_page)

    def _lookup_page(self, ctx, cs, cursor, metric, run_page) -> LookupPage:
        """Shared paged-lookup plumbing: cursor decode + revision pinning
        and the retry envelope around the device dispatch."""
        from .engine.spmv import LookupCursor

        cur = LookupCursor.decode(cursor) if cursor is not None else None
        snap = self._store.snapshot_for(cs)
        if cur is not None and cur.revision != snap.revision:
            # revision-pinned resume: serve from the pinned revision's
            # still-resident prepared snapshot, never silently from a
            # different revision
            with self._lock:
                ds = self._lru_get(self._dsnap_cache, cur.revision)
            if ds is None:
                raise PreconditionFailedError(
                    f"lookup cursor pinned to revision {cur.revision},"
                    " which is no longer resident — restart the lookup"
                )
            snap = ds.source_snapshot or ds.snapshot
        engine = self._engine_for(snap)
        self._metrics.inc(f"lookups.{metric}")
        dsnap = self._dsnap_for(engine, snap)
        ids, nxt = retry_retriable_errors(
            ctx, lambda: run_page(engine, dsnap, snap, cur)
        )
        return LookupPage(ids, nxt.encode() if nxt is not None else None)


def new_evaluator(*opts: Option, device=None) -> Client:
    """A client backed by the PyTorch engine — the counterpart of the
    reference package's ``new_tpu_evaluator``.  ``device`` defaults to
    ``cuda``; pass ``"cpu"`` for the plain PyTorch path on the CPU."""
    return Client(*opts, device=device)


# Go-parity aliases.
WithOverlapRequired = with_overlap_required
WithEngineConfig = with_engine_config
WithLatencyMode = with_latency_mode
WithAdmissionControl = with_admission_control
