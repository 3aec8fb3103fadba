"""The Client: the gochugaru Check surface backed by the PyTorch engine.

A reduced counterpart of the reference package's ``client.py``: schema
read/write, transactional writes, bulk import, the Check family
(``check``/``check_one``/``check_any``/``check_all``) and the lookups
(``lookup_resources``/``lookup_subjects`` and their cursor-paged
``*_page`` forms) under the four consistency strategies.  Check
resolution is a two-tier cascade:

1. **Device**: one flat-kernel dispatch for the batch (engine/device.py);
   definite answers return immediately.
2. **Host oracle** for the rows the device flagged: possible-but-not-
   definite results and static-cap overflows.

Lookups expand candidates on the device over the reverse-CSR tables
(engine/spmv.py) and filter them exactly with the same cascade
(engine/lookup.py).

The engine runs on ``cuda`` unless ``new_evaluator(device="cpu")`` asks
for the CPU; with no CUDA device and no explicit device the constructor
raises.
"""

from __future__ import annotations

import threading
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple,
)

from .consistency import Strategy
from .engine.device import DeviceEngine, DeviceSnapshot, resolve_device
from .engine.oracle import Oracle, SnapshotOracle, T
from .engine.plan import EngineConfig
from .rel.relationship import Relationship, RelationshipLike, as_relationship
from .rel.strings import parse_object_set, parse_typed_relation
from .rel.txn import Txn
from .store.snapshot import Snapshot
from .store.store import Store
from .utils import metrics as _metrics
from .utils.context import Context
from .utils.errors import (
    AlreadyExistsError, BulkCheckItemError, PreconditionFailedError,
)
from .utils.retry import retry_retriable_errors

#: relationships accumulated per store flush by import_relationships
IMPORT_BUFFER = 2_097_152


class LookupPage(NamedTuple):
    """One page of a cursored lookup (lookup_resources_page /
    lookup_subjects_page): result ids in stable stream order, plus the
    opaque resume cursor (None = stream exhausted)."""

    ids: List[str]
    cursor: Optional[str]


class _Options:
    def __init__(self) -> None:
        self.engine_config: Optional[EngineConfig] = None


Option = Callable[[_Options], None]


def with_engine_config(cfg: EngineConfig) -> Option:
    """Override the engine's static caps (engine/plan.py)."""

    def opt(o: _Options) -> None:
        o.engine_config = cfg

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
        self._engine_config = o.engine_config
        self._lock = threading.Lock()
        self._engine: Optional[DeviceEngine] = None
        self._engine_schema = None
        self._dsnap_cache: Dict[int, DeviceSnapshot] = {}
        self._oracle_cache: Dict[int, Oracle] = {}
        self._metrics = _metrics.default

    @property
    def store(self) -> Store:
        return self._store

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

    # -- the Check family ------------------------------------------------
    def check_one(self, ctx: Context, cs: Strategy, r: RelationshipLike) -> bool:
        return self.check(ctx, cs, r)[0]

    def check_any(self, ctx: Context, cs: Strategy, *rs: RelationshipLike) -> bool:
        return any(self.check(ctx, cs, *rs))

    def check_all(self, ctx: Context, cs: Strategy, *rs: RelationshipLike) -> bool:
        return all(self.check(ctx, cs, *rs))

    def check(
        self, ctx: Context, cs: Strategy, *rs: RelationshipLike
    ) -> List[bool]:
        """Batched permission check: one device dispatch at the snapshot
        the strategy selects, host-oracle resolution for flagged rows,
        under the retry envelope."""
        rels = [as_relationship(r) for r in rs]
        if not rels:
            return []
        self._metrics.inc("checks.requested", len(rels))
        return retry_retriable_errors(
            ctx, lambda: self._evaluate(self._store.snapshot_for(cs), rels)
        )

    def _evaluate(self, snap: Snapshot, rels: List[Relationship]) -> List[bool]:
        engine = self._engine_for(snap)
        dsnap = self._dsnap_for(engine, snap)
        d, p, ovf = engine.check_batch(dsnap, rels)
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
