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
Above the dispatch sits the evaluate layer of the reference: the
revision-pinned verdict cache (engine/vcache.py, ``with_verdict_cache``)
read and written under each call's consistency strategy, in-batch dedup
for the serving front end (``with_serving``, serve/), and the decision
counters and log (utils/decisions.py, ``with_decision_log``).

Lookups expand candidates on the device over the reverse-CSR tables
(engine/spmv.py) and filter them exactly with the same cascade
(engine/lookup.py).

Decision provenance: ``explain`` and ``check(..., explain=True)``
return typed resolution trees (engine/explain.py), walked on the host
oracle at the verdict's pinned snapshot and seeded by the witness plane
of the flat program (one armed dispatch a batch).

Operations: ``with_telemetry`` serves the metrics, traces, SLO burn,
``/perf`` report and flight-recorder incident bundles over HTTP
(utils/telemetry.py, utils/slo.py, utils/trace.py, utils/perf.py);
``with_profiling`` records a ``torch.profiler`` trace around every
check dispatch; ``with_group_commit`` coalesces concurrent writes into
one log entry a group (store/group.py).

The engine runs on ``cuda`` unless ``new_evaluator(device="cpu")`` asks
for the CPU; with no CUDA device and no explicit device the constructor
raises.  ``with_host_only_evaluation`` builds no engine and needs no
device: every check and lookup runs on the host oracle.
"""

from __future__ import annotations

import contextlib
import dataclasses as _dataclasses
import threading
import time as _time
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional,
    Sequence, Tuple,
)

import numpy as np

from . import consistency as _consistency
from .consistency import OVERLAP_KEY, Strategy
from .engine import explain as _explain
from .engine import vcache as _vcache
from .engine.device import DeviceEngine, DeviceSnapshot, resolve_device
from .engine.kernels import KernelError
from .engine.oracle import Oracle, SnapshotOracle, T
from .engine.plan import EngineConfig
from .rel.filter import Filter, PreconditionedFilter
from .rel.relationship import (
    Relationship, RelationshipLike, as_relationship,
    must_from_triple as rel_must_from_triple,
)
from .rel.strings import parse_object_set, parse_typed_relation
from .rel.txn import Txn
from .rel.update import Update, UpdateFilter
from .store.snapshot import Snapshot
from .store.store import Store, parse_revision
from .utils import decisions as _decisions
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


class ExplainedCheck(NamedTuple):
    """One ``check(..., explain=True)`` item: the boolean verdict plus
    its full resolution tree (engine/explain.py — the reference's
    CheckPermission debug-trace shape)."""

    allowed: bool
    explanation: Dict[str, Any]


class _Options:
    def __init__(self) -> None:
        self.overlap_required = False
        self.engine_config: Optional[EngineConfig] = None
        self.store: Optional[Store] = None
        self.use_device = True
        self.latency_mode = False
        self.admission: Optional[AdmissionConfig] = None
        self.verdict_cache = None  # VerdictCache | max_bytes int | None
        self.decision_log = None  # (spec, kwargs) from with_decision_log
        self.profile_dir: Optional[str] = None
        self.telemetry_port: Optional[int] = None
        self.telemetry_host = "127.0.0.1"
        self.trace_sample_rate: Optional[float] = None
        self.trace_slow_ms: Optional[float] = 100.0
        self.incident_dir: Optional[str] = None
        self.slos = None  # None → utils/slo.default_slos(); () disables
        self.group_commit = None  # GroupCommitConfig | True | None
        self.mesh = None  # parallel.Mesh → the sharded engine


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


def with_store(store: Store) -> Option:
    """Share a Store between clients (e.g. one writer, many checkers)."""

    def opt(o: _Options) -> None:
        o.store = store

    return opt


def with_host_only_evaluation() -> Option:
    """Disable the device engine; evaluate every check and lookup on the
    host oracle.  Such a client resolves no device and launches nothing.
    Useful for debugging and differential testing."""

    def opt(o: _Options) -> None:
        o.use_device = False

    return opt


def with_mesh(mesh, *, partitioned: bool = False) -> Option:
    """Evaluate checks over a (data × model) device mesh
    (``parallel.make_mesh``): the client builds a ShardedEngine
    (parallel/sharded.py) — query batches split along the data axis, the
    bucket-sharded tables along the model axis — instead of the
    single-device DeviceEngine; the client's device is the mesh's first.
    Writes advance the sharded snapshot through the delta chain, lookups
    hop over the stacked reverse index.  ``partitioned=True`` (the
    owner-routed partitioned serve) is not ported yet and raises."""
    if partitioned:
        raise NotImplementedError(
            "with_mesh(partitioned=True): the partitioned serve is not"
            " ported yet")

    def opt(o: _Options) -> None:
        o.mesh = mesh

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


def with_verdict_cache(cache=True) -> Option:
    """Enable the revision-pinned verdict cache (engine/vcache.py) on
    this client's check paths: definite verdicts key on (snapshot
    revision, slot, resource, subject, query-context fingerprint) under
    a byte-bounded LRU, and the consistency strategy of each call is the
    read policy — ``snapshot``/``at_least`` hit the resolved revision's
    shard, ``min_latency`` the freshest resident one, ``full`` bypasses
    entirely.  Caveated verdicts that read live query context are never
    cached; time-gated verdicts cache with a pinned now_us.

    ``cache`` may be ``True`` (default 64 MB cache), an int byte budget,
    or a prebuilt ``VerdictCache`` (shared between clients)."""

    def opt(o: _Options) -> None:
        o.verdict_cache = cache

    return opt


def with_decision_log(log=True, **kw) -> Option:
    """Arm the structured decision log (utils/decisions.py): a sampled
    always-on ring (+ optional rotating JSONL sink) of authorization
    DECISIONS — client id, resource, permission, subject, verdict,
    revision, consistency strategy, cache_hit/dedup_parked provenance,
    latency, trace id — with an always-keep-denied rule.  The
    per-strategy verdict counters are on with or without it.

    ``log`` may be ``True`` (defaults) or a prebuilt ``DecisionLog``;
    keyword arguments (``capacity``, ``sample_rate``, ``sink_path``,
    ``rotate_bytes``, ``rotate_keep``) pass through to the constructor.
    The log is process-global — one stream per process however many
    clients arm it."""

    def opt(o: _Options) -> None:
        o.decision_log = (log, kw)

    return opt


def with_group_commit(config=True) -> Option:
    """Route this client's writes through the group-commit pipeline
    (store/group.py): concurrent ``write`` calls coalesce into ONE
    collapsed delta committed as one log entry — one closure advance,
    one device reship per group — while each transaction still gets its
    own zookie (base+1..base+k inside the group).  Also starts the
    background delta-chain compactor, which materializes long LSM chains
    off the request path so probe depth stays bounded under sustained
    write load.

    ``config`` may be ``True`` (defaults) or a ``GroupCommitConfig``
    (store/group.py) to tune group size, hold-back, and the compactor's
    poll cadence.  Without this option, ``write`` stays on the direct
    one-revision-per-transaction store path.  The committer's threads
    are daemons; ``client._committer.close()`` drains and stops them."""

    def opt(o: _Options) -> None:
        o.group_commit = config

    return opt


def with_telemetry(
    port: int = 0,
    *,
    host: str = "127.0.0.1",
    trace_sample_rate: Optional[float] = None,
    trace_slow_ms: Optional[float] = 100.0,
    incident_dir: Optional[str] = None,
    slos=None,
) -> Option:
    """Serve live telemetry from this client's process: a stdlib HTTP
    daemon thread (utils/telemetry.py) with ``/metrics`` (Prometheus or
    OpenMetrics text — counters, gauges, every timer ring as p50/p90/
    p99/p999 quantiles, histograms with trace-id exemplars), ``/traces``
    (JSONL dump of sampled request traces), ``/slo`` (multi-window
    burn-rate report, utils/slo.py), ``/perf`` (the performance-
    attribution ledger, utils/perf.py: cost entries, the gathered-bytes
    model, pad waste, measured roofline, wall-time ledger),
    ``/debug/incidents`` (flight-recorder bundles), ``/decisions`` (the
    decision log's ring) and ``/healthz`` (readiness: breaker state,
    in-flight admission, serve queue depth, SLO status).  ``port=0``
    picks an ephemeral port; read it back from ``client.telemetry.port``.

    This option also arms the anomaly-diagnosis loop with zero further
    configuration: a process-global **flight recorder** (utils/trace.py)
    retains the last N finished request traces at full fidelity
    regardless of the sample rate, and an **SLO engine** evaluates burn
    rates on a background cadence — an SLO burn, a breaker trip, a shed
    spike, a pinned-path recapture, or a watch resume storm freezes the
    ring and dumps an incident bundle.  ``incident_dir`` lands the
    bundles on disk as JSONL (otherwise the last few stay in memory,
    served at ``/debug/incidents``); ``slos`` overrides the stock
    objectives (``utils/slo.default_slos``; pass ``()`` to disable the
    engine).

    ``trace_sample_rate`` additionally installs the process-global
    request tracer (utils/trace.py) at that head-sampling rate with a
    ``trace_slow_ms`` keep-slow tail rule (None disables the tail
    rule).  Left at None, whatever tracer the process already has stays
    in force — or, when none exists, a 0%-head-sample tracer is
    installed so the flight recorder has traces to retain (``/traces``
    then only exports slow-tail trees; raise the rate for full export)."""

    def opt(o: _Options) -> None:
        o.telemetry_port = port
        o.telemetry_host = host
        o.trace_sample_rate = trace_sample_rate
        o.trace_slow_ms = trace_slow_ms
        o.incident_dir = incident_dir
        o.slos = slos

    return opt


def with_profiling(trace_dir: str) -> Option:
    """Capture a ``torch.profiler`` trace (CPU and, on a ``cuda`` client,
    CUDA activity) around every check dispatch into ``trace_dir``, one
    Chrome-trace JSON file a dispatch, and publish a
    ``checks.device_time_s`` timer — the deep analogue of the
    interceptors the reference admits through WithDialOpts
    (client/client.go:95-97).  Profiled dispatches serialize (one active
    profiler per process).  On a ``cuda`` client a profile that records
    no CUDA activity raises instead of leaving a CPU-only trace.  The
    serving path (``with_serving``) stays unprofiled."""

    def opt(o: _Options) -> None:
        o.profile_dir = trace_dir

    return opt


class Client:
    """An in-process authorization client with the gochugaru Check
    surface, evaluating on a torch device."""

    #: prepared-snapshot / oracle cache capacity per client
    SNAPSHOT_CACHE_MAX = 4

    #: max with_telemetry clients whose admission/cost-model state rides
    #: incident bundles on one recorder (providers are never
    #: unregistered — clients have no close — so registration is capped;
    #: later clients serve telemetry but skip bundle context)
    TELEMETRY_CONTEXT_MAX = 8

    def __init__(self, *opts: Option, device=None) -> None:
        o = _Options()
        for opt in opts:
            opt(o)
        self._use_device = o.use_device
        #: the engine's device (a mesh's first); None on a host-only client
        self._mesh = o.mesh
        if not o.use_device:
            self.device = None
        elif o.mesh is not None:
            self.device = o.mesh.devices[0][0]
        else:
            self.device = resolve_device(device)
        # identity, not truthiness: a store filled only by column imports
        # has no live rows and is falsy
        self._store = o.store if o.store is not None else Store()
        self._overlap_required = o.overlap_required
        self._engine_config = o.engine_config
        if o.engine_config is not None:
            # the host-side LSM materialization floor rides the engine
            # config down to the store
            self._store.lsm_compact_min = o.engine_config.lsm_compact_min
        #: group-commit write pipeline + background chain compactor
        #: (store/group.py), armed by with_group_commit(); None keeps
        #: write() on the direct store path
        self._committer = None
        self._compactor = None
        if o.group_commit is not None and o.group_commit is not False:
            from .store.group import (
                ChainCompactor, GroupCommitConfig, GroupCommitter,
            )

            gcfg = (
                o.group_commit
                if isinstance(o.group_commit, GroupCommitConfig)
                else GroupCommitConfig()
            )
            self._committer = GroupCommitter(
                self._store, gcfg, registry=_metrics.default
            )
            self._compactor = ChainCompactor(
                self._store, gcfg, registry=_metrics.default
            )
        self._profile_dir = o.profile_dir
        # one active torch.profiler per process: profiled dispatches
        # serialize so concurrent check() calls don't collide
        self._profile_lock = threading.Lock()
        self._lock = threading.Lock()
        self._engine: Optional[DeviceEngine] = None
        self._engine_schema = None
        self._dsnap_cache: Dict[int, DeviceSnapshot] = {}
        self._oracle_cache: Dict[int, Oracle] = {}
        self._metrics = _metrics.default
        self._latency_mode = o.latency_mode
        #: the gate, the deadline budget and the latency-path breaker
        self._admission = AdmissionController(o.admission)
        #: revision-pinned verdict cache (engine/vcache.py); None keeps
        #: every check path on the cache-free code
        self._vcache = self._make_vcache(o.verdict_cache)
        #: the process-global decision log (utils/decisions.py), installed
        #: by with_decision_log(); the verdict counters are always on
        if o.decision_log is not None:
            spec, kw = o.decision_log
            if spec is True:
                # bare arming REUSES an already-installed log: a second
                # client must not close the first one's configured sink;
                # explicit kwargs are an explicit reconfiguration
                if kw or _decisions.get() is None:
                    _decisions.install(_decisions.DecisionLog(**kw))
            elif spec:
                _decisions.install(spec)
        #: telemetry endpoint (utils/telemetry.py), via with_telemetry()
        self.telemetry = None
        #: flight recorder + SLO engine (armed by with_telemetry)
        self.recorder = None
        self.slo = None
        if o.telemetry_port is not None:
            self._arm_telemetry(o)

    def _arm_telemetry(self, o: _Options) -> None:
        """with_telemetry's wiring: the tracer the recorder needs, the
        process-shared flight recorder with this client's context
        providers, the one SLO engine per process, and the server."""
        slow_s = None if o.trace_slow_ms is None else o.trace_slow_ms / 1000.0
        if o.trace_sample_rate is not None:
            _trace.configure(
                sample_rate=o.trace_sample_rate, slow_threshold_s=slow_s
            )
        elif not _trace.enabled():
            # the flight recorder needs a tracer to build span trees; a
            # 0% head sample keeps /traces lean (slow-tail trees only)
            # while the recorder retains everything
            _trace.configure(sample_rate=0.0, slow_threshold_s=slow_s)
        rec = _trace.recorder()
        if rec is None:
            rec = _trace.install_recorder(
                _trace.FlightRecorder(incident_dir=o.incident_dir)
            )
        elif o.incident_dir is not None:
            # an explicit caller dir WINS over whatever the shared
            # recorder inherited (env default, an earlier client)
            rec.incident_dir = o.incident_dir
        self.recorder = rec
        # incident bundles carry the admission state that explains
        # shed/breaker behavior at the moment of the anomaly.  The
        # recorder is process-shared, so each telemetry client registers
        # its providers as an atomic GROUP (suffixed keys, so client B
        # never clobbers client A's), capped per recorder
        from .utils import perf as _perf

        rec.add_context_group(
            {
                "cost_model": self._admission.cost.state,
                "admission": lambda adm=self._admission: {
                    "inflight": adm.gate.inflight,
                    "max_inflight": adm.gate.max_inflight,
                    "breaker_state": adm.breaker.state,
                },
                # the perf ledger's cost state — cheap by contract: no
                # microbench
                "perf": _perf.context_state,
                # read at capture time, so a cache attached later by
                # with_serving(cache=...) still shows up in bundles
                "vcache": lambda c=self: (
                    None if c._vcache is None else c._vcache.stats()
                ),
            },
            cap=self.TELEMETRY_CONTEXT_MAX,
        )
        from .utils import slo as _slo

        if o.slos is not None and len(o.slos) == 0:
            # explicit disable: an already-installed engine must STOP
            _slo.install_engine(None)
        else:
            # ONE engine per process (it writes shared slo.* gauges and
            # arms shared timer thresholds): reuse the installed one
            # unless this caller declares its own objectives
            eng = _slo.get_engine()
            if eng is None or o.slos is not None:
                eng = _slo.install_engine(
                    _slo.SLOEngine(slos=o.slos, registry=self._metrics)
                )
            self.slo = eng
        from .utils.telemetry import TelemetryServer

        self.telemetry = TelemetryServer(
            port=o.telemetry_port, host=o.telemetry_host,
            registry=self._metrics, slo=self.slo, recorder=rec,
        )

    @contextlib.contextmanager
    def _profiled(self):
        """with_profiling's window around one dispatch: a
        ``torch.profiler`` session (CPU, plus CUDA on a ``cuda`` client)
        whose trace lands in the profile dir, serialized on
        ``_profile_lock``.  A ``cuda`` profile that recorded no CUDA
        activity raises."""
        if self._profile_dir is None:
            yield
            return
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import (
            ProfilerActivity, profile, tensorboard_trace_handler,
        )

        cuda = self.device is not None and self.device.type == "cuda"
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        with self._profile_lock:
            prof = profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(self._profile_dir),
                acc_events=True,  # events() is read after the trace is written
            )
            with prof:
                yield
                if cuda:
                    torch.cuda.synchronize(self.device)
            if cuda and not any(e.device_type == DeviceType.CUDA
                                for e in prof.events()):
                raise RuntimeError(
                    "with_profiling: the profile of a dispatch on "
                    f"{self.device} recorded no CUDA activity"
                )

    @staticmethod
    def _make_vcache(spec):
        """Normalize the with_verdict_cache / with_serving(cache=...)
        spec: None/False → off, True → default cache, int → byte
        budget, VerdictCache → shared instance."""
        if spec is None or spec is False:
            return None
        if spec is True:
            return _vcache.VerdictCache()
        if isinstance(spec, int):
            return _vcache.VerdictCache(max_bytes=spec)
        return spec

    @property
    def store(self) -> Store:
        return self._store

    # -- overlap guard (client/client.go:182-191) ------------------------
    def _check_overlap(self, ctx: Context) -> None:
        if self._overlap_required and ctx.value(OVERLAP_KEY) is None:
            raise OverlapKeyMissingError()

    # -- engine / oracle plumbing ----------------------------------------
    def _engine_for(self, snap: Snapshot) -> Optional[DeviceEngine]:
        """The device engine for ``snap``'s schema, or None on a
        host-only client."""
        if not self._use_device:
            return None
        with self._lock:
            if self._engine is None or self._engine_schema is not snap.compiled:
                if self._mesh is not None:
                    from .parallel.sharded import ShardedEngine

                    self._engine = ShardedEngine(
                        snap.compiled, self._mesh, self._engine_config
                    )
                else:
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
    def _lru_put(cls, cache: Dict[int, Any], key: int, v: Any) -> List[int]:
        """Insert and evict the least-recently-used entries; returns the
        evicted keys, so dependent caches (the verdict cache's revision
        shards) drop with them."""
        cache[key] = v
        evicted: List[int] = []
        while len(cache) > cls.SNAPSHOT_CACHE_MAX:
            k = next(iter(cache))
            cache.pop(k)
            evicted.append(k)
        return evicted

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
            evicted = self._lru_put(self._dsnap_cache, snap.revision, ds)
            # dsnap-LRU eviction drops the matching verdict shard: a
            # revision no longer resident would only pin bytes
            if self._vcache is not None:
                for r in evicted:
                    self._vcache.drop_revision(r)
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
        """Atomically perform a transaction; returns its revision.  Under
        with_group_commit() the transaction coalesces into the next
        commit group (same zookie contract, one log entry per group);
        otherwise it commits alone."""
        if self._committer is not None:
            return self._committer.write(txn, ctx)
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
        self, ctx: Context, cs: Strategy, *rs: RelationshipLike,
        explain: bool = False,
    ) -> List[bool]:
        """Batched permission check: one device dispatch at the snapshot
        the strategy selects, host-oracle resolution for flagged rows,
        under the admission controller and the retry envelope; through
        the verdict cache when the client has one.

        ``explain=True`` returns ``List[ExplainedCheck]`` instead:
        verdicts AND their typed resolution trees (engine/explain.py),
        evaluated and explained at ONE pinned snapshot — the witness
        plane seeds each allowed tree's walk, cache-served verdicts
        re-derive against the pinned revision."""
        self._check_overlap(ctx)
        rels = [as_relationship(r) for r in rs]
        if not rels:
            return []
        self._metrics.inc("checks.requested", len(rels))
        if explain:
            root = _trace.root_span("check.explain", batch=len(rels))
            ectx = _trace.ctx_with_span(ctx, root)

            def run() -> List[ExplainedCheck]:
                sp = _trace.span_of(ectx)
                # ONE snapshot for the verdicts and every tree
                snap = self._store.snapshot_for(cs)
                # cache residency probed BEFORE the dispatch: entries this
                # dispatch inserts are fresh work, not cache-served
                cache_ents = self._peek_cached(snap, rels, cs)
                # ... and ONE evaluation instant for the walks' expiry gates
                now_us = int(_time.time() * 1_000_000)
                # the admission envelope of a plain check covers the
                # evaluate dispatch and the one armed witness dispatch;
                # the host-oracle walks run outside it
                verdicts, codes = self._admitted(ectx, lambda: (
                    self._evaluate_rels(
                        snap, rels, latency=self._latency_mode, span=sp,
                        cs=cs, profile=True),
                    self._witness_batch(snap, rels),
                ))
                return self._explain_batch(
                    snap, rels, verdicts, cs, now_us=now_us,
                    cache_ents=cache_ents, codes=codes)

            with root:
                return retry_retriable_errors(ectx, run)
        # request-scoped tracing (utils/trace.py): head-sampled root span
        # riding the context chain (with a flight recorder installed the
        # head-dropped requests build a flight-only tree).  The
        # unsampled/disabled path is the NOOP singleton — same context
        # object back, no span allocation anywhere below
        root = _trace.root_span("check", batch=len(rels))
        ctx = _trace.ctx_with_span(ctx, root)

        def dispatch() -> List[bool]:
            return self._admitted(
                ctx, lambda: self._dispatch_admitted(ctx, cs, rels))

        if root is _trace.NOOP:
            # keep-slow tail rule: even unsampled requests leave a
            # root-only trace behind when they blow the slow threshold
            t0 = _trace.tail_clock()
            try:
                return retry_retriable_errors(ctx, dispatch)
            finally:
                _trace.maybe_keep_slow("check", t0, batch=len(rels))
        # Span.__exit__ records the exception type as the `error` attr
        with root:
            return retry_retriable_errors(ctx, dispatch)

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

    def _dispatch_admitted(
        self, ctx: Context, cs: Strategy, rels: List[Relationship]
    ) -> List[bool]:
        """One admitted check dispatch (one retry attempt): snapshot
        selection, then the evaluate layer; a sampled request span grows
        a ``dispatch`` child per attempt."""
        dsp = _trace.span_of(ctx).child("dispatch")
        with dsp:
            snap = self._store.snapshot_for(cs)
            dsp.set_attr("revision", int(snap.revision))
            return self._evaluate_rels(
                snap, rels, latency=self._latency_mode, span=dsp, cs=cs,
                profile=True)

    def _evaluate_rels(
        self,
        snap: Snapshot,
        rels: List[Relationship],
        *,
        latency: bool,
        span=_trace.NOOP,
        cs: Optional[Strategy] = None,
        dedup: bool = False,
        profile: bool = False,
    ) -> List[bool]:
        """Evaluate a formed batch at one snapshot, through the verdict
        cache and in-batch dedup when enabled: cache hits answer without
        touching the device (read policy = the call's consistency
        strategy, engine/vcache.policy_for), the remaining unique rows
        dispatch once (``dedup``, the serving batcher's flag) and their
        verdicts fan back out, definite results populate the revision's
        shard.  Items carrying live query caveat context NEVER read or
        write the cache.  With no cache and dedup off this is the direct
        path (``_evaluate_rels_direct``).

        Decision provenance rides every exit: the per-strategy verdict
        counters always, and sampled + always-keep-denied decision-log
        entries when a log is installed."""
        t_ev = _time.perf_counter()
        vc = self._vcache
        pol = _vcache.policy_for(cs) if vc is not None else _vcache.CACHE_OFF
        if not (pol.read or pol.write) and not dedup:
            out = self._evaluate_rels_direct(
                snap, rels, latency=latency, span=span, profile=profile)
            self._provenance_rels(
                rels, out, snap, cs, None, _time.perf_counter() - t_ev, span)
            return out

        B = len(rels)
        keys = [_vcache.rel_key(r) for r in rels]
        # live-context items (non-empty query caveat_context) bypass the
        # cache entirely: their caveat may read the live context
        cacheable = [k[1] == _vcache.EMPTY_CTX_FP for k in keys]
        out: List[Optional[bool]] = [None] * B
        now_us = int(_time.time() * 1_000_000)
        if pol.read:
            vals = vc.lookup_rels(
                snap.revision,
                [k if cacheable[i] else None for i, k in enumerate(keys)],
            )
            for i, v in enumerate(vals):
                if v is not None:
                    out[i] = v[0]
        pend = [i for i in range(B) if out[i] is None]
        hitflags = [out[i] is not None for i in range(B)]
        nh = B - len(pend)
        if nh:
            span.event("cache.hits", items=nh)
            span.set_attr("cache_hits", nh)
        if not pend:
            res = [bool(v) for v in out]
            self._provenance_rels(
                rels, res, snap, cs, hitflags, _time.perf_counter() - t_ev, span)
            return res
        if dedup and len(pend) > 1:
            first: Dict[Any, int] = {}
            uidx: List[int] = []
            inverse: List[int] = []
            for i in pend:
                u = first.get(keys[i])
                if u is None:
                    u = first[keys[i]] = len(uidx)
                    uidx.append(i)
                inverse.append(u)
            dups = len(pend) - len(uidx)
            if dups:
                self._metrics.inc("dedup.batch_dups", dups)
        else:
            uidx = pend
            inverse = list(range(len(pend)))
        try:
            sub = self._evaluate_rels_direct(
                snap, [rels[i] for i in uidx], latency=latency, span=span,
                profile=profile)
        except BulkCheckItemError as e:
            raise self._remap_bulk_error(
                e, out, pend, inverse, lambda vs: list(vs)
            ) from (e.__cause__ or e)
        for j, i in enumerate(pend):
            out[i] = bool(sub[inverse[j]])
        if pol.write:
            vc.insert_rels(
                snap.revision,
                [(keys[i], sub[j]) for j, i in enumerate(uidx) if cacheable[i]],
                now_us,
            )
        res = [bool(v) for v in out]
        self._provenance_rels(
            rels, res, snap, cs, hitflags, _time.perf_counter() - t_ev, span)
        return res

    @staticmethod
    def _remap_bulk_error(e, out, pend, inverse, as_seq):
        """Translate a unique-space BulkCheckItemError (from the deduped
        direct dispatch) back to caller space: unique verdicts [0,
        e.index) scatter onto their duplicate rows, and the error is
        re-anchored at the first caller row that is NOT fully resolved."""
        part = e.results
        first_bad = None
        for j, i in enumerate(pend):
            if inverse[j] < e.index:
                out[i] = bool(part[inverse[j]])
            elif first_bad is None or i < first_bad:
                first_bad = i
        if first_bad is None:  # defensive: nothing unresolved
            first_bad = pend[-1]
        prefix = as_seq(out[:first_bad])
        return BulkCheckItemError(first_bad, prefix, e.__cause__ or e)

    def _provenance_rels(self, rels, out, snap, cs, cache_hits, dt, span) -> None:
        """Decision provenance for one relationship batch: the verdict
        counters (per batch), plus decision-log entries when a log is
        installed."""
        sname = _decisions.strategy_name(cs)
        allowed = sum(1 for v in out if v)
        _decisions.count_verdicts(
            self._metrics, allowed, len(out) - allowed, sname,
            cache_hits=sum(cache_hits) if cache_hits is not None else 0,
        )
        if _decisions.enabled():
            _decisions.record_rels(
                rels, out, revision=snap.revision, strategy=sname,
                cache_hits=cache_hits, latency_s=dt,
                trace_id=span.trace_id if span.sampled else None,
            )

    def _provenance_cols(
        self, snap, q_res, q_perm, q_subj, res, cs, cache_resolved, dt, span
    ) -> None:
        """Columnar mirror: counters from numpy reductions; decision-log
        entries decode interned ids ONLY for the rows the log keeps."""
        sname = _decisions.strategy_name(cs)
        allowed = int(res.sum())
        _decisions.count_verdicts(
            self._metrics, allowed, int(res.shape[0]) - allowed, sname,
            cache_hits=int(cache_resolved.sum())
            if cache_resolved is not None else 0,
        )
        if _decisions.enabled():
            name_of_slot = snap.compiled.name_of_slot
            interner = snap.interner

            def decode(i: int):
                rt, rid = interner.key_of(int(q_res[i]))
                st, sid = interner.key_of(int(q_subj[i]))
                return (f"{rt}:{rid}", name_of_slot[int(q_perm[i])],
                        f"{st}:{sid}")

            _decisions.record_cols(
                int(res.shape[0]), res, decode,
                revision=snap.revision, strategy=sname,
                cache_hits=cache_resolved, latency_s=dt,
                trace_id=span.trace_id if span.sampled else None,
            )

    def _device_dispatch(self, snap: Snapshot, engine: DeviceEngine,
                         latency: bool, span, run):
        """One device dispatch under the circuit breaker: after
        consecutive transient failures latency-mode traffic reroutes onto
        the batch path until the breaker half-opens a probe; classified
        failures feed it.  ``run(engine, dsnap, use_latency)`` returns the
        (definite, possible, overflow) planes."""
        adm = self._admission
        dsnap = self._dsnap_for(engine, snap)
        span.event("snapshot.prepared")
        use_latency = latency and adm.breaker.allow_latency()
        if latency and not use_latency:
            self._metrics.inc("breaker.latency_rerouted")
            span.event("breaker.latency_rerouted")
        # a latency-mode call may fall back to the batch path (a batch
        # beyond the top tier, no flat tables): only a dispatch the
        # latency path SERVED is a probe that may close the breaker
        lp = engine.latency_path(dsnap) if use_latency else None
        lp_n = lp.dispatch_count if lp is not None else 0
        try:
            out = run(engine, dsnap, lp)
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
        return out

    def _evaluate_rels_direct(
        self, snap: Snapshot, rels: List[Relationship], *, latency: bool,
        span=_trace.NOOP, profile: bool = False,
    ) -> List[bool]:
        """Evaluate a formed batch at one snapshot: one device dispatch
        (``_device_dispatch``), then host-oracle resolution of the
        flagged rows.  Shared by ``check`` and the serving batcher, so
        breaker semantics cannot drift between caller-formed and
        coalesced batches.  A host-only client evaluates every row on the
        oracle."""
        engine = self._engine_for(snap)
        if engine is None:
            self._metrics.inc("checks.oracle", len(rels))
            with self._metrics.timer("checks.dispatch"), span.child(
                    "oracle.check", items=len(rels)):
                oracle = self._oracle_for(snap)
                return [oracle.check_relationship(r) == T for r in rels]
        def run(engine, dsnap, lp):
            # with_profiling's window: the dispatch only, not the prepare;
            # the serving handle's batches (profile=False) stay unprofiled
            prof = self._profiled() if profile else contextlib.nullcontext()
            with prof, self._metrics.timer("checks.device_time_s"):
                return engine.check_batch(
                    dsnap, rels, latency=lp is not None, span=span)

        with self._metrics.timer("checks.dispatch"):
            d, p, ovf = self._device_dispatch(snap, engine, latency, span, run)
        needs_host = (p & ~d) | ovf
        if not needs_host.any():
            self._metrics.inc("checks.device_definite", len(rels))
            return [bool(x) for x in d]
        osp = span.child("oracle.fallback", items=int(needs_host.sum()),
                         overflow=int(ovf.sum()))
        try:
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
                    # per-item error: abort with the partial results, as
                    # the reference's bulk mapping loop does
                    raise BulkCheckItemError(i, out, e) from e
            return out
        finally:
            osp.end()

    def _evaluate_columns(
        self,
        snap: Snapshot,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        *,
        latency: bool,
        span=_trace.NOOP,
        cs: Optional[Strategy] = None,
        dedup: bool = False,
    ) -> np.ndarray:
        """Columnar mirror of ``_evaluate_rels``' cache/dedup layer.
        The columnar path carries no live query context by construction,
        so every verdict is cacheable (expiry gates pin now_us on the
        entry).  Cache hits and duplicate rows never reach the device:
        only the unique misses dispatch, at whatever (smaller) tier they
        land on."""
        t_ev = _time.perf_counter()
        vc = self._vcache
        pol = _vcache.policy_for(cs) if vc is not None else _vcache.CACHE_OFF
        if not (pol.read or pol.write) and not dedup:
            out = self._evaluate_columns_direct(
                snap, q_res, q_perm, q_subj, latency=latency, span=span)
            self._provenance_cols(
                snap, q_res, q_perm, q_subj, np.asarray(out, bool), cs,
                None, _time.perf_counter() - t_ev, span)
            return out

        B = int(q_res.shape[0])
        keys = _vcache.pack_cols(q_perm, q_res, q_subj)
        res = np.zeros(B, bool)
        resolved = np.zeros(B, bool)
        now_us = int(_time.time() * 1_000_000)
        if pol.read:
            arr = vc.lookup_cols(snap.revision, keys)
            if arr is not None:
                resolved = arr >= 0
                res = (arr & 1).astype(bool)
                res[~resolved] = False
        pend = np.nonzero(~resolved)[0]
        nh = B - int(pend.shape[0])
        if nh:
            span.event("cache.hits", items=nh)
            span.set_attr("cache_hits", nh)
        if pend.shape[0] == 0:
            self._provenance_cols(
                snap, q_res, q_perm, q_subj, res, cs, resolved,
                _time.perf_counter() - t_ev, span)
            return res
        if dedup and pend.shape[0] > 1:
            if isinstance(keys, np.ndarray):
                _, uix, inverse = np.unique(
                    keys[pend], return_index=True, return_inverse=True)
                uidx = pend[uix]
            else:
                first: Dict[Any, int] = {}
                ulist: List[int] = []
                inverse = np.empty(pend.shape[0], np.int64)
                for j, i in enumerate(pend):
                    k = keys[i]
                    u = first.get(k)
                    if u is None:
                        u = first[k] = len(ulist)
                        ulist.append(int(i))
                    inverse[j] = u
                uidx = np.asarray(ulist, np.int64)
            dups = int(pend.shape[0] - uidx.shape[0])
            if dups:
                self._metrics.inc("dedup.batch_dups", dups)
        else:
            uidx = pend
            inverse = np.arange(pend.shape[0])
        try:
            sub = self._evaluate_columns_direct(
                snap, np.ascontiguousarray(q_res[uidx]),
                np.ascontiguousarray(q_perm[uidx]),
                np.ascontiguousarray(q_subj[uidx]),
                latency=latency, span=span,
            )
        except BulkCheckItemError as e:
            # unique space -> caller space: scatter the resolved unique
            # prefix onto its duplicates, re-anchor at the first
            # unresolved caller row (everything before it IS resolved)
            part = np.asarray(e.results, bool)
            ok = inverse < e.index
            res[pend[ok]] = part[inverse[ok]]
            resolved[pend[ok]] = True
            first_bad = int(np.nonzero(~resolved)[0][0])
            raise BulkCheckItemError(
                first_bad, res[:first_bad], e.__cause__ or e
            ) from (e.__cause__ or e)
        res[pend] = np.asarray(sub, bool)[inverse]
        if pol.write:
            ku = keys[uidx] if isinstance(keys, np.ndarray) else [
                keys[int(i)] for i in uidx]
            vc.insert_cols(snap.revision, ku, np.asarray(sub, bool), now_us)
        self._provenance_cols(
            snap, q_res, q_perm, q_subj, res, cs, resolved,
            _time.perf_counter() - t_ev, span)
        return res

    def _evaluate_columns_direct(
        self,
        snap: Snapshot,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        *,
        latency: bool,
        span=_trace.NOOP,
    ) -> np.ndarray:
        """The columnar mirror of ``_evaluate_rels_direct`` for the
        serving batcher: pre-interned int32 columns straight onto the
        pinned tier ladder (breaker-gated), with flagged rows resolved on
        the host oracle by id reconstruction (every row on a host-only
        client).  Returns a bool verdict array of len(q_res)."""
        B = int(q_res.shape[0])
        engine = self._engine_for(snap)
        if engine is None:
            self._metrics.inc("checks.oracle", B)
            oracle = self._oracle_for(snap)
            return np.fromiter(
                (self._check_interned(oracle, snap, q_res[i], q_perm[i],
                                      q_subj[i]) for i in range(B)),
                bool, count=B)

        def run(engine, dsnap, lp):
            out = None
            if lp is not None:
                out = lp.dispatch_columns(q_res, q_perm, q_subj, span=span)
            if out is None:
                out = engine.check_columns(dsnap, q_res, q_perm, q_subj)
            return out

        # deliberately no with_profiling window on the serving path (this
        # one, and _evaluate_rels_direct with profile=False): one
        # profiler a process, so per-batch traces would serialize the
        # serving dispatcher behind _profile_lock; serving dispatches
        # are attributed through trace.annotate_dispatch instead
        with self._metrics.timer("checks.device_time_s"):
            d, p, ovf = self._device_dispatch(snap, engine, latency, span,
                                              run)
        res = np.asarray(d, bool).copy()
        needs_host = (p & ~d) | ovf
        if not needs_host.any():
            self._metrics.inc("checks.device_definite", B)
            return res
        oracle = self._oracle_for(snap)
        idx = np.nonzero(needs_host)[0]
        span.event("oracle.fallback", items=int(idx.shape[0]))
        for i in idx:
            self._metrics.inc(
                "checks.fallback_overflow" if ovf[i]
                else "checks.fallback_conditional"
            )
            try:
                res[i] = self._check_interned(
                    oracle, snap, q_res[i], q_perm[i], q_subj[i])
            except Exception as e:
                # idx is ascending, so every item before i is resolved:
                # the serving batcher slices this back onto the
                # co-batched submissions instead of failing them all
                raise BulkCheckItemError(int(i), res[:int(i)], e) from e
        return res

    def _check_interned(
        self, oracle: Oracle, snap: Snapshot, res_id, perm_slot, subj_id
    ) -> bool:
        """One host-oracle check from interned ids (the columnar path's
        fallback): the (resource, permission, subject) triple rebuilt
        through the snapshot's interner and slot names."""
        rtype, rid = snap.interner.key_of(int(res_id))
        stype, sid = snap.interner.key_of(int(subj_id))
        perm = snap.compiled.name_of_slot[int(perm_slot)]
        r = rel_must_from_triple(f"{rtype}:{rid}", perm, f"{stype}:{sid}")
        return oracle.check_relationship(r) == T

    def _peek_cached(
        self, snap: Snapshot, rels, cs: Optional[Strategy]
    ) -> List[Optional[tuple]]:
        """Per-rel verdict-cache entries ``(verdict, pinned now_us)`` or
        None — a metric-free residency probe (explain provenance in the
        reference).  Must run BEFORE the evaluate dispatch: an entry that
        exists only because this request's dispatch inserted it is fresh
        work, not a cache-served verdict."""
        vc = self._vcache
        if vc is None or not _vcache.policy_for(cs).read:
            return [None] * len(rels)
        out: List[Optional[tuple]] = []
        for r in rels:
            key = _vcache.rel_key(r)
            out.append(
                vc.peek_rel(snap.revision, key)
                if key[1] == _vcache.EMPTY_CTX_FP else None
            )
        return out

    # -- decision provenance (engine/explain.py) -------------------------
    def explain(
        self, ctx: Context, cs: Strategy, r: RelationshipLike
    ) -> Dict[str, Any]:
        """Full resolution tree for ONE check at the strategy's pinned
        revision — the reference's CheckPermission debug-trace surface.
        The witness plane (engine/flat.py, the armed program) seeds the
        walk toward the branch the device proved winning; verdicts the
        verdict cache would have served are re-derived against the
        pinned revision and flagged ``cached``.  Runs under the same
        retry envelope as checks (the ``explain.walk`` fault site
        classifies into it)."""
        self._check_overlap(ctx)
        rel_ = as_relationship(r)

        def run() -> Dict[str, Any]:
            snap = self._store.snapshot_for(cs)
            return self._explain_at(snap, rel_, cs)

        return retry_retriable_errors(ctx, run)

    _WITNESS_UNSET = object()

    def _witness_batch(self, snap: Snapshot, rels) -> Optional[Any]:
        """Device witness codes for a whole batch (ONE armed dispatch,
        not one per item), or None on a host-only client.  A hint: an
        error degrades to the unseeded walk and counts under
        ``explain.witness_errors`` — except a failed kernel build or
        launch (``KernelError``), which raises, so a broken card never
        hides behind an unseeded walk."""
        engine = self._engine_for(snap)
        if engine is None:
            return None
        try:
            dsnap = self._dsnap_for(engine, snap)
            return engine.witness_codes(dsnap, rels)
        except KernelError:
            raise
        except Exception:
            self._metrics.inc("explain.witness_errors")
            return None

    def _explain_batch(
        self, snap: Snapshot, rels, verdicts, cs: Optional[Strategy],
        *, now_us: Optional[int] = None, cache_ents=None,
        codes=_WITNESS_UNSET,
    ) -> List[ExplainedCheck]:
        """One explain tree per already-computed verdict at one pinned
        snapshot — the ONE implementation behind ``check(explain=True)``
        and ``ServingHandle.check(explain=True)``.  A tree disagreeing
        with its served verdict (head moved, entry expired) is flagged
        ``verdict_skew`` instead of posing as the verdict's
        derivation."""
        if codes is Client._WITNESS_UNSET:
            codes = self._witness_batch(snap, rels)
        out = []
        for i, (v, r) in enumerate(zip(verdicts, rels)):
            tree = self._explain_at(
                snap, r, cs,
                witness=None if codes is None else int(codes[i]),
                now_us=now_us,
                cache_ent=(cache_ents[i] if cache_ents is not None
                           else Client._WITNESS_UNSET),
            )
            if (tree["result"] == "allowed") != bool(v):
                tree["verdict_skew"] = True
            out.append(ExplainedCheck(bool(v), tree))
        return out

    def _explain_at(
        self, snap: Snapshot, r: Relationship, cs: Optional[Strategy],
        witness=_WITNESS_UNSET, now_us: Optional[int] = None,
        cache_ent=_WITNESS_UNSET,
    ) -> Dict[str, Any]:
        """One explain tree at one pinned snapshot: witness extraction
        (unless the caller already extracted a batch's worth), cache
        provenance, then the instrumented oracle walk.  ``now_us`` pins
        the walk's expiry gates to the instant the verdict was computed;
        a cache-served verdict re-derives at its ENTRY's pinned now_us.
        ``cache_ent`` is the pre-dispatch residency probe result (None =
        known uncached); left unset, the probe runs here — only correct
        when no verdict dispatch preceded this call (``explain``)."""
        if witness is Client._WITNESS_UNSET:
            codes = self._witness_batch(snap, [r])
            wit = int(codes[0]) if codes is not None else None
        else:
            wit = witness
        if cache_ent is Client._WITNESS_UNSET:
            cache_ent = self._peek_cached(snap, [r], cs)[0]
        cached = cache_ent is not None
        if cached:
            now_us = cache_ent[1]
        self._metrics.inc("explain.requests")
        oracle = self._oracle_for(snap)
        return _explain.explain_relationship(
            oracle, r, witness=wit, revision=snap.revision, cached=cached,
            now_us=now_us, strategy=_decisions.strategy_name(cs),
        )

    # -- the serving front end (serve/) ------------------------------------
    def with_serving(
        self, cs: Optional[Strategy] = None, config=None, cache=None
    ) -> "Any":
        """Open a continuous-batching serving handle over this client
        (serve/handle.py): concurrent Check / CheckMany submissions
        coalesce into the next pinned tier slot of the latency path
        (engine/latency.py) under a deadline-aware hold-back, with
        per-client fair admission and queue-depth shedding through
        ``ShedError``.  ``handle.check(ctx, *rels)`` blocks on its
        coalesced result (the retry envelope re-submits on transient
        faults); ``submit`` / ``submit_columns`` return futures for
        open-loop callers.  Batches the latency path declines serve on
        the throughput path, same answers.

        ``cs`` pins the handle's consistency strategy (default
        ``min_latency()``): the checks of one formed batch evaluate at
        one snapshot.  Close the handle (or use it as a context manager)
        to drain and stop its threads.

        ``cache`` arms the revision-pinned verdict cache on this
        client's evaluate paths (``True`` = default 64 MB, an int byte
        budget, a shared ``VerdictCache``, or ``False`` to force this
        handle cache-off even when the client carries one); the
        handle's pinned strategy is the read policy (``full()``
        bypasses).  In-batch and in-flight dedup are governed by
        ``ServeConfig.dedup`` and are on by default."""
        from .serve import ServingHandle

        if cache is not None and cache is not False:
            # True reuses an already-attached cache; an explicit
            # instance or byte budget replaces it
            if self._vcache is None or cache is not True:
                self._vcache = self._make_vcache(cache)
        return ServingHandle(
            self, cs if cs is not None else _consistency.min_latency(),
            config, use_cache=cache is not False,
        )

    # -- lookups (client/client.go:501-599) ------------------------------
    def lookup_resources(
        self, ctx: Context, cs: Strategy, permission: str, subject: str
    ) -> Iterator[str]:
        """Stream resource IDs the subject can access, sorted.
        ``permission`` = "type#perm", ``subject`` = "type:id[#rel]"
        (client/client.go:501-552).

        Device frontier over the reverse-CSR tables (engine/spmv.py) +
        batched exact forward checks; a host-only client scans the host
        oracle.  Transient dispatch faults (``lookup.dispatch`` site)
        retry under the reference's backoff envelope like checks do."""
        from .engine.lookup import lookup_resources_device

        self._check_overlap(ctx)
        subj_type, subj_id, subj_rel = parse_object_set(subject)
        obj_type, obj_rel = parse_typed_relation(permission)
        snap = self._store.snapshot_for(cs)
        engine = self._engine_for(snap)
        if engine is not None:
            self._metrics.inc("lookups.resources_device")
            ids = retry_retriable_errors(
                ctx,
                lambda: lookup_resources_device(
                    engine, self._dsnap_for(engine, snap),
                    obj_type, obj_rel, subj_type, subj_id, subj_rel,
                    oracle_factory=lambda: self._oracle_for(snap),
                ),
            )
        else:
            self._metrics.inc("lookups.resources_oracle")
            ids = self._oracle_for(snap).lookup_resources(
                obj_type, obj_rel, subj_type, subj_id, subj_rel)
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
        if engine is not None:
            self._metrics.inc("lookups.subjects_device")
            ids = retry_retriable_errors(
                ctx,
                lambda: lookup_subjects_device(
                    engine, self._dsnap_for(engine, snap),
                    res_type, res_id, permission, subj_type, subj_rel,
                    oracle_factory=lambda: self._oracle_for(snap),
                ),
            )
        else:
            self._metrics.inc("lookups.subjects_oracle")
            ids = self._oracle_for(snap).lookup_subjects(
                res_type, res_id, permission, subj_type, subj_rel)
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

        return self._lookup_page(
            ctx, cs, cursor, "lookup_resources_page",
            ("res", obj_type, obj_rel, subj_type, subj_id, subj_rel),
            run_page,
            lambda snap, now_us: self._pinned_oracle(
                snap, now_us).lookup_resources(
                    obj_type, obj_rel, subj_type, subj_id, subj_rel),
            page_size,
        )

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

        return self._lookup_page(
            ctx, cs, cursor, "lookup_subjects_page",
            ("subj", res_type, res_id, permission, subj_type, subj_rel),
            run_page,
            lambda snap, now_us: self._pinned_oracle(
                snap, now_us).lookup_subjects(
                    res_type, res_id, permission, subj_type, subj_rel),
            page_size,
        )

    def _pinned_oracle(self, snap: Snapshot, now_us: int) -> Oracle:
        """A SnapshotOracle pinned to one evaluation time (the host-only
        client's cursor-paged lookups); the shared LRU oracle stays on
        the wall clock for ordinary check fallbacks."""
        return SnapshotOracle(
            snap,
            {
                name: self._store.caveat_program(name)
                for name in snap.compiled.schema.caveats
            },
            now_us=now_us,
        )

    def _lookup_page(self, ctx, cs, cursor, metric, token_parts, run_page,
                     run_oracle, page_size) -> LookupPage:
        """Shared paged-lookup plumbing: cursor decode + revision pinning,
        the retry envelope around the device dispatch, and a sorted scan
        of the host oracle on a host-only client."""
        from .engine.spmv import LookupCursor, query_token, resolve_now_us

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
        if engine is None:
            # deterministic sorted scan, cursor = offset.  The evaluation
            # time resolves ONCE and rides the token and the cursor (a
            # resume must slice the SAME list), and the full answer
            # caches on the snapshot by token, so paging a large answer
            # runs the scan once
            now_us = resolve_now_us(cur, None)
            token = query_token("oracle", snap.revision, now_us,
                                *token_parts)
            if cur is not None and cur.token != token:
                raise PreconditionFailedError(
                    "lookup cursor does not match this query")
            pages = snap.__dict__.setdefault("_oracle_lookup_pages", {})
            ids_all = pages.get(token)
            if ids_all is None:
                ids_all = sorted(run_oracle(snap, now_us))
                pages[token] = ids_all
                while len(pages) > 4:
                    pages.pop(next(iter(pages)))
            pos = cur.pos if cur is not None else 0
            ids = ids_all[pos: pos + page_size]
            nxt = None
            if pos + len(ids) < len(ids_all):
                nxt = LookupCursor(snap.revision, token, pos + len(ids),
                                   now_us)
            return LookupPage(ids, nxt.encode() if nxt else None)
        dsnap = self._dsnap_for(engine, snap)
        ids, nxt = retry_retriable_errors(
            ctx, lambda: run_page(engine, dsnap, snap, cur)
        )
        return LookupPage(ids, nxt.encode() if nxt is not None else None)


# Constructors (client/client.go:35-77).  Each takes ``device``:
# ``cuda`` by default, ``"cpu"`` for the plain PyTorch path on the CPU.

def new_evaluator(*opts: Option, device=None) -> Client:
    """A client backed by the PyTorch engine — the counterpart of the
    reference package's ``new_tpu_evaluator``.  ``device`` defaults to
    ``cuda``; pass ``"cpu"`` for the plain PyTorch path on the CPU."""
    return Client(*opts, device=device)


def new_tpu_evaluator(*opts: Option, device=None) -> Client:
    """The reference's constructor name, kept so programs written against
    it run unchanged: the same client as ``new_evaluator``."""
    return Client(*opts, device=device)


def new_with_opts(*opts: Option, device=None) -> Client:
    """Create a client with defaults overridden by options
    (client/client.go:63-77)."""
    return Client(*opts, device=device)


def new_plaintext(endpoint: str = "", preshared_key: str = "",
                  *opts: Option, device=None) -> Client:
    """API-parity constructor (client/client.go:38-44).  The reference
    dials an insecure gRPC channel; this client evaluates in-process, so
    the endpoint and key are accepted for drop-in compatibility and
    ignored."""
    return Client(*opts, device=device)


def new_system_tls(endpoint: str = "", preshared_key: str = "",
                   *opts: Option, device=None) -> Client:
    """API-parity constructor (client/client.go:50-61); see
    new_plaintext."""
    return Client(*opts, device=device)


# Go-parity aliases.
NewTPUEvaluator = new_tpu_evaluator
NewWithOpts = new_with_opts
NewPlaintext = new_plaintext
NewSystemTLS = new_system_tls
WithOverlapRequired = with_overlap_required
WithEngineConfig = with_engine_config
WithLatencyMode = with_latency_mode
WithAdmissionControl = with_admission_control
WithGroupCommit = with_group_commit
