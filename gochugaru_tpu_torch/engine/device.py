"""The device engine: prepared snapshots on a torch device and the bulk
Check through the flat kernel (engine/flat.py).

``DeviceEngine`` compiles a schema's plan once, ``prepare`` turns a store
Snapshot into device tensors (the host build is engine/flat.py
``build_flat_arrays``; one copy to the device) — or, given the
DeviceSnapshot of the revision a Watch delta was derived from, advances
it incrementally: the base tensors stay resident and only the small
``dl_*`` overlays of engine/flat.py ``build_delta_arrays`` ship, so a
write costs O(delta) on the device, not a re-index.  ``check_columns`` /
``check_batch`` run a batch through the flat program, returning the
(definite, possible, overflow) planes.  A batch the flat program cannot
serve — more distinct permissions than ``flat_max_slots``, a snapshot
without flat tables (a graph whose keys do not pack into int32, or
``EngineConfig(use_flat=False)``) — runs on the legacy two-phase program
(engine/legacy.py) on the same device instead.  Possible-but-not-definite and
overflow rows are settled by the caller on the host oracle.  A schema
with caveats gets a ``caveat_plan`` (caveats/device.py): stored contexts
ship as ``ectx_*`` tables, each batch's request contexts as ``qctx``
tables, and the flat program resolves device-eligible caveats with the
CEL tri-state VM.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA the default raises rather than falling back.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..caveats.device import build_caveat_plan, encode_contexts, make_tri_fn
from ..rel.relationship import Relationship, WILDCARD_ID
from ..schema.compiler import CompiledSchema
from ..store.snapshot import Snapshot
from ..utils import faults, metrics
from ..utils import perf as _perf
from ..utils import trace as _trace
from ..utils.context import background
from ..utils.errors import classify_dispatch_exception
from ..utils.retry import retry_retriable_errors
from .flat import (
    DeltaMeta, FlatMeta, build_delta_arrays, build_flat_arrays, build_qm,
    make_flat_fn,
)
from .kernels import spec_tensors
from .legacy import LegacyProgram, legacy_tables
from .packed import narrow_nodes
from .plan import DevicePlan, EngineConfig, build_plan
from .spmv import frontier_static_ok


#: snapshots of at least this many edges prewarm the transposed lookup
#: index in the background when the host walker would serve their
#: lookups (``EngineConfig.lookup_prewarm``)
LOOKUP_PREWARM_MIN_EDGES = 65_536

#: host dtype of each device dtype node_type can carry (narrow_nodes)
_NODE_NP = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32}


def _ceil_pow2(n: int, minimum: int = 8) -> int:
    m = minimum
    while m < n:
        m <<= 1
    return m


def _pad_sorted(a: np.ndarray, size: int) -> np.ndarray:
    """Pad a sorted column with INT32_MAX sentinels."""
    out = np.full(size, np.iinfo(np.int32).max, dtype=np.int32)
    out[: a.shape[0]] = a
    return out


def _pad_payload(a: np.ndarray, size: int, fill: int = 0) -> np.ndarray:
    out = np.full(size, fill, dtype=np.int32)
    out[: a.shape[0]] = a
    return out


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another.
    No CUDA and no explicit device raises — never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain"
                " PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is unavailable")
    return dev


def to_device_tensor(a: np.ndarray, device) -> torch.Tensor:
    """One host array as the engine stores it: uint16 lanes and
    residuals reinterpret as int16 (torch has no uint16 arithmetic on the
    CPU; readers widen ``& 0xFFFF``), bools as bool, the rest as is."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a).to(device)


@dataclass
class DeviceSnapshot:
    """Device-resident form of a Snapshot."""

    revision: int
    arrays: Dict[str, torch.Tensor]
    tid_map: torch.Tensor  # int32[num_schema_types] → interner type id
    snapshot: Snapshot
    #: static geometry of the flat engine's tables (None: the snapshot
    #: has none, and every batch runs on the legacy program)
    flat_meta: Optional[FlatMeta]
    #: per packed table, its decode spec as the kernel reads it
    #: (fields, dictionaries), uploaded once here
    specs: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    #: string-intern pool for caveat context values (literals + stored
    #: context strings); query-time strings outside it get negative ids
    strings: Optional[Dict[str, int]] = None
    #: the store snapshot this one was prepared from, when ``snapshot``
    #: is a derived view of it (None: ``snapshot`` itself).  Lookup
    #: cursors resume against it; the lookup layer caches its frontier
    #: state and live result streams in this object's ``__dict__``
    source_snapshot: Optional[Any] = None
    #: accumulated host-side delta state since the last FULL prepare (set
    #: on delta-prepared snapshots; engine/flat.py _acc_collapse)
    delta_acc: Optional[Dict[str, np.ndarray]] = None
    #: host-side fold maintenance state (engine/fold.py FoldState), set
    #: at FULL prepare on folded worlds and carried along a delta chain
    #: so each revision's dl_pf* overlay recomputes from (base, acc)
    fold_state: Optional[Any] = None
    #: host-side closure advance state (engine/flat.py ClosureHostState):
    #: set at FULL prepare, advanced each revision by the membership-delta
    #: path (store/closure.py advance_closure)
    closure_state: Optional[Any] = None
    #: the raw O(E) kernel columns kept on the HOST when the tables are
    #: packed (the flat program never reads them; the reference ships
    #: them lazily for its legacy kernel), carried along a delta chain
    host_arrays: Optional[Dict[str, np.ndarray]] = None
    #: the legacy program's tables (engine/legacy.py legacy_tables),
    #: built on the first batch this snapshot serves there
    legacy_cache: Optional[Dict[str, torch.Tensor]] = None
    #: the latency-mode dispatcher of this snapshot (engine/latency.py),
    #: made on first use by ``DeviceEngine.latency_path``
    latency_path: Optional[Any] = None
    #: name -> ``data_ptr`` of each tensor of the full prepare this
    #: snapshot's delta chain started from: the latency pins share those
    #: between the chain's revisions and keep the rest private
    base_ptrs: Optional[Dict[str, int]] = None


def _resolve_kernels(config: EngineConfig, device: torch.device) -> bool:
    """The kernel switch: None = kernels exactly on a CUDA device."""
    if config.kernels is None:
        return device.type == "cuda"
    if config.kernels and device.type != "cuda":
        raise RuntimeError("EngineConfig(kernels=True) needs a CUDA device")
    return bool(config.kernels)


def _meta_from(meta_like) -> FlatMeta:
    """The port's FlatMeta from any dataclass with the same fields (the
    reference package's FlatMeta)."""
    if isinstance(meta_like, FlatMeta):
        return meta_like
    names = {f.name for f in dataclasses.fields(FlatMeta)}
    kw = {
        f.name: getattr(meta_like, f.name)
        for f in dataclasses.fields(meta_like)
        if f.name in names
    }
    dm = kw.get("delta")
    if dm is not None and not isinstance(dm, DeltaMeta):
        dnames = {f.name for f in dataclasses.fields(DeltaMeta)}
        kw["delta"] = DeltaMeta(**{
            f.name: getattr(dm, f.name)
            for f in dataclasses.fields(dm) if f.name in dnames
        })
    return FlatMeta(**kw)


def arrays_from_reference(
    np_arrays: Mapping[str, np.ndarray], flat_meta, device=None
) -> Tuple[Dict[str, torch.Tensor], FlatMeta]:
    """The reference package's prepared arrays (``DeviceSnapshot.arrays``
    fetched to numpy) and FlatMeta as the port's device tensors and
    FlatMeta (None stays None: a snapshot without flat tables) — both
    engines then probe identical tables.  ``device`` is ``cuda`` unless
    the caller names one (``resolve_device``)."""
    dev = resolve_device(device)
    arrays = {k: to_device_tensor(np.asarray(v), dev) for k, v in np_arrays.items()}
    return arrays, None if flat_meta is None else _meta_from(flat_meta)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with its leading dim padded with zero rows to ``n``."""
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


class DeviceEngine:
    """Compiles a schema's plan and runs the flat bulk Check on a torch
    device."""

    #: every per-edge column the host tables carry (not shipped when the
    #: tables are packed: the flat kernel never reads them)
    ARRAY_COLUMN_KEYS = (
        "e_rel", "e_res", "e_subj", "e_srel1", "e_caveat", "e_ctx", "e_exp",
        "us_rel", "us_res", "us_subj", "us_srel", "us_caveat", "us_ctx",
        "us_exp", "us_perm", "pus_n", "pus_r",
        "ms_subj", "ms_res", "ms_rel", "ms_caveat", "ms_ctx", "ms_exp",
        "mp_subj", "mp_srel", "mp_res", "mp_rel", "mp_caveat", "mp_ctx",
        "mp_exp",
        "ar_rel", "ar_res", "ar_child", "ar_caveat", "ar_ctx", "ar_exp",
        "node_type",
    )

    #: bound on cached per-permission-subset programs (FIFO eviction)
    FLAT_FN_CACHE_MAX = 16

    def __init__(
        self,
        compiled: CompiledSchema,
        config: Optional[EngineConfig] = None,
        *,
        device=None,
    ) -> None:
        self.compiled = compiled
        self.plan: DevicePlan = build_plan(compiled)
        self.config = config or EngineConfig.for_schema(compiled)
        #: the schema's caveat lowering (None without caveats):
        #: ``caveat_plan.host_only[cid]`` marks a caveat the device
        #: cannot evaluate, whose rows the host oracle settles
        self.caveat_plan = (
            build_caveat_plan(compiled) if self.plan.two_plane else None
        )
        self.device = resolve_device(device)
        self.kernels = _resolve_kernels(self.config, self.device)
        #: (slots, padded batch, meta) keys the cost ledger already holds
        self._perf_cost_reg: set = set()
        #: the legacy two-phase program (engine/legacy.py): batches the
        #: flat program cannot serve
        cp = self.caveat_plan
        self.legacy = LegacyProgram(
            self.plan, self.config,
            tri=None if cp is None else make_tri_fn(cp),
            num_params=1 if cp is None else cp.num_params,
        )
        self._flat_fns: Dict[Any, Any] = {}
        #: the context-free query tables (host form and device form),
        #: built once: most checks carry no request context
        self._empty_qctx_np: Optional[Dict[str, np.ndarray]] = None
        self._empty_qctx_dev: Optional[Dict[str, torch.Tensor]] = None
        #: one background transposed-index build at a time per engine
        self._prewarm_inflight = False
        #: the latency path's pins (engine/latency.py), shared by the
        #: revisions of a shape band: (band, slots, tier, qctx shape) ->
        #: _Pin; FIFO-bounded, a band's pins dropped with its last
        #: revision's path
        self._latency_pins: Dict[Any, Any] = {}
        #: the bands by their key (FlatMeta, shapes, private names, shared
        #: storage: ``LatencyPath._share_key``) -> _Band
        self._latency_bands: Dict[Any, Any] = {}
        #: guards both dicts' lookups and inserts, and the creation of a
        #: snapshot's LatencyPath
        self._latency_pins_lock = threading.Lock()
        #: covers a pinned dispatch from its copy-in to its readback: the
        #: pins' buffers and outputs, and the graph pool they share (one
        #: pool is safe: the lock keeps the replays from overlapping, and
        #: each dispatch reads its outputs back before another graph runs)
        self._latency_replay_lock = threading.Lock()

    # -- snapshot preparation -------------------------------------------
    def _host_arrays(self, snap: Snapshot) -> Dict[str, np.ndarray]:
        """Padded host-side columns (the reference's layout, key for
        key)."""
        E = _ceil_pow2(snap.e_rel.shape[0])
        US = _ceil_pow2(snap.us_rel.shape[0])
        MS = _ceil_pow2(snap.ms_subj.shape[0])
        MP = _ceil_pow2(snap.mp_subj.shape[0])
        AR = _ceil_pow2(snap.ar_rel.shape[0])
        NN = _ceil_pow2(2 * snap.num_nodes)
        PN = _ceil_pow2(snap.pus_n.shape[0])
        return {
            "e_rel": _pad_sorted(snap.e_rel, E),
            "e_res": _pad_sorted(snap.e_res, E),
            "e_subj": _pad_sorted(snap.e_subj, E),
            "e_srel1": _pad_sorted(snap.e_srel1, E),
            "e_caveat": _pad_payload(snap.e_caveat, E),
            "e_ctx": _pad_payload(snap.e_ctx, E, -1),
            "e_exp": _pad_payload(snap.e_exp, E),
            "us_rel": _pad_sorted(snap.us_rel, US),
            "us_res": _pad_sorted(snap.us_res, US),
            "us_subj": _pad_payload(snap.us_subj, US, -1),
            "us_srel": _pad_payload(snap.us_srel, US, -1),
            "us_caveat": _pad_payload(snap.us_caveat, US),
            "us_ctx": _pad_payload(snap.us_ctx, US, -1),
            "us_exp": _pad_payload(snap.us_exp, US),
            "us_perm": _pad_payload(snap.us_perm, US),
            "pus_n": _pad_sorted(snap.pus_n, PN),
            "pus_r": _pad_sorted(snap.pus_r, PN),
            "ms_subj": _pad_sorted(snap.ms_subj, MS),
            "ms_res": _pad_payload(snap.ms_res, MS, -1),
            "ms_rel": _pad_payload(snap.ms_rel, MS, -1),
            "ms_caveat": _pad_payload(snap.ms_caveat, MS),
            "ms_ctx": _pad_payload(snap.ms_ctx, MS, -1),
            "ms_exp": _pad_payload(snap.ms_exp, MS),
            "mp_subj": _pad_sorted(snap.mp_subj, MP),
            "mp_srel": _pad_sorted(snap.mp_srel, MP),
            "mp_res": _pad_payload(snap.mp_res, MP, -1),
            "mp_rel": _pad_payload(snap.mp_rel, MP, -1),
            "mp_caveat": _pad_payload(snap.mp_caveat, MP),
            "mp_ctx": _pad_payload(snap.mp_ctx, MP, -1),
            "mp_exp": _pad_payload(snap.mp_exp, MP),
            "ar_rel": _pad_sorted(snap.ar_rel, AR),
            "ar_res": _pad_sorted(snap.ar_res, AR),
            "ar_child": _pad_payload(snap.ar_child, AR, -1),
            "ar_caveat": _pad_payload(snap.ar_caveat, AR),
            "ar_ctx": _pad_payload(snap.ar_ctx, AR, -1),
            "ar_exp": _pad_payload(snap.ar_exp, AR),
            "node_type": _pad_payload(snap.node_type, NN, -1),
        }

    def _ectx_tables(
        self, snap: Snapshot
    ) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, int]]]:
        """Encode stored caveat contexts into padded device tables, and
        the string pool they were encoded against."""
        if self.caveat_plan is None:
            return {}, None
        strings = dict(self.caveat_plan.base_strings)
        table = encode_contexts(self.caveat_plan, snap.contexts, strings)
        # 2x headroom, the reference's: its Watch-driven deltas append
        # stored contexts in place while the bucket holds
        NC = _ceil_pow2(2 * max(table.vi.shape[0], 1), 4)
        return {
            "ectx_vi": _pad_rows(table.vi, NC),
            "ectx_vf": _pad_rows(table.vf, NC),
            "ectx_pr": _pad_rows(table.present, NC),
            "ectx_host": _pad_rows(table.host, NC),
        }, strings

    def prepare_host(
        self, snap: Snapshot
    ) -> Tuple[Dict[str, np.ndarray], FlatMeta]:
        """The host half of ``prepare``: the device-bound arrays (numpy)
        and the FlatMeta."""
        built = self._host_build(snap)
        return built[0], built[1]

    def _host_build(self, snap: Snapshot):
        """(device-bound numpy arrays, FlatMeta, caveat string pool, fold
        state, closure state, host-kept raw columns).  The FlatMeta is
        None — and the raw columns ship, for the legacy program — with
        ``use_flat=False`` or when the graph's keys do not pack."""
        with metrics.default.timer("prepare.host_tables_s"):
            arrays = self._host_arrays(snap)
            ectx, strings = self._ectx_tables(snap)
            arrays.update(ectx)
        built = (build_flat_arrays(snap, self.config, plan=self.plan)
                 if self.config.use_flat else None)
        if built is None:
            return arrays, None, strings, None, None, None
        flat_arrays, flat_meta, fold_state, closure_state = built
        arrays.update(flat_arrays)
        host_arrays = None
        if self.config.packed_on():
            host_arrays = {
                k: arrays.pop(k)
                for k in self.ARRAY_COLUMN_KEYS
                if k != "node_type" and k in arrays
            }
            arrays["node_type"] = narrow_nodes(
                arrays["node_type"], snap.interner.num_types
            )
        return (arrays, flat_meta, strings, fold_state, closure_state,
                host_arrays)

    @staticmethod
    def record_device_bytes(arrays: Mapping[str, torch.Tensor]) -> int:
        """Publish the resident table footprint: one
        ``snapshot.device_bytes`` gauge plus a per-table breakdown
        (``snapshot.device_bytes.<table>``), so /metrics, trace spans and
        incident bundles report device residency live."""
        total = 0
        # drop the previous snapshot's per-table entries first: a delta
        # prepare can remove tables (despec'd offset anchors), and a
        # stale gauge would break breakdown-sums-to-total
        metrics.default.clear_gauges("snapshot.device_bytes.")
        for k, v in arrays.items():
            nb = int(v.nbytes)
            total += nb
            metrics.default.set_gauge(f"snapshot.device_bytes.{k}", nb)
        metrics.default.set_gauge("snapshot.device_bytes", total)
        _trace.event_if_active("snapshot.device_bytes", total=total)
        return total

    def prepare(
        self, snap: Snapshot, prev: Optional[DeviceSnapshot] = None
    ) -> DeviceSnapshot:
        """Ship a snapshot to the device.  With ``prev`` (the
        DeviceSnapshot of the revision this one was delta-derived from)
        the incremental path goes first: base tensors stay resident, only
        the small ``dl_*`` overlays ship (engine/flat.py
        build_delta_arrays), so a Watch-driven revision costs O(delta).
        Where the reference's delta build returns None (see
        ``_prepare_delta``) this is a full prepare, as there."""
        faults.fire("device.prepare")
        if prev is not None:
            ds = self._prepare_delta(snap, prev)
            if ds is not None:
                return ds
        t0 = _time.perf_counter()
        (arrays, flat_meta, strings, fold_state, closure_state,
         host_arrays) = self._host_build(snap)
        with metrics.default.timer("prepare.h2d_s"):
            dev_arrays = {
                k: to_device_tensor(v, self.device) for k, v in arrays.items()
            }
        self.record_device_bytes(dev_arrays)
        ds = self._snapshot(snap, dev_arrays, flat_meta, strings)
        ds.fold_state = fold_state
        ds.closure_state = closure_state
        ds.host_arrays = host_arrays
        if not frontier_static_ok(flat_meta, snap):
            # snapshots with the reverse-CSR index answer lookups on the
            # device frontier; the rest walker-serve and want the
            # transposed host index built in the background
            self._maybe_prewarm_walker_index(snap)
        metrics.default.observe("prepare.total_s", _time.perf_counter() - t0)
        # perf ledger: the gathered-bytes model of this snapshot (and,
        # with the CUDA kernels on, what they change in it) rides
        # /metrics, /perf and incident bundles from the moment of prepare
        _perf.publish_model(ds)
        if self.kernels:
            _perf.publish_kernel_model(ds)
        return ds

    def _snapshot(self, snap, dev_arrays, flat_meta, strings,
                  prev: Optional[DeviceSnapshot] = None) -> DeviceSnapshot:
        """A DeviceSnapshot over prepared device tensors.  Its decode
        specs come from ``flat_meta.packed`` (a delta chain's meta drops
        the tables it despec'd); ``prev``'s uploaded spec tensors are
        reused for the tables still packed, and its type map kept."""
        if prev is not None:
            tid_map = prev.tid_map
        else:
            tid_np = np.full(max(self.plan.num_schema_types, 1), -1, np.int32)
            for tname, tid in self.compiled.type_ids.items():
                tid_np[tid] = snap.interner.type_lookup(tname)
            tid_map = torch.from_numpy(tid_np).to(self.device)
        old = prev.specs if prev is not None else {}
        specs = {
            k: old[k] if k in old else spec_tensors(spec, self.device)
            for k, spec in (flat_meta.packed if flat_meta is not None else ())
        }
        return DeviceSnapshot(
            revision=snap.revision,
            arrays=dev_arrays,
            tid_map=tid_map,
            snapshot=snap,
            flat_meta=flat_meta,
            specs=specs,
            strings=strings,
            base_ptrs=prev.base_ptrs if prev is not None else {
                k: v.data_ptr() for k, v in dev_arrays.items()},
        )

    def _maybe_prewarm_walker_index(self, snap: Snapshot) -> None:
        """Build the transposed lookup index off-thread (numpy sorts
        release the GIL): the first walker-served lookup then joins a
        mostly finished build instead of paying the O(E log E) sort
        inside a user-facing query.  One in-flight build per engine — a
        Watch chain of delta prepares must not stack O(E log E) threads
        (once the first build lands, the chain-advance machinery carries
        it forward in O(D))."""
        if not (
            self.config.lookup_prewarm
            and snap.num_edges >= LOOKUP_PREWARM_MIN_EDGES
            and getattr(snap, "_lookup_index", None) is None
            and not self._prewarm_inflight
        ):
            return
        from .lookup import lookup_index

        self._prewarm_inflight = True

        def run():
            try:
                lookup_index(snap, mark_used=False)
            finally:
                self._prewarm_inflight = False

        threading.Thread(
            target=run, name="gochugaru-lookup-prewarm", daemon=True
        ).start()

    def _delta_prev_ok(self, prev: DeviceSnapshot) -> bool:
        """Layout eligibility of ``prev`` for the incremental prepare
        (a sharded engine would override: its base tables are
        bucket-sharded)."""
        return prev.flat_meta is not None and not prev.flat_meta.sharded

    def _place_replicated(self, v: np.ndarray) -> torch.Tensor:
        """Ship one small host array of a delta prepare (overlays, node
        types, stored-context tables) to the engine's device."""
        return to_device_tensor(v, self.device)

    def _prepare_delta(
        self, snap: Snapshot, prev: DeviceSnapshot
    ) -> Optional[DeviceSnapshot]:
        """The incremental prepare, or None → the caller does a full one.

        The DeviceSnapshot it returns SHARES prev's device tensors for
        every base table (no copy); only the delta overlays, a grown
        node_type column, re-encoded stored-context tables and the
        closure-derived point tables the delta build reships move.  None
        exactly where the reference's ``_prepare_delta`` returns None:
        build_delta_arrays bails, the stored-context bucket or the node
        bucket is outgrown, or a fresh type id would wrap the narrowed
        node_type."""
        if not (self.config.use_flat and self.config.flat_blockslice
                and self._delta_prev_ok(prev)):
            return None
        built = build_delta_arrays(snap, prev, self.compiled, self.config)
        if built is None:
            return None
        dl_arrays, dmeta, acc, extras = built
        arrays = dict(prev.arrays)
        # drop the previous overlay's tables: the new overlay replaces them
        # (a shrunk accumulated delta must not leave stale tables behind)
        for k in [k for k in arrays if k.startswith("dl_")]:
            del arrays[k]
        strings = prev.strings
        if len(snap.contexts) != len(prev.snapshot.contexts):
            ectx, strings = self._ectx_tables(snap)
            old = prev.arrays.get("ectx_vi")
            if old is not None and ectx["ectx_vi"].shape[0] != old.shape[0]:
                return None  # context bucket grew: shapes change, rebuild
            arrays.update(
                {k: self._place_replicated(v) for k, v in ectx.items()}
            )
        if snap.num_nodes > prev.snapshot.num_nodes:
            NN = int(prev.arrays["node_type"].shape[0])
            if snap.num_nodes > NN:
                return None  # node bucket outgrown: every node shape moves
            nt = _pad_payload(snap.node_type, NN, -1)
            prev_dt = _NODE_NP[prev.arrays["node_type"].dtype]
            if prev_dt != nt.dtype:
                # the base narrowed node_type; fresh interner type ids
                # past the narrow dtype's range would WRAP — bail to a
                # full prepare, which re-derives the width
                if int(nt.max(initial=0)) > np.iinfo(prev_dt).max:
                    return None
                nt = nt.astype(prev_dt)
            arrays["node_type"] = self._place_replicated(nt)
        arrays.update(
            {k: self._place_replicated(v) for k, v in dl_arrays.items()}
        )
        for k in extras.get("drop_keys", ()):
            arrays.pop(k, None)  # despec'd packed-offset anchors
        # an empty collapsed delta (or one that cancelled out) runs as
        # the plain base program
        meta = dataclasses.replace(
            prev.flat_meta, delta=dmeta if dl_arrays else None,
            **extras.get("meta_up", {}),
        )
        self.record_device_bytes(arrays)
        if meta.delta is not None:
            # a delta level declines the device frontier (engine/spmv.py
            # frontier_ok), so lookups on this chain walker-serve: start
            # the transposed-index build in the background now
            self._maybe_prewarm_walker_index(snap)
        ds = self._snapshot(snap, arrays, meta, strings, prev=prev)
        ds.delta_acc = acc
        ds.fold_state = prev.fold_state
        ds.closure_state = extras.get("closure_state")
        ds.host_arrays = prev.host_arrays
        return ds

    def snapshot_from_reference(
        self, snap: Snapshot, np_arrays: Mapping[str, np.ndarray], flat_meta,
        strings: Optional[Mapping[str, int]] = None,
    ) -> DeviceSnapshot:
        """A DeviceSnapshot over the reference package's prepared arrays
        (``arrays_from_reference``; its ``ectx_*`` context tables
        included) and its caveat string pool — the parity harness's
        entry.  A ``flat_meta`` of None carries a legacy-only snapshot
        (the raw columns)."""
        arrays, meta = arrays_from_reference(np_arrays, flat_meta, self.device)
        return self._snapshot(snap, arrays, meta,
                              None if strings is None else dict(strings))

    # -- query lowering --------------------------------------------------
    def _lower_queries(
        self, snap: Snapshot, rels: Sequence[Relationship],
        strings: Optional[Dict[str, int]] = None,
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Relationship objects → interned int32 query columns, and the
        encoded request contexts their ``q_ctx`` column indexes."""
        B = len(rels)
        interner = snap.interner
        slot_of = self.compiled.slot_of_name
        wc_of = snap.wildcard_node_of_type
        q_res = np.full(B, -1, np.int32)
        q_perm = np.full(B, -1, np.int32)
        q_subj = np.full(B, -1, np.int32)
        q_srel = np.full(B, -1, np.int32)
        q_wc = np.full(B, -1, np.int32)
        q_ctx = np.full(B, -1, np.int32)
        q_self = np.zeros(B, bool)
        # dedup request contexts (the caveat_context of the query
        # relationship IS the request context, client/client.go:241-259)
        ctx_rows: List[Mapping] = []
        ctx_index: Dict[str, int] = {}
        if self.caveat_plan is not None:
            for i, r in enumerate(rels):
                if r.caveat_context:
                    key = repr(sorted(r.caveat_context.items(), key=lambda kv: kv[0]))
                    at = ctx_index.get(key)
                    if at is None:
                        at = len(ctx_rows)
                        ctx_index[key] = at
                        ctx_rows.append(r.caveat_context)
                    q_ctx[i] = at
        for i, r in enumerate(rels):
            q_res[i] = interner.lookup(r.resource_type, r.resource_id)
            q_perm[i] = slot_of.get(r.resource_relation, -1)
            q_subj[i] = interner.lookup(r.subject_type, r.subject_id)
            if r.subject_relation:
                srel = slot_of.get(r.subject_relation)
                if srel is None:
                    # unknown subject relation can never be granted; -1
                    # would alias "direct subject", so force the query false
                    q_res[i] = -1
                else:
                    q_srel[i] = srel
            stid = interner.type_lookup(r.subject_type)
            if 0 <= stid < wc_of.shape[0] and r.subject_id != WILDCARD_ID:
                q_wc[i] = wc_of[stid]
            q_self[i] = (
                r.resource_type == r.subject_type
                and r.resource_id == r.subject_id
                and r.subject_relation == r.resource_relation
                and r.subject_relation != ""
            )
        queries = {
            "q_res": q_res, "q_perm": q_perm, "q_subj": q_subj,
            "q_srel": q_srel, "q_wc": q_wc, "q_ctx": q_ctx, "q_self": q_self,
        }
        return queries, self._encode_query_contexts(ctx_rows, strings)

    @staticmethod
    def _unique_subjects(queries: Dict[str, np.ndarray]) -> np.ndarray:
        """The unique (subject, subject relation, wildcard node, request
        context) rows the legacy program's closure phase runs on — the
        context is part of the key because caveat gates make closures
        context-dependent.  Sets ``queries["q_row"]``."""
        subj_key = np.stack([queries["q_subj"], queries["q_srel"],
                             queries["q_wc"], queries["q_ctx"]], axis=1)
        uniq, q_row = np.unique(subj_key, axis=0, return_inverse=True)
        queries["q_row"] = q_row.reshape(-1).astype(np.int32)
        return uniq.astype(np.int32)

    def _encode_query_contexts(
        self, ctx_rows: List[Mapping], strings: Optional[Dict[str, int]]
    ) -> Dict[str, np.ndarray]:
        """Encode deduped request contexts into padded qctx tables against
        the snapshot's string pool (unknown strings get negative ids, equal
        only to themselves); none without caveats, where the flat program
        reads no context.  The context-free case returns a per-engine
        singleton whose device form ``_qctx_device`` caches."""
        if self.caveat_plan is None:
            return {}
        if not ctx_rows and self._empty_qctx_np is not None:
            return self._empty_qctx_np
        table = encode_contexts(
            self.caveat_plan, ctx_rows,
            strings if strings is not None
            else dict(self.caveat_plan.base_strings),
            extra_strings={},
        )
        NQ = _ceil_pow2(table.vi.shape[0], 1)
        out = {
            "vi": _pad_rows(table.vi, NQ),
            "vf": _pad_rows(table.vf, NQ),
            "pr": _pad_rows(table.present, NQ),
            "host": _pad_rows(table.host, NQ),
        }
        if not ctx_rows:
            self._empty_qctx_np = out
        return out

    def _qctx_device(self, qctx: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The qctx tables on the engine's device (the context-free
        singleton copied once)."""
        if qctx is self._empty_qctx_np:
            if self._empty_qctx_dev is None:
                self._empty_qctx_dev = {
                    k: to_device_tensor(v, self.device) for k, v in qctx.items()
                }
            return self._empty_qctx_dev
        return {k: to_device_tensor(v, self.device) for k, v in qctx.items()}

    def _columns_preamble(
        self,
        dsnap: DeviceSnapshot,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        q_srel: Optional[np.ndarray] = None,
        q_wc: Optional[np.ndarray] = None,
        q_ctx: Optional[np.ndarray] = None,
        qctx_rows: Optional[Sequence[Mapping[str, Any]]] = None,
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Optional-column defaulting, query-context encoding and the
        reflexive-self derivation for pre-interned query columns."""
        B = q_res.shape[0]
        if q_srel is None:
            q_srel = np.full(B, -1, np.int32)
        if q_wc is None:
            q_wc = np.full(B, -1, np.int32)
        if q_ctx is None:
            q_ctx = np.full(B, -1, np.int32)
        qctx = self._encode_query_contexts(list(qctx_rows or []), dsnap.strings)
        return {
            "q_res": np.ascontiguousarray(q_res, np.int32),
            "q_perm": np.ascontiguousarray(q_perm, np.int32),
            "q_subj": np.ascontiguousarray(q_subj, np.int32),
            "q_srel": np.ascontiguousarray(q_srel, np.int32),
            "q_wc": np.ascontiguousarray(q_wc, np.int32),
            "q_ctx": np.ascontiguousarray(q_ctx, np.int32),
            # reflexive userset identity (a userset is a member of itself)
            "q_self": (q_res == q_subj) & (q_srel >= 0) & (q_perm == q_srel),
        }, qctx

    # -- the flat program ------------------------------------------------
    def _flat_fn_kwargs(self) -> Dict[str, Any]:
        """The engine's own make_flat_fn arguments (a mesh engine swaps
        the kernels for its model axis)."""
        return {"kernels": self.kernels}

    def _flat_fn_for(self, slots: Tuple[int, ...], meta: FlatMeta,
                     witness: bool = False, routed: bool = False):
        key = ((slots, meta) + (("wit",) if witness else ())
               + (("routed",) if routed else ()))
        fn = self._flat_fns.get(key)
        if fn is None:
            fn = make_flat_fn(
                self.compiled, self.plan, self.config, meta, slots,
                caveat_plan=self.caveat_plan, witness=witness, routed=routed,
                **self._flat_fn_kwargs(),
            )
            while len(self._flat_fns) >= self.FLAT_FN_CACHE_MAX:
                self._flat_fns.pop(next(iter(self._flat_fns)))
            self._flat_fns[key] = fn
        return fn

    def flat_fn_and_args(
        self,
        dsnap: DeviceSnapshot,
        queries: Dict[str, np.ndarray],
        qctx: Dict[str, np.ndarray],
        now: int,
        B: int,
        bucket_min: int = 0,
        witness: bool = False,
    ):
        """The flat program + its padded argument tuple — the ONE place
        that knows its signature.  None where the reference's returns
        None: the snapshot has no flat tables, or the batch asks for more
        distinct permissions than ``flat_max_slots``.  ``witness=True``
        selects the armed program (same arguments, a fourth output: the
        witness plane), cached apart from the serving programs."""
        if dsnap.flat_meta is None:
            return None
        slots = tuple(
            sorted({int(s) for s in np.unique(queries["q_perm"]) if s >= 0})
        )
        if len(slots) > self.config.flat_max_slots:
            return None
        fn = self._flat_fn_for(slots, dsnap.flat_meta, witness=witness)
        BP = _ceil_pow2(B, max(bucket_min, self.config.batch_bucket_min))
        if not witness:
            # device cost ledger: the batch-path program registers a LAZY
            # entry (its identity, no tensors held), realized only when a
            # consumer asks (/perf?compile=1); the engine-local set keeps
            # the steady-state dispatch to one set lookup
            rk = (slots, BP, dsnap.flat_meta)
            if rk not in self._perf_cost_reg:
                self._perf_cost_reg.add(rk)
                mh = f"{hash(dsnap.flat_meta) & 0xFFFFFFFF:08x}"
                ident = {"slots": list(slots), "B": BP, "meta": mh,
                         "device": str(self.device),
                         "tables": _perf.shapes_of(dsnap.arrays)}
                _perf.register_cost_thunk(
                    "batch", f"slots={slots};B={BP};meta={mh}",
                    lambda ident=ident: ident,
                )
        qm = torch.from_numpy(build_qm(queries, BP, dsnap.flat_meta)).to(
            self.device
        )
        # the clock as a 0-dim device tensor, filled on the device (no
        # host copy): the kernels read it by pointer
        now_t = torch.full((), int(now), dtype=torch.int32, device=self.device)
        return fn, (dsnap.arrays, dsnap.tid_map, now_t, qm,
                    self._qctx_device(qctx), dsnap.specs)

    # -- decision provenance (engine/explain.py) -------------------------
    def witness_codes(
        self,
        dsnap: DeviceSnapshot,
        rels: Sequence[Relationship],
        *,
        now_us: Optional[int] = None,
    ) -> Optional[np.ndarray]:
        """Per-check witness codes of a batch: the winning-branch plane
        of the armed flat program (``make_flat_fn(witness=True)``; codes
        in engine/explain.py), int32[len(rels)].  Nonzero only for
        device-definite allowed verdicts: conditional and overflow rows
        (settled on the host oracle) report 0.  None where the flat
        program cannot serve the batch (no flat tables, more distinct
        permissions than ``flat_max_slots``, a mesh's sharded tables):
        the explain walk then runs unseeded.  The armed program is cached
        apart from the serving ones, so this never disturbs the disarmed
        path."""
        meta = dsnap.flat_meta
        if meta is None or meta.sharded:
            return None
        snap = dsnap.snapshot
        queries, qctx = self._lower_queries(snap, rels, dsnap.strings)
        return self._witness_run(dsnap, queries, qctx,
                                 snap.now_rel32(now_us), len(rels))

    def witness_codes_columns(
        self,
        dsnap: DeviceSnapshot,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        *,
        q_srel: Optional[np.ndarray] = None,
        q_wc: Optional[np.ndarray] = None,
        q_ctx: Optional[np.ndarray] = None,
        qctx_rows: Optional[Sequence[Mapping[str, Any]]] = None,
        now_us: Optional[int] = None,
        planes: bool = False,
    ):
        """``witness_codes`` from pre-interned columns, as
        ``check_columns`` takes them.  With ``planes`` returns
        ``(codes, (d, p, ovf))``: the armed program's three check planes
        beside the codes."""
        meta = dsnap.flat_meta
        if meta is None or meta.sharded:
            return None
        queries, qctx = self._columns_preamble(
            dsnap, q_res, q_perm, q_subj, q_srel, q_wc, q_ctx, qctx_rows)
        return self._witness_run(dsnap, queries, qctx,
                                 dsnap.snapshot.now_rel32(now_us),
                                 q_res.shape[0], planes=planes)

    def _witness_run(self, dsnap, queries, qctx, now, B, planes=False):
        got = self.flat_fn_and_args(dsnap, queries, qctx, now, B,
                                    witness=True)
        if got is None:
            return None
        fn, args = got
        with torch.no_grad():
            d, p, ovf, wit = fn(*args)
        # one device->host copy for the planes, one for the codes
        dpo = torch.stack([d[:B], p[:B], ovf[:B]]).cpu().numpy()
        wit = wit[:B].cpu().numpy()
        # host-settled rows (conditional, overflow) carry no trusted
        # witness: the oracle walk explains them unseeded
        wit[(dpo[1] & ~dpo[0]) | dpo[2]] = 0
        if planes:
            return wit, (dpo[0], dpo[1], dpo[2])
        return wit

    def _legacy_arrays(self, dsnap: DeviceSnapshot) -> Dict[str, torch.Tensor]:
        """The legacy program's tables for ``dsnap``, built once and
        cached on it.  A delta-prepared snapshot shares its base
        revision's tensors, so its raw columns are built here from its
        own (tip) snapshot — the base's would serve stale edges; its
        ``ectx_*`` tables are already the tip's.  A full prepare's raw
        columns are its host-kept ones (packed tables) or already on the
        device."""
        if dsnap.legacy_cache is None:
            merged = dict(dsnap.arrays)
            if dsnap.delta_acc is not None:
                raw = self._host_arrays(dsnap.snapshot)
            else:
                raw = dsnap.host_arrays or {}
            merged.update(
                {k: to_device_tensor(v, self.device) for k, v in raw.items()})
            dsnap.legacy_cache = legacy_tables(merged)
        return dsnap.legacy_cache

    def _run_legacy(self, dsnap, queries, qctx, now):
        """One batch on the legacy program, on the engine's device."""
        metrics.default.inc("checks.legacy")
        uniq = self._unique_subjects(queries)
        dev = self.device
        u = {k: torch.from_numpy(np.ascontiguousarray(uniq[:, i])).to(dev)
             for i, k in enumerate(("u_subj", "u_srel", "u_wc", "u_qctx"))}
        q = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in queries.items()}
        with torch.no_grad():
            return self.legacy(self._legacy_arrays(dsnap), dsnap.tid_map, now,
                               u, q, self._qctx_device(qctx))

    def _run(self, dsnap, queries, qctx, now_us, B, bucket_min: int = 0,
             fetch: bool = True):
        now = dsnap.snapshot.now_rel32(now_us)
        got = self.flat_fn_and_args(dsnap, queries, qctx, now, B, bucket_min)
        if got is None:
            d, p, ovf = self._run_legacy(dsnap, queries, qctx, now)
        else:
            fn, args = got
            with torch.no_grad():
                d, p, ovf = fn(*args)
        if not fetch:
            return d, p, ovf
        # one device→host copy for the three planes
        planes = torch.stack([d[:B], p[:B], ovf[:B]]).cpu().numpy()
        return planes[0], planes[1], planes[2]

    # -- the latency-mode path (engine/latency.py) ------------------------
    #: bounded retries for the deadline-less engine-level latency entry
    #: (callers with a Context pass their own)
    LATENCY_RETRY_TRIES = 3

    #: bound on the engine's latency pins (FIFO), the reference's
    LATENCY_PIN_CACHE_MAX = 32

    def latency_path(self, dsnap: DeviceSnapshot):
        """The warm small-batch dispatcher attached to this prepared
        snapshot (created on first use; see engine/latency.py)."""
        if dsnap.latency_path is None:
            from .latency import LatencyPath

            with self._latency_pins_lock:
                if dsnap.latency_path is None:
                    dsnap.latency_path = LatencyPath(self, dsnap)
        return dsnap.latency_path

    def _drop_latency_band(self, band) -> None:
        """Drop ``band`` and its pins (their graphs and outputs): no path
        of its revisions is alive.  Called from the garbage collector, so
        it takes no lock; each step is one atomic dict operation."""
        band.dropped = True
        if self._latency_bands.get(band.share) is band:
            self._latency_bands.pop(band.share, None)
        for k in list(band.pin_keys):
            self._latency_pins.pop(k, None)

    def check_columns_latency(
        self,
        dsnap: DeviceSnapshot,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        *,
        q_srel: Optional[np.ndarray] = None,
        q_wc: Optional[np.ndarray] = None,
        q_ctx: Optional[np.ndarray] = None,
        qctx_rows: Optional[Sequence[Mapping[str, Any]]] = None,
        now_us: Optional[int] = None,
        ctx: Optional[Any] = None,
    ):
        """Latency-mode bulk check from pre-interned columns: a pinned
        graph at a batch tier, per-stage budget metrics.  Falls back to
        ``check_columns`` where the latency path returns None (no flat
        tables, too many distinct permissions, a batch beyond the top
        tier): the same result contract either way.  Dispatch errors are
        classified onto the retry taxonomy and transient ones retry,
        bounded by ``ctx`` when given, else by ``LATENCY_RETRY_TRIES``."""
        span = _trace.span_of(ctx) if ctx is not None else _trace.NOOP

        def dispatch():
            try:
                out = self.latency_path(dsnap).dispatch_columns(
                    q_res, q_perm, q_subj, q_srel=q_srel, q_wc=q_wc,
                    q_ctx=q_ctx, qctx_rows=qctx_rows, now_us=now_us,
                    span=span,
                )
                if out is not None:
                    return out
                return self.check_columns(
                    dsnap, q_res, q_perm, q_subj, q_srel=q_srel, q_wc=q_wc,
                    q_ctx=q_ctx, qctx_rows=qctx_rows, now_us=now_us,
                )
            except Exception as e:
                classified = classify_dispatch_exception(e)
                if classified is None or classified is e:
                    raise
                raise classified

        return retry_retriable_errors(
            ctx if ctx is not None else background(),
            dispatch,
            max_tries=None if ctx is not None else self.LATENCY_RETRY_TRIES,
        )

    # -- the pipelined check ---------------------------------------------
    def check_columns_pipelined(
        self,
        dsnap: DeviceSnapshot,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        *,
        q_ctx: Optional[np.ndarray] = None,
        qctx_rows: Optional[Sequence[Mapping[str, Any]]] = None,
        now_us: Optional[int] = None,
        sub_batch: int = 0,
    ):
        """Pipelined bulk check over pre-interned columns: the batch is
        split into ``sub_batch``-sized dispatches (0: one dispatch), each
        one's planes copied to pinned host memory behind it on the stream,
        and yields ``(lo, hi, d, p, ovf)`` per sub-batch in order, so a
        consumer sees the first results after the first sub-batches
        instead of the whole batch (the serving analogue of the
        reference's chunked CheckIter, client/client.go:164-180).  The reference enqueues every
        sub-batch before fetching any; here sub-batch i+1 is enqueued
        before sub-batch i is waited for, so the host lowers and launches
        the next one while the device runs the current one (the eager
        program's launches are host work, and would otherwise all come
        before the first answer)."""
        B = q_res.shape[0]
        PB = sub_batch or B

        def enqueue(lo):
            hi = min(lo + PB, B)
            d, p, ovf = self.check_columns(
                dsnap, q_res[lo:hi], q_perm[lo:hi], q_subj[lo:hi],
                q_ctx=None if q_ctx is None else q_ctx[lo:hi],
                qctx_rows=qctx_rows, now_us=now_us,
                fetch=False, bucket_min=PB,
            )
            planes = torch.stack([d[: hi - lo], p[: hi - lo], ovf[: hi - lo]])
            if not planes.is_cuda:
                return lo, hi, planes, None
            host = torch.empty(planes.shape, dtype=planes.dtype, pin_memory=True)
            host.copy_(planes, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return lo, hi, host, done

        starts = list(range(0, B, PB))
        nxt = enqueue(starts[0]) if starts else None
        for k in range(len(starts)):
            lo, hi, planes, done = nxt
            nxt = enqueue(starts[k + 1]) if k + 1 < len(starts) else None
            if done is not None:
                done.synchronize()
            got = planes.numpy()
            yield lo, hi, got[0], got[1], got[2]

    # -- the batched check ----------------------------------------------
    def check_columns(
        self,
        dsnap: DeviceSnapshot,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        *,
        q_srel: Optional[np.ndarray] = None,
        q_wc: Optional[np.ndarray] = None,
        q_ctx: Optional[np.ndarray] = None,
        qctx_rows: Optional[Sequence[Mapping[str, Any]]] = None,
        now_us: Optional[int] = None,
        fetch: bool = True,
        bucket_min: int = 0,
    ):
        """Bulk check straight from pre-interned int32 columns; returns
        (definite, possible, overflow) bool arrays of the batch length.
        ``q_ctx`` indexes each query's request context in ``qctx_rows``
        (-1: none).  ``bucket_min`` raises the batch's pow2 padding floor
        (the lookup exact filter pads to one coarse bucket).  With
        ``fetch=False`` returns the padded planes as device tensors,
        unsynchronised (length >= B; the pipelined check fetches them)."""
        B = q_res.shape[0]
        if B == 0:
            z = np.zeros(0, bool)
            return z, z, z
        faults.fire("device.dispatch")
        queries, qctx = self._columns_preamble(
            dsnap, q_res, q_perm, q_subj, q_srel, q_wc, q_ctx, qctx_rows)
        return self._run(dsnap, queries, qctx, now_us, B, bucket_min, fetch)

    def check_batch(
        self,
        dsnap: DeviceSnapshot,
        rels: Sequence[Relationship],
        *,
        now_us: Optional[int] = None,
        latency: bool = False,
        span=_trace.NOOP,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(definite, possible, overflow) for Relationship queries.
        ``possible & ~definite`` and ``overflow`` rows are for the caller
        to settle on the host oracle.  With ``latency``, small batches go
        through the latency path (engine/latency.py: a pinned graph at a
        fixed tier, staged budget metrics); batches it cannot serve fall
        through to the ordinary dispatch, same contract."""
        if not rels:
            z = np.zeros(0, bool)
            return z, z, z
        faults.fire("device.dispatch")
        t_lower = _time.perf_counter()
        queries, qctx = self._lower_queries(dsnap.snapshot, rels, dsnap.strings)
        if latency:
            out = self.latency_path(dsnap).dispatch(
                queries, qctx, len(rels), dsnap.snapshot.now_rel32(now_us),
                t_start=t_lower, span=span,
            )
            if out is not None:
                return out
        with _trace.annotate_dispatch(span):
            return self._run(dsnap, queries, qctx, now_us, len(rels))
