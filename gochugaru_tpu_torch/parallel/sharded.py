"""The sharded bulk-check engine: one program run per position of a
(data × model) mesh.

Queries split along ``data`` (each data row evaluates its own slice of
the batch), the bucket-sharded tables along ``model`` (shard j holds
buckets [j·bpd, (j+1)·bpd) of every table, engine/flat.py
``build_flat_arrays_sharded``).  The program is the single-device one
with collectives at its merge points (engine/flat.py ``make_flat_fn``
with ``axis``; engine/legacy.py with a ``comm`` handle), run once per
mesh position on a thread of its own by parallel/collectives.py
``run_mesh``:

- every base-table probe masks bucket ownership and its boolean output
  OR-reduces over the model axis; userset / arrow / closure candidate
  blocks broadcast from their owning shard;
- the legacy program (a non-pow2 model size, ``use_flat=False``, keys
  that do not pack) all-gathers closure and arrow-BFS candidates and
  OR-reduces its leaf hits.

The delta chain rides the sharded base tables: a Watch-derived revision
ships only the small replicated ``dl_*`` overlays.  Lookups hop over the
stacked reverse index with owner-routed probes and no collective
(``_ShardedLookupHops``).  The sharded probes are plain gathers, as the
reference's are: no probe kernel launches on a mesh.

The partitioned serve (``prepare_partitioned`` over engine/partition.py
``partition_feed``; ``FlatMeta.part_serve``) splits only the primary,
fold-point and T tables and holds every other table whole on each
position.  A batch whose slots are routable goes to the owner shard of
each query's root bucket on the host and runs there with no collective
(``_dispatch_flat_routed``); any other batch takes the psum path over
the same tables.

On a mesh that spans processes (parallel/multihost.py) each process
places and drives only its own positions; ``fetch=False`` returns the
planes of the data rows it holds (``last_local_rows``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.device import (
    DeviceEngine,
    DeviceSnapshot,
    _ceil_pow2,
    _pad_payload,
    to_device_tensor,
)
from ..engine.flat import build_qm
from ..engine.legacy import legacy_tables
from ..engine.plan import EngineConfig
from ..rel.relationship import Relationship
from ..schema.compiler import CompiledSchema
from ..store.snapshot import Snapshot
from ..utils import faults, metrics
from ..utils import trace as _trace
from .collectives import run_mesh
from .mesh import MODEL_AXIS, Mesh


class MeshTensor:
    """One table on a mesh: ``at(r, j)`` is the tensor position (r, j)
    holds — shard j's slice of the leading axis (``sharded``) or the
    whole table.  ``shape`` / ``dtype`` / ``nbytes`` are the logical
    table's; ``resident`` maps each distinct storage the mesh holds to
    its bytes, so a device standing at several positions counts once."""

    __slots__ = ("parts", "sharded", "shape", "dtype", "nbytes")

    def __init__(self, parts: Dict[Tuple[int, int], torch.Tensor],
                 sharded: bool, shape: Tuple[int, ...],
                 dtype: torch.dtype) -> None:
        self.parts = parts  # this process's positions only
        self.sharded = sharded
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.nbytes = int(np.prod(shape, dtype=np.int64)) * (
            self.element_size())

    def at(self, r: int, j: int) -> torch.Tensor:
        return self.parts[(r, j)]

    def element_size(self) -> int:
        return next(iter(self.parts.values())).element_size()

    def resident(self) -> Dict[Tuple[torch.device, int], int]:
        out = {}
        for t in self.parts.values():
            st = t.untyped_storage()
            out[(t.device, st.data_ptr())] = st.nbytes()
        return out


def place(mesh: Mesh, host, sharded: bool) -> MeshTensor:
    """Ship one host array onto this process's positions of ``mesh``:
    split M ways along its leading axis (``sharded``) or whole on every
    position.  Each device gets its bytes once: a device holding every
    shard takes the whole array in one copy and its positions view
    slices of it.  ``host`` may be an engine/partition.py ShardSlices
    (a sharded table held only for its owned shards): each position
    takes its own shard's block, which must be owned."""
    from ..engine.partition import ShardSlices

    D, M = len(mesh.devices), len(mesh.devices[0])
    slices = isinstance(host, ShardSlices)
    if sharded and host.shape[0] % M:
        raise ValueError(
            f"a table of {host.shape[0]} rows does not split {M} ways")
    if slices and (not sharded or host.per * M != host.shape[0]):
        raise ValueError("ShardSlices must be placed split M ways")
    per = host.shape[0] // M if sharded else 0
    holds: Dict[torch.device, set] = {}
    for r, j in mesh.local_positions():
        holds.setdefault(mesh.devices[r][j], set()).add(j)
    parts: Dict[Tuple[int, int], torch.Tensor] = {}
    for dev, shards in holds.items():
        if slices:
            missing = sorted(shards - set(host.blocks))
            if missing:
                raise ValueError(
                    f"shards {missing} are placed here but not owned")
            got = {j: to_device_tensor(host.blocks[j], dev) for j in shards}
        elif not sharded or len(shards) == M:
            whole = to_device_tensor(host, dev)
            got = {j: (whole[j * per:(j + 1) * per] if sharded else whole)
                   for j in shards}
        else:
            got = {j: to_device_tensor(host[j * per:(j + 1) * per], dev)
                   for j in shards}
        for r, j in mesh.local_positions():
            if mesh.devices[r][j] == dev:
                parts[(r, j)] = got[j]
    t = next(iter(parts.values()))
    return MeshTensor(parts, sharded, tuple(host.shape), t.dtype)


def resident_bytes(arrays) -> int:
    """What the mesh's devices hold of ``arrays`` (MeshTensors): each
    distinct storage once, so a device standing at several positions
    counts a replicated table once and a sharded one once in all."""
    res: Dict = {}
    for v in arrays.values():
        res.update(v.resident())
    return sum(res.values())


class ShardedEngine(DeviceEngine):
    """A DeviceEngine whose batched check runs over a mesh."""

    #: legacy raw columns that stay whole on every position (the
    #: reference's replicated specs); every other column splits M ways
    _LEGACY_REPLICATED = ("node_type", "ectx_", "pus_")

    def __init__(
        self,
        compiled: CompiledSchema,
        mesh: Mesh,
        config: Optional[EngineConfig] = None,
    ) -> None:
        r0, j0 = mesh.local_positions()[0]
        super().__init__(compiled, config, device=mesh.devices[r0][j0])
        self.mesh = mesh
        self.data_size = mesh.shape["data"]
        self.model_size = mesh.shape[MODEL_AXIS]
        #: the last dispatch's collectives, as one shard saw them: calls,
        #: host seconds, the bytes it put in, and its row's all-reduces
        #: across processes (calls, host bytes, seconds)
        self.last_collectives = {"calls": 0, "host_s": 0.0, "bytes": 0,
                                 "cross_calls": 0, "cross_bytes": 0,
                                 "cross_s": 0.0}
        #: the [lo, hi) padded query rows of the planes the last
        #: ``fetch=False`` dispatch returned, in order: every data row on
        #: one process, the rows this process holds on a mesh that spans
        #: processes
        self.last_local_rows = []

    # -- placement --------------------------------------------------------
    @staticmethod
    def _flat_sharded_key(key: str) -> bool:
        """Sharded flat tables split on the leading (stacked) axis; node
        types, stored-context tables and the delta-sized ``dl_*``
        overlays are replicated."""
        return not (key == "node_type" or key.startswith(("ectx_", "dl_")))

    @staticmethod
    def _part_sharded_key(key: str) -> bool:
        """Partitioned-serve placement (FlatMeta.part_serve): the
        O(E)-scale point tables (primary, fold point, T join) split along
        the model axis; every other table is whole on every position (its
        probes find the owner's block arithmetically)."""
        from ..engine.flat import PART_SHARDED_KEYS

        return key in PART_SHARDED_KEYS

    def _sharded_of(self, meta):
        return (self._part_sharded_key if meta is not None and meta.part_serve
                else self._flat_sharded_key)

    def _place_all(self, host: Dict[str, np.ndarray], sharded_of):
        return {k: place(self.mesh, v, sharded_of(k)) for k, v in host.items()}

    def _tid_map(self, snap: Snapshot) -> MeshTensor:
        tid = np.full(max(self.plan.num_schema_types, 1), -1, np.int32)
        for tname, t in self.compiled.type_ids.items():
            tid[t] = snap.interner.type_lookup(tname)
        return place(self.mesh, tid, False)

    def record_device_bytes(self, arrays) -> int:
        """The resident footprint as DeviceEngine publishes it, each
        distinct storage counted once (a device standing at several
        positions holds one copy of a replicated table), and the
        per-table breakdown of the logical tables."""
        metrics.default.clear_gauges("snapshot.device_bytes.")
        for k, v in arrays.items():
            metrics.default.set_gauge(f"snapshot.device_bytes.{k}", v.nbytes)
        total = resident_bytes(arrays)
        metrics.default.set_gauge("snapshot.device_bytes", total)
        _trace.event_if_active("snapshot.device_bytes", total=total)
        return total

    def _delta_prev_ok(self, prev: DeviceSnapshot) -> bool:
        # the sharded incremental prepare rides bucket-sharded base tables
        return prev.flat_meta is not None and prev.flat_meta.sharded

    def _place_replicated(self, v: np.ndarray) -> MeshTensor:
        # overlays are delta-sized: replication beats bucket-sharding and
        # lets the program probe them without ownership collectives
        return place(self.mesh, v, False)

    def _snapshot(self, snap, dev_arrays, flat_meta, strings,
                  prev: Optional[DeviceSnapshot] = None) -> DeviceSnapshot:
        # a mesh probes with plain gathers: no kernel decode specs
        return DeviceSnapshot(
            revision=snap.revision, arrays=dev_arrays,
            tid_map=prev.tid_map if prev is not None else self._tid_map(snap),
            snapshot=snap, flat_meta=flat_meta, specs={}, strings=strings,
        )

    def snapshot_from_reference(
        self, snap: Snapshot, np_arrays, flat_meta, strings=None,
    ) -> DeviceSnapshot:
        """A DeviceSnapshot over the reference package's prepared sharded
        arrays (fetched to numpy: the stacked tables whole) and FlatMeta,
        placed on this engine's mesh as ``prepare`` would place them."""
        from ..engine.device import _meta_from

        meta = None if flat_meta is None else _meta_from(flat_meta)
        sharded_of = (self._sharded_of(meta) if meta is not None
                      else self._legacy_sharded_key)
        arrays = self._place_all(
            {k: np.asarray(v) for k, v in np_arrays.items()}, sharded_of)
        return self._snapshot(snap, arrays, meta,
                              None if strings is None else dict(strings))

    # -- snapshot preparation -------------------------------------------
    def prepare(
        self, snap: Snapshot, prev: Optional[DeviceSnapshot] = None
    ) -> DeviceSnapshot:
        """With ``prev`` (the previous revision's sharded DeviceSnapshot)
        the incremental path goes first: the bucket-sharded base tables
        stay resident on their shards and only the small replicated
        ``dl_*`` overlays ship.  Otherwise the bucket-sharded build (a
        pow2 model size with the blockslice flat layout) or, where that
        cannot serve, the sharded legacy columns."""
        if prev is not None:
            out = self._prepare_delta(snap, prev)
            if out is not None:
                return out
        M = self.model_size
        if (self.config.use_flat and self.config.flat_blockslice
                and M & (M - 1) == 0):
            from ..engine.flat import build_flat_arrays_sharded

            t0 = time.perf_counter()
            built = build_flat_arrays_sharded(
                snap, self.config, M, plan=self.plan)
            if built is not None:
                flat_arrays, flat_meta, fold_state, _cstate = built
                host = dict(flat_arrays)
                host["node_type"] = _pad_payload(
                    snap.node_type, _ceil_pow2(2 * snap.num_nodes), -1)
                ectx, strings = self._ectx_tables(snap)
                host.update(ectx)
                t1 = time.perf_counter()
                with metrics.default.timer("prepare.h2d_s"):
                    arrays = self._place_all(host, self._flat_sharded_key)
                self.record_device_bytes(arrays)
                ds = self._snapshot(snap, arrays, flat_meta, strings)
                ds.fold_state = fold_state
                #: host seconds of the build and of the placement
                ds.prepare_split = {"build_s": t1 - t0,
                                    "place_s": time.perf_counter() - t1}
                return ds
        return self._prepare_legacy(snap)

    def prepare_partitioned(self, part) -> DeviceSnapshot:
        """A DeviceSnapshot from a bucket-partitioned feed (engine/
        partition.py ``partition_feed``): its O(E) stacked tables exist
        on the host only for the shards this process owns (ShardSlices),
        and each position takes its own shard's block; the small tables
        (node types, stored contexts, and the closure-derived stacks every
        process builds whole) place as ``prepare`` places them.  A
        ``serve="routed"`` feed (FlatMeta.part_serve) splits only the
        primary / fold point / T tables and holds the rest whole on every
        position, so a routable batch dispatches with no collective
        (``_dispatch_flat_routed``)."""
        snap = part.snapshot
        t0 = time.perf_counter()
        host = dict(part.arrays)
        host["node_type"] = _pad_payload(
            snap.node_type, _ceil_pow2(2 * snap.num_nodes), -1)
        ectx, strings = self._ectx_tables(snap)
        host.update(ectx)
        with metrics.default.timer("prepare.h2d_s"):
            arrays = self._place_all(host, self._sharded_of(part.meta))
        self.record_device_bytes(arrays)
        ds = self._snapshot(snap, arrays, part.meta, strings)
        ds.fold_state = part.fold_state
        #: host seconds of the placement (``prepare_snapshot_partitioned``
        #: adds the feed's as ``build_s``)
        ds.prepare_split = {"place_s": time.perf_counter() - t0}
        return ds

    def prepare_snapshot_partitioned(
        self, snap: Snapshot, prev: Optional[DeviceSnapshot] = None
    ) -> DeviceSnapshot:
        """The partitioned (owner-routed) serve from a resident Snapshot,
        the client's ``with_mesh(partitioned=True)`` path: the snapshot's
        raw columns through ``partition_feed(serve="routed")``, placed by
        ``prepare_partitioned``.  With ``prev`` the incremental path goes
        first (it rides the partitioned base tables like any sharded
        snapshot); a world the feed declines (keys past the int32 pack)
        takes the ordinary sharded prepare."""
        if prev is not None:
            out = self._prepare_delta(snap, prev)
            if out is not None:
                out.source_snapshot = snap
                return out
        from ..engine.partition import partition_feed, snapshot_raw_columns

        t0 = time.perf_counter()
        part = partition_feed(
            snap.revision, snap.compiled, snap.interner,
            snapshot_raw_columns(snap), self.config, self.model_size,
            contexts=snap.contexts, epoch_us=snap.epoch_us,
            plan=self.plan, serve="routed",
        )
        if part is None:
            return self.prepare(snap)
        feed_s = time.perf_counter() - t0
        out = self.prepare_partitioned(part)
        out.prepare_split["build_s"] = feed_s
        out.source_snapshot = snap
        return out

    @classmethod
    def _legacy_sharded_key(cls, key: str) -> bool:
        return not key.startswith(cls._LEGACY_REPLICATED)

    def _prepare_legacy(self, snap: Snapshot) -> DeviceSnapshot:
        """The raw sorted columns, model-split.  A column whose length
        does not divide by the model size pads to the next multiple of it
        (sorted keys with INT32_MAX so the padded tail sorts last,
        payloads with -1, never read through a matching key).  The
        reference pads to a power of two, which no non-pow2 model size
        divides: its device_put refuses such a mesh."""
        t0 = time.perf_counter()
        host = self._host_arrays(snap)
        sorted_keys = {
            "e_rel", "e_res", "e_subj", "e_srel1", "us_rel", "us_res",
            "ms_subj", "mp_subj", "mp_srel", "ar_rel", "ar_res",
        }
        M = self.model_size
        for k, v in list(host.items()):
            if self._legacy_sharded_key(k) and v.shape[0] % M:
                size = -(-v.shape[0] // M) * M
                fill = (2**31 - 1) if k in sorted_keys else -1
                out = np.full(size, fill, v.dtype)
                out[: v.shape[0]] = v
                host[k] = out
        ectx, strings = self._ectx_tables(snap)
        host.update(ectx)
        t1 = time.perf_counter()
        arrays = self._place_all(host, self._legacy_sharded_key)
        self.record_device_bytes(arrays)
        ds = self._snapshot(snap, arrays, None, strings)
        ds.prepare_split = {"build_s": t1 - t0,
                            "place_s": time.perf_counter() - t1}
        return ds

    # -- per-position views -------------------------------------------------
    @staticmethod
    def _views(dsnap: DeviceSnapshot, r: int, j: int) -> Dict[str, torch.Tensor]:
        """Position (r, j)'s tensors of ``dsnap``, cached on it."""
        cache = dsnap.__dict__.setdefault("_mesh_views", {})
        got = cache.get((r, j))
        if got is None:
            got = {k: v.at(r, j) for k, v in dsnap.arrays.items()}
            cache[(r, j)] = got
        return got

    def _legacy_views(self, dsnap: DeviceSnapshot, r: int, j: int):
        cache = dsnap.__dict__.setdefault("_mesh_legacy", {})
        got = cache.get((r, j))
        if got is None:
            got = legacy_tables(self._views(dsnap, r, j))
            cache[(r, j)] = got
        return got

    def _note_collectives(self, comms) -> None:
        r, j = self.mesh.local_positions()[0]
        c = comms[r][j]
        g = c.group
        self.last_collectives = {
            "calls": c.calls, "host_s": c.seconds, "bytes": c.bytes,
            "cross_calls": g.cross_calls if g else 0,
            "cross_bytes": g.cross_bytes if g else 0,
            "cross_s": g.cross_s if g else 0.0}

    def _rows_out(self, results, B: int, fetch: bool, per: int):
        """The planes of every data row this process holds, in row order,
        each from the row's first local shard (every shard of a row holds
        the same planes).  ``fetch=False`` returns them as tensors on the
        first local device and notes their rows in ``last_local_rows``;
        ``fetch`` needs every row, so it raises on a mesh where another
        process holds some (no result crosses processes)."""
        M = self.model_size
        held = []
        for r in range(self.data_size):
            js = [j for j in range(M) if self.mesh.is_local(r, j)]
            if js:
                held.append((r, results[r][js[0]]))
        if not fetch:
            r0, j0 = self.mesh.local_positions()[0]
            dev = self.mesh.devices[r0][j0]
            self.last_local_rows = [(r * per, (r + 1) * per) for r, _ in held]
            return tuple(torch.cat([row[i].to(dev) for _, row in held])
                         for i in range(3))
        if len(held) < self.data_size:
            raise RuntimeError(
                "this process holds only some data rows of the mesh: "
                "dispatch with fetch=False")
        planes = np.concatenate(
            [torch.stack(list(row)).cpu().numpy() for _, row in held], axis=1)
        return planes[0][:B], planes[1][:B], planes[2][:B]

    # -- the flat program ---------------------------------------------------
    def _flat_fn_kwargs(self) -> Dict:
        """The sharded program: ownership-masked plain gathers over the
        model axis (no probe kernel: the reference's ``PLS = (not SH)``)."""
        return {"axis": MODEL_AXIS, "model_size": self.model_size}

    def _routable(self, meta, slots) -> bool:
        """A batch owner-routes iff every root probe its queries can make
        is local on the owner shard: every slot is a fully folded
        permission (the pf probe pair) or a bare relation leaf (the
        dynamic e / userset sites keyed by the query's own (k1, k2)).
        Wildcard edges probe a SECOND e / pf bucket with another owner,
        so worlds with them keep the psum path; so do T-probing slots
        (``meta.t_slots``): the T join is split under part-serve with a
        geometry of its own, and only the psum path's ownership-masked
        probe is exact there."""
        if meta.has_wc_edges or meta.pf_haswc:
            return False
        if meta.has_tindex and any(s in meta.t_slots for s in slots):
            return False
        dm = meta.delta
        fold_on = bool(meta.fold_pairs) and not (dm is not None and dm.pf_off)
        folded = frozenset(meta.fold_pairs) if fold_on else frozenset()
        unfolded = {
            s for (tname, _tid, s, _e) in self.plan.topo_programs
            if (tname, s) not in folded
        }
        return all(s not in unfolded for s in slots)

    def _dispatch_flat(
        self, dsnap: DeviceSnapshot, queries: Dict[str, np.ndarray],
        qctx: Dict[str, np.ndarray], now_us: Optional[int],
        fetch: bool = True, bucket_min: int = 0, span=_trace.NOOP,
    ):
        """Queries split along the data axis; the program's probe sites
        OR-reduce over the model axis.  A batch with more distinct
        permissions than ``flat_max_slots`` runs in slot chunks (each
        query's slot lives in exactly one chunk; masked-out queries read
        -1, all false), as the reference's does.  On a partitioned-serve
        snapshot a routable batch with one data row, fetched, on a mesh
        this process drives whole, is owner-routed instead
        (``_dispatch_flat_routed``)."""
        faults.fire("sharded.collective")
        from ..engine.flat import _dense_np

        snap = dsnap.snapshot
        meta = dsnap.flat_meta
        D = self.data_size
        B = queries["q_res"].shape[0]
        all_slots = sorted(
            {int(s) for s in np.unique(queries["q_perm"]) if s >= 0})
        if (meta.part_serve and D == 1 and fetch and self.mesh.all_local
                and self._routable(meta, all_slots)):
            return self._dispatch_flat_routed(
                dsnap, queries, qctx, now_us, all_slots,
                bucket_min=bucket_min, span=span)
        per = _ceil_pow2(-(-B // D),
                         max(bucket_min, self.config.batch_bucket_min))
        BP = per * D
        now = int(snap.now_rel32(now_us))
        qm = build_qm(queries, BP, meta)
        cap = max(self.config.flat_max_slots, 1)
        multi = len(all_slots) > cap
        k1d = _dense_np(meta.k1_dense) if multi else None
        chunks = []
        for at in range(0, max(len(all_slots), 1), cap):
            chunk = tuple(all_slots[at:at + cap])
            qmc = qm
            if multi:
                # both slot-bearing rows splice: leaving row 7 (dense
                # q_perm_k1) unmasked would drive the dynamic leaf for
                # masked-out queries in every chunk
                pc = np.full(BP, -1, np.int32)
                pc[:B] = np.where(
                    np.isin(queries["q_perm"], np.asarray(chunk, np.int32)),
                    queries["q_perm"], -1)
                qmc = qm.copy()
                qmc[1] = pc
                qmc[7] = np.where(
                    pc >= 0, k1d[np.clip(pc, 0, k1d.shape[0] - 1)], -1)
            chunks.append((self._flat_fn_for(chunk, meta), qmc))

        def body(r: int, j: int, comm):
            dev = self.mesh.devices[r][j]
            arrs = self._views(dsnap, r, j)
            tid = dsnap.tid_map.at(r, j)
            now_t = torch.full((), now, dtype=torch.int32, device=dev)
            qc = {k: to_device_tensor(v, dev) for k, v in qctx.items()}
            d = p = ovf = None
            for fn, qmc in chunks:
                qmr = torch.from_numpy(np.ascontiguousarray(
                    qmc[:, r * per:(r + 1) * per])).to(dev)
                cd, cp, co = fn(arrs, tid, now_t, qmr, qc, {}, comm=comm)
                d = cd if d is None else d | cd
                p = cp if p is None else p | cp
                ovf = co if ovf is None else ovf | co
            return d, p, ovf

        results, comms = run_mesh(self.mesh, body)
        self._note_collectives(comms)
        return self._rows_out(results, B, fetch, per)

    def _dispatch_flat_routed(
        self, dsnap: DeviceSnapshot, queries: Dict[str, np.ndarray],
        qctx: Dict[str, np.ndarray], now_us: Optional[int], all_slots,
        bucket_min: int = 0, span=_trace.NOOP,
    ):
        """Owner-routed dispatch over a partitioned-serve snapshot: each
        query's root (k1, k2) is hashed on the HOST (``mix32``) and the
        query grouped to the shard owning its bucket, so each position
        probes only its own slices of the split tables and its program
        makes no collective (the membership and group tables are whole on
        it; engine/flat.py ``make_flat_fn(routed=True)``).  Folded-slot
        queries route by the pf geometry, the rest by the primary one:
        the same hash, another modulus.  Each shard's block pads to one
        pow2 tier; the T join is never probed here (``_routable``)."""
        from ..engine.flat import QM_ROWS, _dense_np
        from ..engine.hash import mix32
        from ..engine.partition import shard_owner

        meta = dsnap.flat_meta
        M = self.model_size
        B = queries["q_res"].shape[0]
        t0 = time.perf_counter()
        qmh = build_qm(queries, B, meta)  # [8, B], dense-mapped
        k1 = (qmh[7].astype(np.int64) * meta.N + qmh[0]).astype(np.int32)
        k2 = (qmh[2].astype(np.int64) * meta.S1 + qmh[3]).astype(np.int32)
        h = mix32([k1, k2], np)
        e_size = (int(dsnap.arrays["eh_off"].shape[0]) // M - 1) * M
        owner = shard_owner(h, e_size, M).astype(np.int64)
        pf_slots = sorted({s for _, s in meta.fold_pairs})
        if pf_slots and "pfh_off" in dsnap.arrays:
            pf_size = (int(dsnap.arrays["pfh_off"].shape[0]) // M - 1) * M
            pf_owner = shard_owner(h, pf_size, M).astype(np.int64)
            is_pf = np.isin(qmh[1], np.asarray(pf_slots, np.int32))
            owner = np.where(is_pf, pf_owner, owner)
        # invalid / self queries probe nothing that needs locality
        owner = np.where((qmh[0] < 0) | (qmh[1] < 0), 0, owner)
        counts = np.bincount(owner, minlength=M)
        per = _ceil_pow2(int(counts.max()),
                         max(bucket_min, self.config.batch_bucket_min))
        order = np.argsort(owner, kind="stable")
        starts = np.cumsum(counts) - counts
        pos = np.arange(B, dtype=np.int64) - np.repeat(starts, counts)
        dst = np.empty(B, np.int64)
        dst[order] = owner[order] * per + pos
        qm_r = np.full((QM_ROWS, M * per), -1, np.int32)
        qm_r[3] = qm_r[6] = 0
        qm_r[:, dst] = qmh
        metrics.default.observe("dispatch.route_s", time.perf_counter() - t0)
        span.event("route", shard_batches=[int(c) for c in counts],
                   pad_per_shard=int(per), exchange_bytes=int(qm_r.nbytes))
        # no faults.fire here: _dispatch_flat fired "sharded.collective"
        # for this dispatch before routing
        now = int(dsnap.snapshot.now_rel32(now_us))
        cap = max(self.config.flat_max_slots, 1)
        k1d = _dense_np(meta.k1_dense)
        chunks = []
        for at in range(0, max(len(all_slots), 1), cap):
            chunk = tuple(all_slots[at:at + cap])
            qmc = qm_r
            if len(all_slots) > cap:
                # splice both slot rows on the routed layout
                keep = np.isin(qm_r[1], np.asarray(chunk, np.int32))
                qmc = qm_r.copy()
                qmc[1] = np.where(keep, qm_r[1], -1)
                qmc[7] = np.where(
                    keep & (qm_r[1] >= 0),
                    k1d[np.clip(qm_r[1], 0, k1d.shape[0] - 1)], -1)
            chunks.append((self._flat_fn_for(chunk, meta, routed=True), qmc))

        def body(r: int, j: int, comm):
            dev = self.mesh.devices[r][j]
            arrs = self._views(dsnap, r, j)
            now_t = torch.full((), now, dtype=torch.int32, device=dev)
            qc = {k: to_device_tensor(v, dev) for k, v in qctx.items()}
            d = p = ovf = None
            for fn, qmc in chunks:
                qmr = torch.from_numpy(np.ascontiguousarray(
                    qmc[:, j * per:(j + 1) * per])).to(dev)
                cd, cp, co = fn(arrs, dsnap.tid_map.at(r, j), now_t, qmr, qc,
                                {}, comm=comm)
                d = cd if d is None else d | cd
                p = cp if p is None else p | cp
                ovf = co if ovf is None else ovf | co
            return d, p, ovf

        results, comms = run_mesh(self.mesh, body)
        self._note_collectives(comms)
        planes = [np.concatenate([results[0][j][i].cpu().numpy()
                                  for j in range(M)]) for i in range(3)]
        span.event("unroute")
        return planes[0][dst], planes[1][dst], planes[2][dst]

    # -- the legacy program -------------------------------------------------
    def _dispatch_legacy(
        self, dsnap: DeviceSnapshot, queries: Dict[str, np.ndarray],
        qctx: Dict[str, np.ndarray], now_us: Optional[int],
        fetch: bool = True,
    ):
        """Queries split along the data axis; each data row computes the
        closures of its own unique subjects; the model shards gather and
        OR-reduce inside the program."""
        faults.fire("sharded.collective")
        metrics.default.inc("checks.legacy")
        D = self.data_size
        B = queries["q_res"].shape[0]
        per = _ceil_pow2(-(-B // D), self.config.batch_bucket_min)
        BP = per * D
        q = {k: np.full(BP, -1 if v.dtype != bool else 0, v.dtype)
             for k, v in queries.items() if k != "q_row"}
        for k in q:
            q[k][:B] = queries[k]
        now = int(dsnap.snapshot.now_rel32(now_us))
        rows = []
        for r in range(D):
            qr = {k: v[r * per:(r + 1) * per] for k, v in q.items()}
            rows.append((self._unique_subjects(qr), qr))

        def body(r: int, j: int, comm):
            dev = self.mesh.devices[r][j]
            uniq, qr = rows[r]
            u = {k: torch.from_numpy(np.ascontiguousarray(uniq[:, i])).to(dev)
                 for i, k in enumerate(("u_subj", "u_srel", "u_wc", "u_qctx"))}
            qd = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in qr.items()}
            qc = {k: to_device_tensor(v, dev) for k, v in qctx.items()}
            return self.legacy(self._legacy_views(dsnap, r, j),
                               dsnap.tid_map.at(r, j), now, u, qd, qc,
                               comm=comm)

        results, comms = run_mesh(self.mesh, body)
        self._note_collectives(comms)
        return self._rows_out(results, B, fetch, per)

    # -- the batched check --------------------------------------------------
    def _dispatch_columns(
        self, dsnap: DeviceSnapshot, queries: Dict[str, np.ndarray],
        qctx: Dict[str, np.ndarray], now_us: Optional[int],
        fetch: bool = True, bucket_min: int = 0, span=_trace.NOOP,
    ):
        faults.fire("sharded.dispatch")
        ssp = span.child("sharded.dispatch",
                         batch=int(queries["q_res"].shape[0]),
                         data=self.data_size, model=self.model_size)
        try:
            with _trace.annotate_dispatch(span):
                if dsnap.flat_meta is not None:
                    out = self._dispatch_flat(dsnap, queries, qctx, now_us,
                                              fetch, bucket_min, span=ssp)
                else:
                    out = self._dispatch_legacy(dsnap, queries, qctx, now_us,
                                                fetch)
            ssp.event("collectives", **self.last_collectives)
            return out
        finally:
            ssp.end()

    def check_batch(
        self, dsnap: DeviceSnapshot, rels: Sequence[Relationship], *,
        now_us: Optional[int] = None, latency: bool = False,
        span=_trace.NOOP,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(definite, possible, overflow) for Relationship queries.
        ``latency`` is accepted for Client parity and ignored: the latency
        path is single-device (engine/latency.py)."""
        if not rels:
            z = np.zeros(0, bool)
            return z, z, z
        queries, qctx = self._lower_queries(dsnap.snapshot, rels,
                                            dsnap.strings)
        return self._dispatch_columns(dsnap, queries, qctx, now_us, span=span)

    def check_columns(
        self, dsnap: DeviceSnapshot, q_res: np.ndarray, q_perm: np.ndarray,
        q_subj: np.ndarray, *, q_srel: Optional[np.ndarray] = None,
        q_wc: Optional[np.ndarray] = None, q_ctx: Optional[np.ndarray] = None,
        qctx_rows=None, now_us: Optional[int] = None, fetch: bool = True,
        bucket_min: int = 0,
    ):
        """Columnar bulk check over the mesh; ``bucket_min`` raises the
        per-data-row padding floor.  ``fetch=False`` returns the padded
        planes as tensors on the mesh's first device."""
        B = q_res.shape[0]
        if B == 0:
            z = np.zeros(0, bool)
            return z, z, z
        queries, qctx = self._columns_preamble(
            dsnap, q_res, q_perm, q_subj, q_srel, q_wc, q_ctx, qctx_rows)
        return self._dispatch_columns(dsnap, queries, qctx, now_us,
                                      fetch=fetch, bucket_min=bucket_min)

    # -- owner-routed lookup hops (engine/spmv.py frontier) ----------------
    def lookup_hops_for(self, dsnap: DeviceSnapshot, kern):
        """The sharded hop backend of the lookup frontier: each hop's keys
        go to their OWNER shard on the host (high bits of the reverse
        index bucket), and each shard probes and emits over its own block
        with no collective."""
        return _ShardedLookupHops(self, dsnap, kern)


class _ShardedLookupHops:
    """One DeviceSnapshot's routed hop executor.  A hop:

    1. HOST: the owner of each frontier key is the high bits of its
       reverse-index bucket — keys group into per-owner blocks;
    2. DEVICE: each shard finds its keys' runs in ITS block (the local
       bucket is the low bits: a key's rows live wholly on its owner) and
       emits the matches in fixed chunks, each shard walking its own
       cursor;
    3. HOST: each round's live rows, shard by shard, feed the frontier
       engine as the single-device path's do (engine/spmv.py)."""

    #: per hop kind: (offsets key, probed table key, emitted table key)
    _TABS = {
        "rv": ("rv_off", "rvx", "rvx"),
        "ra": ("ra_off", "rax", "rax"),
        "fw": ("fw_off", "fwx", "fwx"),
        "arg": ("arr_off", "argx", "arx"),
    }

    def __init__(self, engine: ShardedEngine, dsnap: DeviceSnapshot,
                 kern) -> None:
        self.engine = engine
        self.dsnap = dsnap
        self.kern = kern
        self.M = engine.model_size

    def expand(self, kind: str, keys: np.ndarray, now):
        """Generator of live row blocks for ``keys`` over one view — the
        sharded mirror of FrontierKernels.expand."""
        from ..engine.hash import mix32
        from ..engine.spmv import _mt

        if keys.shape[0] == 0:
            return
        faults.fire("lookup.dispatch")
        arrs = self.dsnap.arrays
        off_key, tbl_key, emit_key = self._TABS[kind]
        M = self.M
        bpd = arrs[off_key].shape[0] // M - 1
        size = bpd * M
        kk = np.ascontiguousarray(keys, np.int32)
        h = mix32([kk], np)
        owner = ((h & np.uint32(size - 1)) >> np.uint32(
            bpd.bit_length() - 1)).astype(np.int64)
        counts = np.bincount(owner, minlength=M)
        per = max(1 << max(int(counts.max()) - 1, 0).bit_length(),
                  self.kern.F_min)
        routed = np.full(M * per, -1, np.int32)
        order = np.argsort(owner, kind="stable")
        starts = np.cumsum(counts) - counts
        rank = np.arange(kk.shape[0], dtype=np.int64) - np.repeat(
            starts, counts)
        routed[owner[order] * per + rank] = kk[order]
        runs = []
        for j in range(M):
            off = arrs[off_key].at(0, j)
            kj = torch.from_numpy(routed[j * per:(j + 1) * per]).to(off.device)
            _mt.inc("lookup.dispatches")
            lo, ln = self.kern._runs_fn(kind, off, None,
                                        arrs[tbl_key].at(0, j), None, kj)
            runs.append((lo, ln, int(ln.to(torch.int64).sum())))
        _mt.inc("lookup.hops")
        CH = self.kern.CH
        at = [0] * M
        now = int(now)
        while any(at[j] < runs[j][2] for j in range(M)):
            got = []
            for j in range(M):
                lo, ln, total = runs[j]
                if at[j] >= total:
                    continue
                _mt.inc("lookup.dispatches")
                rows, live = self.kern._emit_fn(
                    kind, arrs[emit_key].at(0, j), None, lo, ln, at[j], now,
                    CH)
                rows, live = rows.cpu().numpy(), live.cpu().numpy()
                got.append(rows[live])
                at[j] = min(at[j] + CH, total)
            out = np.concatenate(got) if got else np.zeros((0, 1), np.int32)
            if out.shape[0]:
                yield out
