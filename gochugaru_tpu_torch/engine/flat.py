"""The flat check kernel: statically-unrolled probe programs over hash
indexes and the precomputed membership closure.

This is the TPU-shaped replacement for the two-phase walk in
engine/device.py.  The round-2 engine was correct everywhere and fast
nowhere (~16k checks/sec true device rate): per query it ran a capped
frontier walk with device-side sort/dedup (Phase A) plus a sequential
scan-based subgraph BFS (Phase B) — hundreds of *dependent* scalar steps
per check.  The flat kernel removes every per-query loop:

- **membership** is precomputed: store/closure.py flattens the transitive
  member→group closure once per revision; a userset grant test is one
  4-key hash probe into the flattened table (engine/hash.py);
- **rewrite structure** is unrolled at trace time: each permission's
  expression tree becomes straight-line code; arrows gather a capped,
  hash-indexed child block and recurse on the child axis (acyclic schemas
  unroll exactly; recursive ones unroll to a budget and mark deeper
  queries possible → host oracle);
- every probe site is a batch-wide vectorized gather: the whole dispatch
  is ~a few hundred *data-independent* gather/compare steps regardless of
  batch size, so throughput scales with batch until HBM bandwidth.

Semantics are identical to the legacy engine (differentially tested
against engine/oracle.py): two Kleene planes (definite, possible),
caveats gated per edge through the on-device CEL VM with merged
stored/query context, expiration via the closure's max-min semiring at
membership level and per-edge gates at leaf level, wildcard and userset
subjects, permission-valued userset conservatism (us_perm/pus), and
overflow flags that route capped queries to the host oracle.  The one
intentional degradation: caveats on *membership* edges decide closure
containment per query on the host (possible-plane), because the closure
is precomputed without query context.

Replaces the evaluation behind the reference's CheckBulkPermissions
(client/client.go:238-266).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..caveats.device import make_tri_fn
from ..schema.compiler import CompiledSchema
import torch

from . import kernels as _K
from .hash import (
    HashIndex,
    _ceil_pow2,
    build_aligned,
    build_hash,
    build_range_hash,
    bucket_of,
    interleave_buckets,
    interleave_rows,
    probe_block,
    probe_range,
    probe_rows,
    slice_blocks,
    take_in_bounds,
)
from .consts import device_const
from .explain import (
    WIT_DIRECT, WIT_FOLD, WIT_LEVEL_SHIFT, WIT_REWRITE, WIT_SELF, WIT_TPROBE,
    WIT_USERSET, WIT_WILDCARD,
)
from .packed import decode_block as _pk_decode
from .plan import DevicePlan, EngineConfig, ExprIR, _eval_cyclic_pairs


# ---------------------------------------------------------------------------
# static metadata (part of the traced-function cache key)
# ---------------------------------------------------------------------------

#: packed query-matrix row layout (int32[QM_ROWS, B]): the kernel takes
#: ONE batched query argument — q_self rides as 0/1, row 7 is padding so
#: the leading dim stays pow2.  Builders: DeviceEngine.flat_fn_and_args,
#: ShardedEngine._dispatch_flat (data axis = axis 1 there).
QM_LAYOUT = ("q_res", "q_perm", "q_subj", "q_srel1_dense", "q_wc",
             "q_ctx", "q_self", "q_perm_k1")
QM_ROWS = len(QM_LAYOUT)


@lru_cache(maxsize=128)
def _dense_np(t: Tuple[int, ...]) -> np.ndarray:
    return np.asarray(t, np.int32) if t else np.full(1, -1, np.int32)


def build_qm(queries: Dict[str, "np.ndarray"], BP: int, meta: "FlatMeta"):
    """The packed QM_LAYOUT matrix from length-B query columns, padded to
    ``BP`` — the ONE builder both the single-chip and sharded dispatchers
    use, so the pad conventions (-1 keys; 0 for srel1/self) cannot drift.

    Slot-bearing rows map through the meta's DENSE slot maps here on the
    host: row 3 carries the dense srel1 (-1 = the subject relation can
    never match a stored key), row 7 the dense k1 id of q_perm (-1 =
    inactive — the root probes miss, programs still evaluate)."""
    return fill_qm(queries, np.empty((QM_ROWS, BP), np.int32), meta)


def fill_qm(queries: Dict[str, "np.ndarray"], qm: np.ndarray, meta: "FlatMeta"):
    """``build_qm`` into a PREALLOCATED [QM_ROWS, BP] int32 buffer.  The
    latency-mode path (engine/latency.py) keeps one staging buffer per
    batch tier and refills it in place, so steady-state small-batch
    dispatch performs zero host-side array allocation."""
    B = queries["q_res"].shape[0]
    k1d = _dense_np(meta.k1_dense)
    k2d = _dense_np(meta.k2_dense)
    qm.fill(-1)
    qm[3] = qm[6] = 0
    qm[0, :B] = queries["q_res"]
    qm[1, :B] = queries["q_perm"]
    qm[2, :B] = queries["q_subj"]
    srel = queries["q_srel"]
    sd = k2d[np.clip(srel, 0, k2d.shape[0] - 1)]
    qm[3, :B] = np.where(srel < 0, 0, np.where(sd >= 0, sd + 1, -1))
    qm[4, :B] = queries["q_wc"]
    qm[5, :B] = queries["q_ctx"]
    qm[6, :B] = queries["q_self"]
    qp = queries["q_perm"]
    qm[7, :B] = np.where(
        qp >= 0, k1d[np.clip(qp, 0, k1d.shape[0] - 1)], -1
    )
    return qm


@dataclass(frozen=True)
class DeltaMeta:
    """Static geometry of the LSM-style delta level (Watch-driven
    incremental re-index, BASELINE config 5).

    A delta-prepared DeviceSnapshot reuses the base revision's resident
    tables untouched and adds small per-view overlays: an adds level
    (probed exactly like the base, OR-ed in) and tombstone sets (exact
    identity keys that void base hits).  All caps/flags here are pow2/
    stable-bucketed so consecutive deltas reuse the compiled kernel."""

    has_adds: bool = False  # any delta primary rows
    e_cap: int = 4  # delta primary hash bucket cap
    e_slots: Tuple[int, ...] = ()  # slots with delta primary rows
    has_tombs: bool = False  # any removed-row identities
    tb_cap: int = 4
    has_us: bool = False  # delta userset-view rows
    us_cap: int = 4  # delta us group-hash bucket cap
    us_fan: int = 1  # delta us max rows per (slot, res)
    us_slots: Tuple[int, ...] = ()
    has_ustomb: bool = False  # tombstoned userset rows
    utb_cap: int = 4
    t_dirty: bool = False  # tombstoned us rows under T-covered slots
    td_cap: int = 4
    has_ar: bool = False  # delta arrow-view rows
    ar_cap: int = 4
    ar_fan: int = 1
    ar_slots: Tuple[int, ...] = ()
    has_artomb: bool = False
    atb_cap: int = 4
    # delta gate-column presence (the delta tables reuse the BASE layouts,
    # so these can only be true when the base flags are)
    e_hascav: bool = False
    e_hasexp: bool = False
    # permission-fold maintenance overlay (engine/fold.py
    # fold_delta_update): folded slots stay on the pf probe pair under a
    # delta — base hits at DIRTY resources are voided and replacement
    # rows probed from small replicated overlay tables
    #: fold maintenance downgraded for the rest of this chain: folded
    #: pairs compile their WALKED programs (which see the dl_* overlays)
    #: instead of the pf probe pair — set when fold_delta_update
    #: declines (eligibility flip / hot-ancestor dirty set / overlay
    #: past its row cap); sticky until compaction re-folds the base
    pf_off: bool = False
    pf_dirty: bool = False  # any dirty (slot, res) keys
    pfd_cap: int = 4
    pf_ovl_e: bool = False  # overlay pf_e rows
    pfo_e_cap: int = 4
    pf_ovl_hascav: bool = False  # overlay layout flags (independent of base)
    pf_ovl_hasuntil: bool = False
    pf_ovl_haswc: bool = False
    pf_ovl_u: bool = False  # overlay pf_u (folded userset) rows
    pfo_u_cap: int = 4
    pfo_u_fan: int = 1
    #: T-index disabled for the rest of this chain (sticky, like pf_off):
    #: membership-closure deltas staled more baked T rows than the dirty
    #: budget covers — the KU path probes the live closure instead
    t_off: bool = False


@dataclass(frozen=True)
class FlatMeta:
    """Static per-snapshot table geometry the kernel closes over.

    Keys are PACKED into ≤2 int32 columns (``N``/``S1`` radices) — every
    probe step then costs 3 gathers (rows + 2 keys) instead of 5, and
    range probes cost 2.  Graphs too large to pack (num_nodes·num_slots ≥
    2³¹) skip the flat engine and use the legacy two-phase kernel.

    Every count is a pow2 BUCKET (padded array length), not an exact row
    count, and the node radix rounds to pow2 — so Watch-driven deltas keep
    the same FlatMeta (and the same compiled kernel) until a table crosses
    a pow2 boundary, instead of recompiling on every revision."""

    N: int  # node-id packing radix: pow2 ≥ num_nodes
    S1: int  # num_slots + 1 (srel1 radix)
    e_cap: int
    e_n: int  # padded primary-row bucket
    usr_cap: int  # userset (rel, res) range-group table
    usr_gn: int
    us_rows: int
    arr_cap: int  # arrow (rel, res) range-group table
    arr_gn: int
    ar_rows: int
    cl_cap: int  # flattened closure pair table
    cl_n: int
    has_closure: bool
    pus_cap: int
    pus_n: int
    ovf_cap: int  # closure-overflow source table
    ovf_n: int
    has_ovf: bool
    #: ((rel_slot, max_fanout_pow2), ...) actual max children per (slot,
    #: resource) in the arrow view — folder trees have 1 parent, so the
    #: unrolled lattice stays narrow regardless of the config cap
    ar_fanout_by_slot: Tuple[Tuple[int, int], ...] = ()
    #: per-view "any caveated rows" / "any expiring rows" flags: views
    #: without them compile trivial gates (no CEL VM, no expiry gathers)
    e_hascav: bool = False
    e_hasexp: bool = False
    us_hascav: bool = False
    us_hasexp: bool = False
    ar_hascav: bool = False
    ar_hasexp: bool = False
    #: slots with ≥1 row in the primary / userset views — leaf code for a
    #: slot with no data compiles to nothing
    e_slots: Tuple[int, ...] = ()
    us_slots: Tuple[int, ...] = ()
    #: any wildcard-subject edges at all / any wildcard closure sources —
    #: both False in most worlds, erasing the wildcard probe sites
    has_wc_edges: bool = False
    has_wc_closure: bool = False
    #: ((rel_slot, max_userset_edges_pow2), ...) actual max userset grants
    #: per (slot, resource) — org⟶2 teams means 2 closure probes, not the
    #: config cap of 8
    us_fanout_by_slot: Tuple[Tuple[int, int], ...] = ()
    #: T-index: the materialized (slot·N+res, member-key) → until-values
    #: join of userset edges with the closure — a userset grant test is
    #: ONE probe.  ``t_slots`` are the slots it covers (no caveated /
    #: permission-valued userset rows); the dynamic root leaf skips the
    #: KU path when it covers every us-bearing slot of the dispatch
    has_tindex: bool = False
    t_cap: int = 4
    t_n: int = 8
    t_slots: Tuple[int, ...] = ()
    #: any permission-valued userset rows in THIS snapshot (drives whether
    #: the interleaved userset view carries a ``perm`` column)
    us_hasperm: bool = False
    #: block-slice layout active (bucket-ordered interleaved tables probed
    #: with one contiguous [cap, w] slice per query — see engine/hash.py)
    blockslice: bool = False
    #: bucket-ALIGNED tables (engine/hash.py build_aligned): per aligned
    #: table, (tbl_key, w, caps) — ``caps`` is the width-stratum ladder:
    #: arrays ``{tbl_key}_al`` / ``{tbl_key}_als`` / ``{tbl_key}_als2``…
    #: replace the off+interleave pair, and a probe is one row gather
    #: per level (each salted by its level index)
    aligned: Tuple[Tuple[str, int, Tuple[int, ...]], ...] = ()
    #: HBM-lean bit-packed tables (engine/packed.py): (tbl_key, spec)
    #: per packed table — the named array holds uint16 lanes and every
    #: probe site decodes with fused shift/mask ops right after its
    #: gather.  Specs derive from geometry + replicated domains, so the
    #: partitioned multihost build agrees on them before building
    packed: Tuple[Tuple[str, Tuple], ...] = ()
    #: packed bucket-offset arrays: (off_key, anchor_shift) — the named
    #: array holds uint16 residuals and ``{off_key}_a`` the int32 block
    #: anchors; off[i] == anchor[i >> shift] + residual[i]
    packed_off: Tuple[Tuple[str, int], ...] = ()
    #: reverse-CSR lookup index (engine/rev.py; the frontier-SpMV tables
    #: engine/spmv.py hops over): ``rvx``/``rv_off`` (all edges keyed by
    #: k2 — reverse reachability), ``rax``/``ra_off`` (arrow rows keyed
    #: by child — reverse tupleset traversal), and ``fwx``/``fw_off``
    #: (all edges keyed by k1 — forward enumeration for LookupSubjects).
    #: Caps are pow2 max bucket occupancies — the frontier kernel's
    #: in-bucket bisect depth, not probe unroll counts
    has_rev: bool = False
    has_fw: bool = False
    rv_cap: int = 4
    ra_cap: int = 4
    fw_cap: int = 4
    #: LSM delta level riding on this snapshot's base tables (None = the
    #: snapshot was fully prepared)
    delta: Optional[DeltaMeta] = None
    #: tables are bucket-sharded / stacked for shard_map (the kernel must
    #: be built with the matching ``axis``; make_flat_fn enforces this)
    sharded: bool = False
    #: partitioned-SERVE placement (engine/partition.py partition_feed
    #: with serve="routed"): only the primary/fold point tables (ehx,
    #: pfx) are split along the model axis — everything else (userset /
    #: arrow / T / closure / pus / ovf / pfu / csr / rc stacked tables)
    #: is membership- or group-structure-sized and placed WHOLE on every
    #: device, mirroring the host partition (membership subgraph
    #: replicated, edges partitioned).  The kernel then resolves those
    #: tables' bucket owners arithmetically (no collective at the site),
    #: so the only remaining collectives are the e/pf probes at derived
    #: keys — and an owner-ROUTED batch, whose root probes are local by
    #: construction, dispatches with no collectives at all
    part_serve: bool = False
    #: flattened recursive hierarchies (the resource-side Leopard index):
    #: ((ts_slot, group_cap, fan), ...) — per eligible tupleset, the
    #: ancestor-closure tables rc{ts}_off / rc{ts}gx / rc{ts}x exist and
    #: the kernel evaluates ``perm = ∃ ancestor: rest`` in ONE level
    rc_slots: Tuple[Tuple[int, int, int], ...] = ()
    #: longest arrow chain in the DATA (longest path over the ar view),
    #: or -1 when the arrow graph has a cycle / exceeded the probe cap.
    #: Bounds recursion unrolling: beyond this many arrow hops there are
    #: no real children, so deeper unrolls are provably dead — a schema-
    #: recursive folder tree of depth 4 compiles 4 levels, not the full
    #: flat_recursion budget.  Pow2-bucketed for delta stability
    ar_data_depth: int = -1
    #: dense slot remap (SlotMaps): raw slot → packed k1 / k2 id, -1 =
    #: inactive (a key using it can never match).  Static kernel sites
    #: map at trace time; the query matrix maps on the host (build_qm).
    #: This is what moves the int32 cliff from schema-slot count to
    #: ACTIVE-slot count
    k1_dense: Tuple[int, ...] = ()
    k2_dense: Tuple[int, ...] = ()
    #: permission fold (engine/fold.py P-index): (type_name, perm_slot)
    #: pairs whose BASE evaluation is the pf_e probe + the pf_u range
    #: slice intersected with the closure — their programs compile to
    #: nothing when no delta level rides the base (a delta reverts to
    #: the walked program, which keeps add/tombstone semantics exact
    #: without incremental fold maintenance)
    fold_pairs: Tuple[Tuple[str, int], ...] = ()
    pf_e_cap: int = 4
    pf_u_cap: int = 4  # pf_u group-table probe cap
    pf_u_fan: int = 1  # max folded groups per (slot, resource), pow2
    #: csr closure-by-source view (the fold's subject side): probe cap of
    #: the source-keyed group table and max closure rows per source.
    #: The kernel slices the subject's group closure ONCE per query and
    #: intersects it with each pf_u group list in registers — the
    #: sorted-key-column intersection that replaces both the dense
    #: (resource × member) T-join and per-group hash probes
    pf_s_cap: int = 4
    pf_s_fan: int = 1
    #: DIRECT range lookup for the fold's pf_u/csr views (single-chip):
    #: ``pfu_start``/``csr_start`` offset arrays indexed by the packed
    #: key itself — two element gathers per range instead of a hash
    #: probe (~14× cheaper on gather-poor CPUs; measured in-repo).
    #: False = the key space outgrew the budget, hash group tables used.
    #: The csr side has its own flag: membership-delta chains flip it to
    #: the hash layout (rebuilding the dense offset array per revision
    #: costs more than the write budget; a full prepare restores direct)
    pf_direct: bool = False
    pf_s_direct: bool = False
    #: every pf_u row / closure row is unexpiring on both planes: the
    #: kernel skips the until-column slices and plane masks entirely
    pf_u_alllive: bool = False
    pf_s_alllive: bool = False
    pf_hascav: bool = False
    pf_hasuntil: bool = False
    pf_haswc: bool = False
    pf_has_e: bool = False
    pf_has_u: bool = False


def placement_split(dsnap) -> Dict[str, int]:
    """{"total", "sharded", "replicated"} resident device-table bytes:
    of this snapshot's tensors, how many a routed partitioned serve would
    SPLIT across devices -- the primary/fold-point tables (ehx*, pfx*)
    and their width-stratum levels -- versus replicate whole on every
    device.  The tuner's placement rule (tune/) reads it to decide
    whether routing frees enough device memory to be worth it: a
    snapshot dominated by membership-sized replicated tables gains
    nothing from partitioning.  A snapshot on a mesh (parallel/sharded.py
    MeshTensor tables) reports its own split: the tables placed across
    the model axis versus those held whole on every position."""
    total = 0
    sharded = 0
    for k, a in dsnap.arrays.items():
        nb = int(a.nbytes)
        total += nb
        split = getattr(a, "sharded", None)
        if split is None:
            split = k.startswith("ehx") or k.startswith("pfx")
        if split:
            sharded += nb
    return {
        "total": total, "sharded": sharded,
        "replicated": total - sharded,
    }


def _gate_cols(hascav: bool, hasexp: bool) -> list:
    return (["cav", "ctx"] if hascav else []) + (["exp"] if hasexp else [])


def _lay(names: list) -> Dict[str, int]:
    return {n: i for i, n in enumerate(names)}


def e_layout(meta: "FlatMeta") -> Dict[str, int]:
    """Column layout of the interleaved primary-edge bucket table."""
    return _lay(["k1", "k2"] + _gate_cols(meta.e_hascav, meta.e_hasexp))


def us_layout(meta: "FlatMeta") -> Dict[str, int]:
    """Column layout of the interleaved userset-view row table."""
    return _lay(
        ["subj", "srel"]
        + _gate_cols(meta.us_hascav, meta.us_hasexp)
        + (["perm"] if meta.us_hasperm else [])
    )


def ar_layout(meta: "FlatMeta") -> Dict[str, int]:
    """Column layout of the interleaved arrow-view row table."""
    return _lay(["child"] + _gate_cols(meta.ar_hascav, meta.ar_hasexp))


def _round_cap(c: int) -> int:
    """Hash-probe caps bucket to pow2 with a floor of 4: a few extra
    unrolled probe steps are cheaper than recompiling the kernel every
    time a delta nudges a table's max bucket occupancy between 1, 2, 4."""
    for p in (4, 8, 16, 32):
        if c <= p:
            return p
    return c


def _pad(a: np.ndarray, size: int, fill) -> np.ndarray:
    """int32 ``a`` padded with ``fill`` to ``size`` entries."""
    out = np.full(size, fill, np.int32)
    out[: a.shape[0]] = a
    return out


def _round_fan(c: int) -> int:
    """Arrow/userset fan-outs bucket to pow2 with NO floor: a folder tree
    with 1 parent must keep its width-1 lattice (4^depth would blow the
    flat_max_width budget and degrade deep grants to host fallbacks)."""
    for p in (1, 2, 4, 8, 16, 32):
        if c <= p:
            return p
    return c


def _pack(a: np.ndarray, radix: int, b) -> np.ndarray:
    from ..native.sort import pack32

    return pack32(a, b, radix)


def _uniq_small(parts, domain: int) -> np.ndarray:
    """Sorted unique over int columns whose values live in [0, domain)
    (slot ids): an occupancy scatter + flatnonzero instead of the
    concatenate+sort np.unique pays — O(E) with no 30M-row sort.
    Output is int64, matching np.unique of int64-cast inputs."""
    occ = np.zeros(max(domain, 1), bool)
    for p in parts:
        if p.shape[0]:
            occ[p] = True
    return np.flatnonzero(occ)


@dataclass(frozen=True)
class SlotMaps:
    """Dense remap of the ACTIVE slots — the packing radices cover only
    slots that actually appear in keys, not the schema's full slot count.
    A 100M-node world with 15 active slots packs fine even when the
    schema declares hundreds (the int32 cliff moves from
    pow2(nodes)·(schema slots+1) to pow2(nodes)·(active slots+1)).

    ``k1[slot]`` → dense row-key id (slots with stored/folded rows;
    queried permissions map through the same table, -1 = can never
    match).  ``k2[slot]`` → dense subject-relation id (slots appearing
    in any subject-relation position); ``S1`` = len(active k2) + 1, the
    k2 radix (0 stays "direct subject")."""

    k1: np.ndarray  # int32[num_slots] → dense id or -1
    k2: np.ndarray  # int32[num_slots] → dense id or -1
    k1_raw: np.ndarray  # int32[n_k1] dense → raw slot (inverse)
    k2_raw: np.ndarray  # int32[S1-1] dense → raw slot (inverse)
    n_k1: int
    S1: int


def _active_maps(snap, cl, extra_k1) -> SlotMaps:
    """The dense slot maps of one snapshot (+closure, + fold slots).
    Slot values live in [0, num_slots): uniques come from an occupancy
    scatter (_uniq_small) — no concatenated 30M-row sort."""
    ns = max(snap.num_slots, 1)
    k1_raw = _uniq_small([
        snap.e_rel, snap.us_rel, snap.ar_rel,
        np.asarray(sorted(extra_k1), np.int64),
    ], ns)
    # us_srel covers every stored subject-relation by construction (the
    # userset view IS the primary rows with srel1 > 0), so the k2 actives
    # need no O(E) pass over e_srel1
    k2_raw = _uniq_small([
        snap.us_srel,
        cl.c_srel1[cl.c_srel1 > 0] - 1,
        cl.c_grel,
        snap.pus_r,
        cl.ovf_srel1[cl.ovf_srel1 > 0] - 1,
    ], ns)
    k1 = np.full(ns, -1, np.int32)
    k1[k1_raw] = np.arange(k1_raw.shape[0], dtype=np.int32)
    k2 = np.full(ns, -1, np.int32)
    k2[k2_raw] = np.arange(k2_raw.shape[0], dtype=np.int32)
    return SlotMaps(
        k1=k1, k2=k2,
        k1_raw=k1_raw.astype(np.int32), k2_raw=k2_raw.astype(np.int32),
        n_k1=int(k1_raw.shape[0]),
        S1=int(k2_raw.shape[0]) + 1,
    )


def _m_srel1(maps: SlotMaps, srel1: np.ndarray) -> np.ndarray:
    """Raw srel1 column (0 = direct, else slot+1) → dense srel1.  One
    fused native pass when available (numpy chain fallback, identical
    values)."""
    from ..native import lib as _native_lib

    L = _native_lib()
    n = int(srel1.shape[0])
    if L is not None and n >= (1 << 16):
        import ctypes

        s = np.ascontiguousarray(srel1, np.int32)
        k2 = np.ascontiguousarray(maps.k2, np.int32)
        out = np.empty(n, np.int32)
        p32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        L.gi_msrel1(
            p32(s), p32(k2), ctypes.c_int64(k2.shape[0]),
            ctypes.c_int64(n), p32(out),
        )
        return out
    return np.where(
        srel1 == 0, 0, maps.k2[np.clip(srel1 - 1, 0, None)] + 1
    ).astype(np.int32)


def _node_radix(snap, maps: SlotMaps) -> Optional[int]:
    """The node packing radix N with delta headroom, or None when the
    DENSE keys still don't fit int32 (such graphs use the legacy
    engine)."""
    N = _ceil_pow2(max(snap.num_nodes, 1), 8)
    width = max(maps.n_k1, maps.S1, 1)
    if N * width >= 2**31:
        return None
    # headroom for Watch-driven deltas: new nodes (fresh users/resources)
    # must stay under the packing radix or every delta-prepare bails to a
    # full rebuild — double N whenever the key space still fits int32
    if N < 2 * snap.num_nodes and 2 * N * width < 2**31:
        N *= 2
    return N


def _view_flags_of(snap) -> Dict[str, bool]:
    return dict(
        e_hascav=bool(snap.e_caveat.any()),
        e_hasexp=bool(snap.e_exp.any()),
        us_hascav=bool(snap.us_caveat.any()),
        us_hasexp=bool(snap.us_exp.any()),
        us_hasperm=bool(snap.us_perm.any()),
        ar_hascav=bool(snap.ar_caveat.any()),
        ar_hasexp=bool(snap.ar_exp.any()),
    )


def rc_candidates(compiled: CompiledSchema, plan: DevicePlan):
    """Self-recursive arrow hierarchies eligible for ancestor flattening
    (the resource-side Leopard index): programs of shape
    ``perm = union(rest..., ts->perm)`` on a type whose ``ts`` edges stay
    WITHIN the type (pure hierarchy, e.g. folder.parent).  Returns
    {(type_name, perm_slot): (ts_slot, rest_ir)} where ``rest_ir`` is the
    union of the non-recursive children — the flattened evaluation is
    ``perm(n) = ∃ a ∈ ancestors_ts*(n): rest(a)`` with the path's
    admissibility folded through the closure semiring."""
    out = {}
    for (tname, tid, slot, expr) in plan.topo_programs:
        if expr[0] != "union":
            continue
        ct = compiled.types[compiled.type_ids[tname]]
        rest = []
        ts_slots = set()
        ok = True
        for child in expr[1]:
            if child[0] == "arrow" and plan.ts_slots[child[1]] >= 0:
                ts_slot = plan.ts_slots[child[1]]
                if child[2] == slot:
                    # the recursive child: its tupleset must only reach
                    # this same type (direct subjects; arrows traverse
                    # ellipsis subjects only)
                    relation = ct.relations.get(ts_slot)
                    if relation is None or any(
                        a.type_id != tid or a.relation_slot >= 0
                        or a.wildcard
                        for a in relation.allowed
                    ):
                        ok = False
                        break
                    ts_slots.add(ts_slot)
                    continue
            # non-recursive children must not re-reach this slot at all
            if _ir_refs_slot(child, slot):
                ok = False
                break
            rest.append(child)
        if ok and len(ts_slots) == 1 and rest:
            out[(tname, slot)] = (next(iter(ts_slots)), ("union", tuple(rest)))
    return out


def cfg_budget(config: EngineConfig) -> int:
    """Arrow hops the unrolled recursion can cover exactly."""
    return config.flat_recursion


def _ir_refs_slot(ir: ExprIR, slot: int) -> bool:
    tag = ir[0]
    if tag == "ref":
        return ir[1] == slot
    if tag == "arrow":
        return ir[2] == slot
    if tag in ("union", "inter"):
        return any(_ir_refs_slot(c, slot) for c in ir[1])
    if tag == "excl":
        return _ir_refs_slot(ir[1], slot) or _ir_refs_slot(ir[2], slot)
    return False


def _arrow_closure(snap, ts_slot: int, *, per_node_cap: int = 64,
                   max_hops: int = 64):
    """Reflexive-transitive ancestor closure over ONE tupleset's arrow
    edges, with the membership closure's two-plane max-min expiry
    semiring folded along paths.  Returns (src, anc, d_until, p_until)
    sorted by src — or None when the slot's hierarchy has a data cycle,
    doesn't converge, or some node's ancestor set exceeds the cap
    (the recursive kernel path still answers those worlds)."""
    from ..store.closure import NEVER, NO_EXP

    m = snap.ar_rel == ts_slot
    src = snap.ar_res[m].astype(np.int64)
    dst = snap.ar_child[m].astype(np.int64)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    cav = snap.ar_caveat[m][keep]
    exp = snap.ar_exp[m][keep]
    w = np.where(exp == 0, np.int64(NO_EXP), exp.astype(np.int64)).astype(np.int32)
    e_d = np.where(cav == 0, w, NEVER)
    e_p = w
    order = np.argsort(src, kind="stable")
    e_src, e_dst = src[order], dst[order]
    e_d, e_p = e_d[order], e_p[order]

    from ..store.closure import _expand_join

    from ..native.sort import lexsort2

    def dedup(s, a, d, p):
        # native parallel lexsort, same reason as store/closure.py
        # group_max: numpy lexsort is tens of seconds at big pair counts
        o = lexsort2(s.astype(np.int32), a.astype(np.int32))
        s, a, d, p = s[o], a[o], d[o], p[o]
        first = np.ones(s.shape[0], bool)
        first[1:] = (s[1:] != s[:-1]) | (a[1:] != a[:-1])
        st = np.nonzero(first)[0]
        return (
            s[first], a[first],
            np.maximum.reduceat(d, st), np.maximum.reduceat(p, st),
        )

    c_s, c_a, c_d, c_p = dedup(e_src, e_dst, e_d, e_p)
    n_s, n_a, n_d, n_p = c_s, c_a, c_d, c_p
    for _ in range(max_hops):
        if n_s.size == 0:
            break
        reps, ii = _expand_join(e_src, n_a)
        if reps.size == 0:
            break
        j_s = n_s[reps]
        j_a = e_dst[ii]
        j_d = np.minimum(n_d[reps], e_d[ii])
        j_p = np.minimum(n_p[reps], e_p[ii])
        if (j_s == j_a).any():
            return None  # data cycle: keep the recursive path
        m_s = np.concatenate([c_s, j_s])
        m_a = np.concatenate([c_a, j_a])
        m_d = np.concatenate([c_d, j_d])
        m_p = np.concatenate([c_p, j_p])
        new_s, new_a, new_d, new_p = dedup(m_s, m_a, m_d, m_p)
        if new_s.shape[0] == c_s.shape[0] and (new_d == c_d).all() and (
            new_p == c_p
        ).all():
            break
        # the next frontier: improved/new pairs only (semi-naive)
        pk_old = c_s * np.int64(2**31) + c_a
        pk_new = new_s.astype(np.int64) * np.int64(2**31) + new_a
        pos = np.searchsorted(pk_old, pk_new)
        posc = np.clip(pos, 0, max(pk_old.shape[0] - 1, 0))
        found = (pk_old.shape[0] > 0) & (pk_old[posc] == pk_new)
        old_d = np.where(found, c_d[posc], NEVER)
        old_p = np.where(found, c_p[posc], NEVER)
        imp = (new_d > old_d) | (new_p > old_p)
        n_s, n_a = new_s[imp], new_a[imp]
        n_d, n_p = new_d[imp], new_p[imp]
        c_s, c_a, c_d, c_p = new_s, new_a, new_d, new_p
    else:
        return None  # hop budget exhausted

    # STRICT ancestors only: the kernel always evaluates `rest` at the
    # node itself through a dedicated reflexive lane, so a range miss
    # simply means "self only"
    if c_s.size:
        counts = np.bincount(c_s.astype(np.int64))
        if counts.max() > per_node_cap:
            return None
    return c_s.astype(np.int32), c_a.astype(np.int32), c_d, c_p


def _arrow_data_depth(snap, cap: int = 64, ts_slot: Optional[int] = None) -> int:
    """Longest path, in arrow hops, over the DATA's res→child arrow edges
    (all tupleset relations together, or just ``ts_slot``'s); -1 on a
    data cycle or past ``cap``.  Bellman-style relaxation over the
    res-grouped view: converges in (true depth) rounds on a DAG — folder
    trees are ~log-depth, so this is a handful of O(AR) numpy passes at
    prepare time.  The result is bucketed to the next EVEN depth
    (rounding UP keeps every use sound): FlatMeta is the kernel-cache
    key, so a tree deepening 4→5 must not recompile on every prepare —
    and pow2 granularity would round the common depth 5 up to 8, keeping
    60% of the dead unroll the recursion cut exists to remove."""
    if ts_slot is not None:
        m = snap.ar_rel == ts_slot
        res = snap.ar_res[m].astype(np.int64)
        child = np.ascontiguousarray(snap.ar_child[m], np.int64)
    else:
        res = snap.ar_res.astype(np.int64)
        child = np.ascontiguousarray(snap.ar_child, np.int64)
    AR = int(res.shape[0])
    if AR == 0:
        return 0
    order = np.argsort(res, kind="stable")
    res_s, child_s = res[order], child[order]
    first = np.ones(AR, bool)
    first[1:] = res_s[1:] != res_s[:-1]
    starts = np.nonzero(first)[0]
    uniq_res = res_s[starts]
    childc = np.clip(child_s, 0, max(snap.num_nodes - 1, 0))
    cvalid = child_s >= 0
    depth = np.zeros(snap.num_nodes, np.int32)
    for _ in range(cap):
        vals = np.where(cvalid, depth[childc] + 1, 0)
        upd = np.maximum.reduceat(vals, starts)
        if (upd <= depth[uniq_res]).all():
            d = int(depth.max())
            return d + (d & 1)
        depth[uniq_res] = np.maximum(depth[uniq_res], upd)
    return -1


def _run_maxes(gk: np.ndarray, glo: np.ndarray, ghi: np.ndarray, N: int,
               inv: np.ndarray):
    """Per-RAW-slot max run length of a packed (dense_slot·N + res) range
    index (pow2-bucketed so retraces are rare).  ``inv`` maps the packed
    DENSE slot ids back to raw slots (SlotMaps.k1_raw) — the kernel's
    static gating is raw-slot keyed."""
    fans: Dict[int, int] = {}
    if gk.shape[0]:
        slots_of = gk.astype(np.int64) // N
        lens = (ghi - glo).astype(np.int64)
        first = np.ones(gk.shape[0], bool)
        first[1:] = slots_of[1:] != slots_of[:-1]
        starts = np.nonzero(first)[0]
        for s, m in zip(slots_of[starts], np.maximum.reduceat(lens, starts)):
            fans[int(inv[int(s)])] = _round_fan(int(m))
    return tuple(sorted(fans.items()))


def _tindex_join(
    snap, config: EngineConfig, cl, us_gk, cl_k1, cl_k2, pus_k,
    maps: SlotMaps,
):
    """The T-index join (userset edges ⋈ closure-by-target) shared by both
    layout builders: returns (T_k1, T_k2, T_d, T_p, t_slots) or
    None when disabled/ineligible/oversized.  For slots whose userset rows
    carry no caveats and no permission-valued subjects, {edge expiry ×
    closure semiring} folds into ONE (slot·N+res, member-key) →
    until-values table."""
    from ..store.closure import NO_EXP

    if not (config.flat_tindex and snap.us_rel.shape[0]):
        return None
    ok = (snap.us_caveat == 0) & (snap.us_perm == 0)
    pe_all = _pack(snap.us_subj, maps.S1, maps.k2[snap.us_srel] + 1)
    if snap.pus_n.shape[0]:
        pus_sorted = np.sort(pus_k)
        pos = np.clip(
            np.searchsorted(pus_sorted, pe_all), 0, pus_sorted.shape[0] - 1
        )
        ok &= ~(pus_sorted[pos] == pe_all)
    bad_slots = np.unique(snap.us_rel[~ok])
    elig = ~np.isin(snap.us_rel, bad_slots)
    if not elig.any():
        return None
    pe = pe_all[elig]
    ek1 = us_gk[elig]
    w = np.where(
        snap.us_exp[elig] == 0, np.int64(NO_EXP),
        snap.us_exp[elig].astype(np.int64),
    ).astype(np.int32)
    cap_rows = config.flat_tindex_factor * max(int(snap.us_rel.shape[0]), 1024)
    # the reference's host SpMM instance of this join is bitwise equal
    # to t_join_core (its own parity test); the port keeps the one join
    from .fold import t_join_core

    got = t_join_core(
        ek1, pe, w, cl_k1, cl_k2, cl.c_d_until, cl.c_p_until, cap_rows
    )
    if got is None:
        return None
    return (
        *got,
        tuple(int(s) for s in _uniq_small([snap.us_rel[elig]], snap.num_slots)),
    )


def _rc_build(
    snap, config: EngineConfig, plan: Optional[DevicePlan], ar_depth: int
):
    """Ancestor closures for every flattenable recursive hierarchy:
    {ts_slot: (src, anc, d_until, p_until, fan)} (engine-level R-index).

    Built only when the DATA is deeper than the recursion budget: within
    the budget, the unrolled recursion is exact and CHEAPER (narrow
    lattices, no closure fetch); beyond it, the flattened form is the
    only device-exact path — either way no host fallback."""
    if plan is None or not config.flat_rc_index:
        return {}
    if 0 <= ar_depth <= cfg_budget(config):
        return {}  # every hierarchy fits the unroll: nothing to flatten
    cands = rc_candidates(snap.compiled, plan)
    out = {}
    for (_tname, _slot), (ts_slot, _rest) in cands.items():
        if ts_slot in out:
            continue
        # per-tupleset depth: one deep hierarchy must not force closure
        # builds for shallow ones the recursion already answers exactly
        slot_depth = _arrow_data_depth(snap, ts_slot=ts_slot)
        if 0 <= slot_depth <= cfg_budget(config):
            continue
        built = _arrow_closure(snap, ts_slot)
        if built is None:
            continue
        src, anc, d_until, p_until = built
        counts = np.bincount(src.astype(np.int64)) if src.size else np.zeros(1)
        out[ts_slot] = (src, anc, d_until, p_until, _round_fan(int(counts.max())))
    return out


def _fold_packed(fr, snap, maps: SlotMaps, N: int, config: EngineConfig):
    """Dense-packed fold arrays shared by both layout builders:
    (pf_k1, pf_k2, pf_subj, (u_k1, u_gk, u_until, u_fan), flags) or None
    when some resource's folded group fan exceeds the cap (the fold then
    declines; the walked path answers).  Fold rows carry RAW int64
    (subj·(num_slots+1)+srel1) identity keys — decomposed here and
    repacked with the dense radices.  The u side is the reachability-
    pruned (resource, group) table of fold_userset_rows: the member
    closure is intersected at probe time, never joined in."""
    from ..store.closure import NO_EXP
    from .fold import fold_userset_rows

    u_k1, u_gk, u_until = fold_userset_rows(fr, N, maps)
    u_fan = 0
    if u_k1.shape[0]:
        _, counts = np.unique(u_k1, return_counts=True)
        u_fan = int(counts.max())
        if u_fan > config.flat_fold_u_fan_cap:
            return None
    S1_raw = snap.num_slots + 1
    pf_subj = (fr.e_k2 // S1_raw).astype(np.int32)
    pf_srel1 = (fr.e_k2 % S1_raw).astype(np.int32)
    pf_k1 = _pack(maps.k1[fr.e_slot], N, fr.e_res)
    pf_k2 = _pack(pf_subj, maps.S1, _m_srel1(maps, pf_srel1))
    flags = dict(
        pf_hascav=bool((fr.e_cav != 0).any()),
        pf_hasuntil=bool((fr.e_until != NO_EXP).any()),
    )
    return pf_k1, pf_k2, pf_subj, (u_k1, u_gk, u_until, _round_fan(u_fan)), flags


class ClosureHostState:
    """Per-prepared-snapshot host state for the membership-delta path
    (build_delta_arrays): the store-level closure advance state plus the
    reverse indexes the engine needs to keep the device tables honest.

    ``used`` is the BASE revision's userset-subject key set and stays the
    chain's classification authority: every advance classifies delta rows
    against it, so the maintained closure covers the base's used-superset
    even when a chain delta removes a userset's last referencing row.
    That superset is probe-equivalent (closure rows of a dereferenced
    group can only be reached through a userset row citing the group, and
    none exist) and keeps later re-references exact — the group's rows
    were maintained all along.  ``t_pe``/``t_k1`` map raw packed group
    keys of T-covered userset rows to their dense (slot·N + res) keys:
    the rows whose baked T-index entries go stale when a group's closure
    changes."""

    __slots__ = ("st", "used", "t_pe", "t_k1")

    def __init__(self, st, used, t_pe, t_k1):
        self.st = st
        self.used = used
        self.t_pe = t_pe
        self.t_k1 = t_k1


def _closure_host_state(snap, cl, config: EngineConfig, us_gk, t_slots):
    """Build the advance-ready closure state at full-prepare time."""
    from ..store.closure import build_closure_state

    used = getattr(snap, "us_used_keys", None)
    if used is None:
        return None
    num_slots = snap.num_slots
    if t_slots and snap.us_rel.shape[0]:
        elig = np.isin(snap.us_rel, np.asarray(t_slots, np.int64))
        pe = (
            snap.us_subj[elig].astype(np.int64) * (num_slots + 1)
            + snap.us_srel[elig] + 1
        )
        from ..native.sort import sortperm_words, take32, take64

        order = sortperm_words([pe], (pe,))
        t_pe, t_k1 = take64(pe, order), take32(us_gk[elig], order)
    else:
        t_pe = np.zeros(0, np.int64)
        t_k1 = np.zeros(0, np.int32)
    return ClosureHostState(
        build_closure_state(
            snap, cl, per_source_cap=config.closure_source_cap
        ),
        used, t_pe, t_k1,
    )


def _pf_starts(keys: np.ndarray, size: int) -> np.ndarray:
    """Offset array of a key-sorted row set over a dense key domain:
    ``start[k] .. start[k+1]`` is key ``k``'s row range."""
    counts = np.bincount(keys, minlength=size)
    st = np.zeros(size + 1, np.int64)
    np.cumsum(counts, out=st[1:])
    return st.astype(np.int32)


def _pf_col(a: np.ndarray, pad: int, fill) -> np.ndarray:
    """One split pf-view row column: [pow2(rows+pad), 1] int32."""
    n = _ceil_pow2(max(a.shape[0] + pad, 1))
    padded = np.full((n, 1), fill, np.int32)
    padded[: a.shape[0], 0] = a
    return padded


def _max_run_sorted(keys: np.ndarray) -> int:
    """Longest equal-key run of a SORTED key column, O(n) with no sort
    (np.unique would re-sort; this sits on the membership-write path)."""
    if keys.shape[0] == 0:
        return 0
    bounds = np.flatnonzero(np.diff(keys)) + 1
    return int(np.diff(
        np.concatenate([[0], bounds, [keys.shape[0]]])
    ).max())


def _pf_view_tables(
    u_k1, u_gk, u_until, u_fan,
    cl_k1, cl_k2, cl_d, cl_p, s_fan,
    *, maps: SlotMaps, N: int, S1: int, fold_slots, config: EngineConfig,
    hk: Optional[Dict] = None,
):
    """Single-chip pf_u / csr view tables: SPLIT 1-wide row columns
    (narrow contiguous slices vectorize ~15× better than wide ones on
    gather-poor CPUs; measured in-repo) with the row range resolved
    DIRECTLY — ``pfu_start``/``csr_start`` offset arrays indexed by the
    packed key itself, two element gathers per range — or through legacy
    hash group tables when the key space is over budget.  Until columns
    are omitted entirely when every row is unexpiring (the common case;
    the kernel then skips the plane masks).  Returns (arrays, meta kw)."""
    from ..store.closure import NO_EXP

    out: Dict[str, np.ndarray] = {}
    pad_u, pad_s = max(64, u_fan), max(64, s_fan)
    out["pfu_gk"] = _pf_col(u_gk, pad_u, -1)
    u_alllive = bool((u_until == NO_EXP).all()) if u_until.shape[0] else True
    if not u_alllive:
        out["pfu_u"] = _pf_col(u_until, pad_u, 0)
    out["csr_gk"] = _pf_col(cl_k2, pad_s, -1)
    s_alllive = (
        bool((cl_d == NO_EXP).all() and (cl_p == NO_EXP).all())
        if cl_k1.shape[0] else True
    )
    if not s_alllive:
        out["csr_d"] = _pf_col(cl_d, pad_s, 0)
        out["csr_p"] = _pf_col(cl_p, pad_s, 0)
    n_f = max(len(fold_slots), 1)
    budget = config.flat_pf_direct_max_entries
    u_direct = n_f * N + 1 <= budget
    s_direct = N * S1 + 1 <= budget
    kw = dict(
        pf_direct=u_direct, pf_s_direct=s_direct,
        pf_u_alllive=u_alllive, pf_s_alllive=s_alllive,
    )
    hk = hk or {}
    if u_direct:
        # remap fold slots to a compact id so pfu_start spans only
        # fold-slots·N entries (the full active-k1 domain would be ~3×)
        fidx = np.full(max(maps.n_k1, 1), -1, np.int64)
        for i, s in enumerate(fold_slots):
            fidx[maps.k1[s]] = i
        u64 = u_k1.astype(np.int64)
        out["pfu_start"] = _pf_starts(fidx[u64 // N] * N + u64 % N, n_f * N)
    else:
        pfu = build_range_hash(u_k1, **hk)
        out["pfu_off"] = pfu.index.off
        out["pfugx"] = interleave_buckets(
            pfu.index, [pfu.gk, pfu.glo, pfu.ghi]
        )
        kw.update(pf_u_cap=_round_cap(pfu.index.cap))
    if s_direct:
        out["csr_start"] = _pf_starts(cl_k1.astype(np.int64), N * S1)
    else:
        csr = build_range_hash(cl_k1, **hk)
        out["csr_off"] = csr.index.off
        out["csrgx"] = interleave_buckets(
            csr.index, [csr.gk, csr.glo, csr.ghi]
        )
        kw.update(pf_s_cap=_round_cap(csr.index.cap))
    return out, kw


# ---------------------------------------------------------------------------
# HBM-lean packing (engine/packed.py): spec derivation + post-pass
# ---------------------------------------------------------------------------


def _until_dom(*arrays) -> Optional[Tuple[int, ...]]:
    """Dictionary domain of until-value columns: the closure semiring
    only ever emits {NEVER, NO_EXP, real timestamps}; almost every world
    has no expiring membership edges, so the whole column fits a 2-bit
    dictionary over {NEVER, -1 (pad), 0, NO_EXP}.  Returns None when
    real timestamps appear (the column stays a 32-bit field)."""
    from ..store.closure import NEVER, NO_EXP

    cand = np.asarray(
        sorted({int(NEVER), -1, 0, int(NO_EXP)}), np.int64
    )
    for a in arrays:
        if a is None or a.shape[0] == 0:
            continue
        v = a.astype(np.int64, copy=False)
        if not bool(np.isin(v, cand).all()):
            return None
    return tuple(int(c) for c in cand)


def _pack_domains(snap, config: EngineConfig) -> Dict:
    """Replicated per-world pack domains every build path derives
    identically (raw snapshot columns are process-replicated even under
    the multihost partitioned feed — only built TABLES are sharded):
    gate-column value bounds.  Until dictionaries and fan bounds join
    per builder at the sites that compute those arrays globally."""
    mx = lambda *cols: max(
        [int(c.max()) for c in cols if c is not None and c.shape[0]] or [0]
    )
    return {
        "max_cav": mx(snap.e_caveat, snap.us_caveat, snap.ar_caveat),
        "max_ctx": mx(snap.e_ctx, snap.us_ctx, snap.ar_ctx),
        "until": {},
        "fan": {},
    }


#: group tables and the row views their (glo, ghi) ranges index into —
#: candidates per table because the single-chip fold keeps split 1-wide
#: row columns instead of an interleaved view
_PACK_GROUPS = {
    "usgx": ("usx",),
    "argx": ("arx",),
    "pfugx": ("pfux", "pfu_gk"),
    "csrgx": ("csrx", "csr_gk"),
}


def _pack_descs(name: str, meta: FlatMeta, dom: Dict, out: Dict):
    """Column descriptors of one packable table, derived from geometry
    (radices, layout flags, shapes) + the replicated domains — never
    from scanning the built table, so partitioned shard builds agree."""
    from . import packed as pk

    N, S1 = meta.N, meta.S1
    n_k1 = max(int(x) for x in meta.k1_dense) + 1 if meta.k1_dense else 1
    K1 = pk.col_range(-1, max(n_k1, 1) * N - 1)  # (slot, res) point keys
    K2 = pk.col_range(-1, N * S1 - 1)  # (subj, srel1) / closure keys
    NODE = pk.col_range(-1, N - 1)
    I32 = pk.col_range(-(2 ** 31), 2 ** 31 - 1)

    def until(key: str):
        d = dom["until"].get(key)
        return pk.col_dict(d) if d is not None else I32

    def gates(prefix_cav: bool, prefix_exp: bool):
        g = []
        if prefix_cav:
            g += [pk.col_range(-1, dom["max_cav"]),
                  pk.col_range(-1, dom["max_ctx"])]
        if prefix_exp:
            # rel32 expiry stamps are signed (already-expired edges sit
            # below the epoch): full int32 — no byte win on this field,
            # but every OTHER field in the row still packs, and the
            # domain stays provably sound for owned-subset shard builds
            # (a spec must never commit on one process and fail on
            # another — the agreement-before-build contract)
            g += [I32]
        return g

    if name == "ehx":
        return [K1, K2] + gates(meta.e_hascav, meta.e_hasexp)
    if name == "tx":
        return [K1, K2, until("tx"), until("tx")]
    if name == "clx":
        return [K2, K2, until("clx"), until("clx")]
    if name == "pfx":
        return (
            [K1, K2]
            + gates(meta.pf_hascav, False)
            + ([until("pfx")] if meta.pf_hasuntil else [])
        )
    if name in _PACK_GROUPS:
        rows_len = max(
            [int(out[r].shape[0]) for r in _PACK_GROUPS[name] if r in out]
            or [1]
        )
        gk = {"usgx": K1, "argx": K1, "pfugx": K1, "csrgx": K2}[name]
        fan = int(dom["fan"].get(name, 0))
        return [gk, pk.col_range(-1, rows_len - 1), pk.col_delta(0, fan, 1)]
    if name.startswith("rc") and name.endswith("gx"):
        rows_len = int(out[name[:-2] + "x"].shape[0])
        fan = int(dom["fan"].get(name, 0))
        return [NODE, pk.col_range(-1, rows_len - 1), pk.col_delta(0, fan, 1)]
    if name == "rvx":
        return [K2, K1] + gates(meta.e_hascav, meta.e_hasexp)
    if name == "fwx":
        return [K1, K2] + gates(meta.e_hascav, meta.e_hasexp)
    if name == "rax":
        return [NODE, K1] + gates(meta.ar_hascav, meta.ar_hasexp)
    if name == "usx":
        return (
            [NODE, pk.col_range(-1, S1 - 2)]
            + gates(meta.us_hascav, meta.us_hasexp)
            + ([pk.col_range(-1, 1)] if meta.us_hasperm else [])
        )
    if name == "arx":
        return [NODE] + gates(meta.ar_hascav, meta.ar_hasexp)
    if name == "pfux":
        return [K2, until("pfux")]
    if name == "csrx":
        return [K2, until("clx"), until("clx")]
    if name.startswith("rc") and name.endswith("x"):
        return [NODE, until(name), until(name)]
    return None


def _al_key(tbl_key: str, lvl: int) -> str:
    """Device-array name of one aligned width-stratum level."""
    if lvl == 0:
        return tbl_key + "_al"
    return tbl_key + "_als" + ("" if lvl == 1 else str(lvl))


def aligned_levels(arrs: Dict, tbl_key: str, caps: Sequence[int]) -> List:
    """Every width-stratum level table of an aligned table, in level
    order (a KeyError when one is missing: put_block emits them all)."""
    return [arrs[_al_key(tbl_key, lvl)] for lvl in range(len(caps))]


#: point-table offset arrays eligible for the anchor+residual encoding
#: (single-chip layouts; stacked offs stay int32 — a shard cannot
#: verify other shards' residual bounds before building).  The fold's
#: DIRECT offset arrays (pfu_start/csr_start — dense-key-indexed, not
#: bucket-indexed) pack under the same scheme: they are monotone row
#: offsets like every other entry here, and the kernel's off_read
#: decodes them identically (ROADMAP "pack the fold's direct offset
#: arrays" follow-on)
_PACK_OFF_KEYS = (
    "eh_off", "th_off", "pfh_off", "clh_off", "usr_off", "arr_off",
    "pfu_off", "csr_off", "push_off", "ovfh_off",
    "pfu_start", "csr_start",
    "rv_off", "ra_off", "fw_off",
)


def _pack_flat(
    out: Dict[str, np.ndarray], meta: FlatMeta, config: EngineConfig,
    dom: Dict, *, pack_off: bool,
) -> Dict:
    """The HBM-lean post-pass: bit-pack every eligible table in ``out``
    in place (chunked — no full-width intermediate copy) and return the
    FlatMeta field overrides ({} when packing is off or nothing won).
    Aligned width-stratum levels share their table's one spec: a level
    ``[size, cap·w]`` packs as ``[size·cap, w]`` rows into
    ``[size, cap·lanes]``."""
    if not config.packed_on():
        return {}
    from . import packed as pk

    names = (
        ["ehx", "clx", "pfx", "tx", "usx", "arx", "pfux", "csrx",
         "usgx", "argx", "pfugx", "csrgx", "rvx", "fwx", "rax"]
        + [k for k in out if k.startswith("rc") and k.endswith(("x", "gx"))
           and not k.endswith("_off")]
    )
    al_caps = {k: caps for k, _w, caps in meta.aligned}
    specs: List[Tuple[str, Tuple]] = []
    for name in names:
        if name in al_caps:
            tgt = [_al_key(name, l) for l in range(len(al_caps[name]))]
        elif name in out:
            tgt = [name]
        else:
            continue
        descs = _pack_descs(name, meta, dom, out)
        if descs is None:
            continue
        spec = pk.make_spec(descs)
        if spec is None:
            continue
        w, lanes = spec[0], spec[1]
        packed_arrays = {}
        try:
            for k in tgt:
                a = out[k]
                if k == name:
                    if len(a.shape) != 2 or a.shape[1] != w:
                        break
                    packed_arrays[k] = pk.pack_rows(a, spec)
                else:
                    size, roww = a.shape
                    cap = roww // w
                    packed_arrays[k] = pk.pack_rows(
                        a.reshape(size * cap, w), spec
                    ).reshape(size, cap * lanes)
            else:
                out.update(packed_arrays)
                specs.append((name, spec))
        except pk.PackError:
            continue
    off_specs: List[Tuple[str, int]] = []
    if pack_off:
        off_keys = list(_PACK_OFF_KEYS) + [
            k for k in out if k.startswith("rc") and k.endswith("_off")
        ]
        for ok_ in off_keys:
            a = out.get(ok_)
            if a is None or a.dtype != np.int32:
                continue
            got = pk.pack_off(a)
            if got is None:
                continue
            res, anchor = got
            if res.nbytes + anchor.nbytes >= a.nbytes:
                continue
            out[ok_] = res
            out[ok_ + "_a"] = anchor
            off_specs.append((ok_, pk.OFF_ANCHOR_SHIFT))
    up: Dict = {}
    if specs:
        up["packed"] = tuple(sorted(specs))
    if off_specs:
        up["packed_off"] = tuple(sorted(off_specs))
    return up


def build_flat_arrays(
    snap, config: EngineConfig, plan: Optional[DevicePlan] = None
) -> Optional[Tuple[Dict[str, np.ndarray], FlatMeta, Optional[object],
                    Optional[ClosureHostState]]]:
    """Hash-index the snapshot + flatten its membership closure.  Returns
    padded host arrays (merged into DeviceSnapshot.arrays), the static
    FlatMeta, the fold maintenance state and the closure advance state —
    or None when even the DENSE keys don't pack into int32
    (pow2(num_nodes) · max(active k1 slots, active srels+1) ≥ 2³¹; such
    graphs use the legacy engine).

    Every stage publishes a ``prepare.*`` sample-ring timer
    (utils/metrics.py) so the cold-start wall clock decomposes in the
    bench output: closure flatten, permission fold, dense key packing,
    hash/interleave table builds, T-index join.  ``prepare.build`` is the
    staged pipeline's fault-injection site (utils/faults.py): a transient
    failure here surfaces as a classified retriable error to the client
    envelope, like the round-7 dispatch sites."""
    from ..store.closure import NEVER, build_closure
    from ..utils import faults, metrics

    faults.fire("prepare.build")
    _mt = metrics.default

    # cheap pre-bail for clearly-over-bound worlds, BEFORE the closure
    # and fold are paid for: distinct stored slots lower-bound the dense
    # width (the closure/fold can only add to it).  The O(E) uniques run
    # only when the RAW worst case is over-bound — worlds that fit even
    # without the dense remap skip straight through
    Npre = _ceil_pow2(max(snap.num_nodes, 1), 8)
    if Npre * (snap.num_slots + 1) >= 2**31:
        width_lb = max(
            np.unique(np.concatenate(
                [snap.e_rel, snap.us_rel, snap.ar_rel]
            )).shape[0] if snap.e_rel.shape[0] else 1,
            (np.unique(snap.us_srel).shape[0] + 1)
            if snap.us_srel.shape[0] else 1,
            1,
        )
        if Npre * width_lb >= 2**31:
            return None

    with _mt.timer("prepare.closure_s"):
        cl = build_closure(snap, per_source_cap=config.closure_source_cap)

    # the permission fold runs BEFORE key packing: folded permission
    # slots join the k1 radix (engine/fold.py packs its internal keys in
    # int64 with raw radices, so it is cliff-immune itself)
    BS = config.flat_blockslice
    fr = fstate = None
    if BS and plan is not None:
        from .fold import fold_permissions

        with _mt.timer("prepare.fold_s"):
            got_fold = fold_permissions(snap, config, plan, cl)
        if got_fold is not None:
            fr, fstate = got_fold

    with _mt.timer("prepare.pack_s"):
        maps = _active_maps(
            snap, cl, {slot for _, slot in fr.pairs} if fr is not None else ()
        )
        N = _node_radix(snap, maps)
        if N is None:
            return None
        S1 = maps.S1

        e_k1 = _pack(maps.k1[snap.e_rel], N, snap.e_res)
        e_k2 = _pack(snap.e_subj, S1, _m_srel1(maps, snap.e_srel1))
        us_gk = _pack(maps.k1[snap.us_rel], N, snap.us_res)
        ar_gk = _pack(maps.k1[snap.ar_rel], N, snap.ar_res)
        cl_k1 = _pack(cl.c_src, S1, _m_srel1(maps, cl.c_srel1))
        cl_k2 = _pack(cl.c_g, S1, maps.k2[cl.c_grel] + 1)
        pus_k = _pack(snap.pus_n, S1, maps.k2[snap.pus_r] + 1)
        ovf_k = _pack(cl.ovf_src, S1, _m_srel1(maps, cl.ovf_srel1))

    _t_hash = time.perf_counter()
    # HBM-lean mode: bucket growth bounded (a deeper probe cap costs a
    # few fused compares; 8x offsets cost hundreds of MB), and the pack
    # domains collected alongside the global joins below
    PKD = config.packed_on()
    hk = (
        {"max_factor": config.flat_packed_max_factor, "lean": True}
        if PKD else {}
    )
    dom = _pack_domains(snap, config)
    dom["until"]["clx"] = _until_dom(cl.c_d_until, cl.c_p_until)
    usr = build_range_hash(us_gk, **hk)
    arr = build_range_hash(ar_gk, **hk)
    push = build_hash([pus_k], **hk)
    ovfh = build_hash([ovf_k], **hk)
    dom["fan"]["usgx"] = usr.max_run
    dom["fan"]["argx"] = arr.max_run
    eh = clh = None  # big indexes: built lazily (skipped when aligned)

    out: Dict[str, np.ndarray] = {}
    # view flags, computed up front: they pick the interleaved layouts
    flags = _view_flags_of(snap)
    e_hascav, e_hasexp = flags["e_hascav"], flags["e_hasexp"]
    us_hascav, us_hasexp = flags["us_hascav"], flags["us_hasexp"]
    us_hasperm = flags["us_hasperm"]
    ar_hascav, ar_hasexp = flags["ar_hascav"], flags["ar_hasexp"]

    # bucket-ALIGNED layout (engine/hash.py build_aligned), when
    # EngineConfig.flat_aligned asks for it: each point probe is one row
    # read per width-stratum level instead of an offset read + a block
    # slice
    AL = config.flat_aligned
    al_meta: List[Tuple[str, int, Tuple[int, ...]]] = []

    def put_block(tbl_key: str, off_key: str, h, key_cols, cols,
                  row_quantum: Optional[int] = None):
        """One point-probe table: bucket-aligned when enabled and it
        fits the byte budget, else bucket offsets + interleaved rows.
        ``h`` is a HashIndex or a zero-arg thunk building one (skipped
        entirely when the aligned layout lands); returns the HashIndex
        when the off+interleave layout was emitted, else None.
        ``row_quantum`` trims the rows table's pow2 padding to a multiple
        (the T join's up-to-2x waste; see interleave_buckets)."""
        if AL:
            ai = build_aligned(
                key_cols, cols, max_bytes=config.flat_aligned_max_bytes,
                cover=config.flat_aligned_cover,
            )
            if ai is not None:
                for lvl, (tbl, _cap) in enumerate(ai.levels):
                    out[_al_key(tbl_key, lvl)] = tbl
                al_meta.append((tbl_key, ai.w, ai.caps))
                return None
        if callable(h):
            h = h()
        out[off_key] = h.off
        out[tbl_key] = interleave_buckets(h, cols, quantum=row_quantum)
        return h

    def put_hash(prefix: str, h) -> None:
        # off keeps its exact size+1 length: the device probe derives the
        # bucket mask from off.shape[0] - 1, which must equal the build
        # size (a pow2 already)
        out[prefix + "_off"] = h.off
        out[prefix + "_rows"] = _pad(h.rows, _ceil_pow2(h.rows.shape[0]), 0)

    def put_range(prefix: str, r) -> None:
        G = _ceil_pow2(max(r.gk.shape[0], 1))
        out[prefix + "_gk"] = _pad(r.gk, G, -1)
        out[prefix + "_glo"] = _pad(r.glo, G, 0)
        out[prefix + "_ghi"] = _pad(r.ghi, G, 0)
        put_hash(prefix, r.index)

    e_gates = (
        ([snap.e_caveat, snap.e_ctx] if e_hascav else [])
        + ([snap.e_exp] if e_hasexp else [])
    )
    ar_gates = (
        ([snap.ar_caveat, snap.ar_ctx] if ar_hascav else [])
        + ([snap.ar_exp] if ar_hasexp else [])
    )
    if BS:
        # block-slice layout: per point-probe table, the bucket offsets +
        # ONE bucket-ordered interleaved matrix (keys ++ payloads) — or
        # its aligned form; per range view, the group table interleaved
        # by bucket and the row view interleaved in its existing
        # key-sorted order
        eh = put_block(
            "ehx", "eh_off", lambda: build_hash([e_k1, e_k2], **hk),
            [e_k1, e_k2],
            [e_k1, e_k2] + e_gates,
        )
        put_block(
            "usgx", "usr_off", usr.index, [usr.gk],
            [usr.gk, usr.glo, usr.ghi],
        )
        out["usx"] = interleave_rows(
            # srel rides DENSE (maps.k2): gk packing in the kernel must
            # match the dense closure/T keys
            [snap.us_subj, maps.k2[snap.us_srel]]
            + ([snap.us_caveat, snap.us_ctx] if us_hascav else [])
            + ([snap.us_exp] if us_hasexp else [])
            + ([snap.us_perm] if us_hasperm else []),
            pad=max(64, config.us_leaf_cap),
        )
        put_block(
            "argx", "arr_off", arr.index, [arr.gk],
            [arr.gk, arr.glo, arr.ghi],
        )
        out["arx"] = interleave_rows(
            [snap.ar_child]
            + ([snap.ar_caveat, snap.ar_ctx] if ar_hascav else [])
            + ([snap.ar_exp] if ar_hasexp else []),
            pad=max(64, config.arrow_fanout),
        )
        clh = put_block(
            "clx", "clh_off", lambda: build_hash([cl_k1, cl_k2], **hk),
            [cl_k1, cl_k2],
            [cl_k1, cl_k2, cl.c_d_until, cl.c_p_until],
        )
        put_block("pusx", "push_off", push, [pus_k], [pus_k])
        put_block("ovfx", "ovfh_off", ovfh, [ovf_k], [ovf_k])
    else:
        # scattered layout: per table, the bucket offsets + the row
        # permutation over full-width int32 key and payload columns
        eh = build_hash([e_k1, e_k2])
        clh = build_hash([cl_k1, cl_k2])
        put_hash("eh", eh)
        put_range("usr", usr)
        put_range("arr", arr)
        put_hash("clh", clh)
        put_hash("push", push)
        put_hash("ovfh", ovfh)

        # dense srel column for the scattered KU path (the raw us_srel
        # base column does not match the dense closure keys)
        out["us_srel_d"] = _pad(
            maps.k2[snap.us_srel],
            _ceil_pow2(max(int(snap.us_rel.shape[0]), 1)), -1,
        )
        E = _ceil_pow2(max(e_k1.shape[0], 1))
        out["e_k1"] = _pad(e_k1, E, -1)
        out["e_k2"] = _pad(e_k2, E, -1)
        P = _ceil_pow2(max(cl.num_pairs, 1))
        out["cl_k1"] = _pad(cl_k1, P, -1)
        out["cl_k2"] = _pad(cl_k2, P, -1)
        out["cl_d_until"] = _pad(cl.c_d_until, P, NEVER)
        out["cl_p_until"] = _pad(cl.c_p_until, P, NEVER)
        out["pus_k"] = _pad(pus_k, _ceil_pow2(max(pus_k.shape[0], 1)), -1)
        out["ovf_k"] = _pad(ovf_k, _ceil_pow2(max(ovf_k.shape[0], 1)), -1)
    _mt.observe("prepare.hash_s", time.perf_counter() - _t_hash)

    # ---- T-index: userset edges ⋈ closure-by-target (shared join) -------
    _t_tindex = time.perf_counter()
    t_kw = dict(has_tindex=False, t_cap=4, t_n=8, t_slots=())
    tj = _tindex_join(snap, config, cl, us_gk, cl_k1, cl_k2, pus_k, maps)
    if tj is not None:
        T_k1, T_k2, T_d, T_p, t_slots = tj
        dom["until"]["tx"] = _until_dom(T_d, T_p)
        th = None
        if BS:
            # row_quantum: the T join is the largest rebuilt-per-prepare
            # rows table (~80% of packed bytes at config 3) — round its
            # rows to a 4096 quantum instead of pow2 (ROADMAP "trim the
            # pow2 row padding on the T join"); snapshot.device_bytes.tx
            # shows the reduction live
            th = put_block(
                "tx", "th_off", lambda: build_hash([T_k1, T_k2], **hk),
                [T_k1, T_k2], [T_k1, T_k2, T_d, T_p],
                row_quantum=4096,
            )
        else:
            th = build_hash([T_k1, T_k2])
            put_hash("th", th)
            TP = _ceil_pow2(max(T_k1.shape[0], 1))
            out["t_k1"] = _pad(T_k1, TP, -1)
            out["t_k2"] = _pad(T_k2, TP, -1)
            out["t_d"] = _pad(T_d, TP, NEVER)
            out["t_p"] = _pad(T_p, TP, NEVER)
        t_kw = dict(
            has_tindex=True,
            t_cap=_round_cap(th.cap) if th is not None else 4,
            t_n=_ceil_pow2(max(th.n, 1)) if th is not None else 8,
            t_slots=t_slots,
        )
    _mt.observe("prepare.tindex_s", time.perf_counter() - _t_tindex)

    # ---- reverse-CSR lookup index (engine/rev.py) ----------------------
    # the frontier tables LookupResources/LookupSubjects hop over
    # (engine/spmv.py): edges re-keyed by k2 (reverse), by k1 (forward),
    # and arrow rows by child — built from the SAME packed key columns
    # as the forward tables, M=1 layout
    rev_kw: Dict = {}
    if BS and config.flat_rev_index:
        _t_rev = time.perf_counter()
        from .partition import _hash_cols
        from .rev import build_rev_full, rev_geom, rev_meta_kw

        h_rv = _hash_cols([e_k2])
        ge_rv = rev_geom(h_rv, 1)
        rv_cols = [e_k2, e_k1] + e_gates
        out["rv_off"], out["rvx"] = build_rev_full(
            h_rv, rv_cols, ge_rv, len(rv_cols)
        )
        h_ra = _hash_cols([snap.ar_child])
        ge_ra = rev_geom(h_ra, 1)
        ra_cols = [snap.ar_child, ar_gk] + ar_gates
        out["ra_off"], out["rax"] = build_rev_full(
            h_ra, ra_cols, ge_ra, len(ra_cols)
        )
        h_fw = _hash_cols([e_k1])
        ge_fw = rev_geom(h_fw, 1)
        fw_cols = [e_k1, e_k2] + e_gates
        out["fw_off"], out["fwx"] = build_rev_full(
            h_fw, fw_cols, ge_fw, len(fw_cols)
        )
        rev_kw = rev_meta_kw(ge_rv, ge_ra, ge_fw)
        _mt.observe("prepare.rev_s", time.perf_counter() - _t_rev)

    # resource-side Leopard index: flattened ancestor closures for
    # self-recursive arrow hierarchies (block-slice layout only)
    ar_dd = _arrow_data_depth(snap)
    rc_kw: Dict = {}
    if BS:
        rc_list = []
        for ts_slot, (src, anc, d_u, p_u, fan) in _rc_build(
            snap, config, plan, ar_dd
        ).items():
            ri = build_range_hash(src, **hk)
            put_block(
                f"rc{ts_slot}gx", f"rc{ts_slot}_off", ri.index,
                [ri.gk], [ri.gk, ri.glo, ri.ghi],
            )
            out[f"rc{ts_slot}x"] = interleave_rows(
                [anc, d_u, p_u], pad=max(64, fan)
            )
            dom["until"][f"rc{ts_slot}x"] = _until_dom(d_u, p_u)
            dom["fan"][f"rc{ts_slot}gx"] = fan
            rc_list.append((int(ts_slot), _round_cap(ri.index.cap), fan))
        rc_kw = dict(rc_slots=tuple(sorted(rc_list)))

    wc_nodes = snap.wildcard_node_of_type[snap.wildcard_node_of_type >= 0]

    # ---- permission fold (P-index): rewrites → root-level tables -------
    _t_fold = time.perf_counter()
    fold_kw: Dict = {}
    got = _fold_packed(fr, snap, maps, N, config) if fr is not None else None
    if got is not None:
        # subject side: a subject whose closure is wider than the
        # compare-tile cap declines the fold (the walked path answers)
        s_run = _max_run_sorted(cl_k1)
        if s_run > config.flat_fold_subj_fan_cap:
            got = None
    if got is not None:
        pf_k1, pf_k2, pf_subj, (u_k1, u_gk, u_until, u_fan), pff = got
        pfh = put_block(
            "pfx", "pfh_off", lambda: build_hash([pf_k1, pf_k2], **hk),
            [pf_k1, pf_k2],
            [pf_k1, pf_k2]
            + ([fr.e_cav, fr.e_ctx] if pff["pf_hascav"] else [])
            + ([fr.e_until] if pff["pf_hasuntil"] else []),
        )
        dom["until"]["pfx"] = _until_dom(fr.e_until)
        dom["until"]["pfux"] = _until_dom(u_until)
        s_fan = _round_fan(max(s_run, 1))
        fold_slots = tuple(sorted({s for _, s in fr.pairs}))
        dom["fan"]["pfugx"] = u_fan
        dom["fan"]["csrgx"] = s_fan
        pf_arrays, pf_kw = _pf_view_tables(
            u_k1, u_gk, u_until, u_fan,
            cl_k1, cl_k2, cl.c_d_until, cl.c_p_until, s_fan,
            maps=maps, N=N, S1=S1, fold_slots=fold_slots, config=config,
            hk=hk,
        )
        out.update(pf_arrays)
        fold_kw = dict(
            fold_pairs=fr.pairs,
            pf_e_cap=_round_cap(pfh.cap) if pfh is not None else 4,
            pf_u_fan=u_fan,
            pf_s_fan=s_fan,
            pf_haswc=bool(np.isin(pf_subj, wc_nodes).any()),
            pf_has_e=pf_k1.shape[0] > 0,
            pf_has_u=u_k1.shape[0] > 0,
            **pf_kw,
            **pff,
        )
        # arm the maintenance state with the packing context it
        # needs at delta time (fold_delta_update)
        fstate.maps, fstate.N = maps, N
    else:
        fstate = None
    _mt.observe("prepare.fold_s", time.perf_counter() - _t_fold)

    meta = FlatMeta(
        N=N, S1=S1,
        k1_dense=tuple(int(x) for x in maps.k1),
        k2_dense=tuple(int(x) for x in maps.k2),
        **rc_kw,
        **fold_kw,
        **rev_kw,
        e_cap=_round_cap(eh.cap) if eh is not None else 4,
        e_n=_ceil_pow2(max(eh.n, 1)) if eh is not None else 8,
        usr_cap=_round_cap(usr.index.cap),
        usr_gn=_ceil_pow2(max(usr.index.n, 1)),
        us_rows=_ceil_pow2(max(int(snap.us_rel.shape[0]), 1)),
        arr_cap=_round_cap(arr.index.cap),
        arr_gn=_ceil_pow2(max(arr.index.n, 1)),
        ar_rows=_ceil_pow2(max(int(snap.ar_rel.shape[0]), 1)),
        cl_cap=_round_cap(clh.cap) if clh is not None else 4,
        cl_n=_ceil_pow2(max(clh.n, 1)) if clh is not None else 8,
        has_closure=int(cl_k1.shape[0]) > 0,
        pus_cap=_round_cap(push.cap), pus_n=_ceil_pow2(max(push.n, 1)),
        ovf_cap=_round_cap(ovfh.cap), ovf_n=_ceil_pow2(max(ovfh.n, 1)),
        has_ovf=ovfh.n > 0,
        ar_fanout_by_slot=_run_maxes(arr.gk, arr.glo, arr.ghi, N, maps.k1_raw),
        us_fanout_by_slot=_run_maxes(usr.gk, usr.glo, usr.ghi, N, maps.k1_raw),
        **t_kw,
        e_hascav=e_hascav,
        e_hasexp=e_hasexp,
        us_hascav=us_hascav,
        us_hasexp=us_hasexp,
        us_hasperm=us_hasperm,
        ar_hascav=ar_hascav,
        ar_hasexp=ar_hasexp,
        blockslice=BS,
        aligned=tuple(al_meta),
        ar_data_depth=ar_dd,
        e_slots=tuple(int(s) for s in _uniq_small([snap.e_rel], snap.num_slots)),
        us_slots=tuple(int(s) for s in _uniq_small([snap.us_rel], snap.num_slots)),
        has_wc_edges=bool(np.isin(snap.e_subj, wc_nodes).any()),
        has_wc_closure=bool(
            np.isin(cl.c_src[cl.c_srel1 == 0], wc_nodes).any()
            or np.isin(cl.ovf_src[cl.ovf_srel1 == 0], wc_nodes).any()
        ),
    )
    if PKD:
        with _mt.timer("prepare.pack_lanes_s"):
            pk_up = _pack_flat(out, meta, config, dom, pack_off=True)
        if pk_up:
            from dataclasses import replace as _dc_replace

            meta = _dc_replace(meta, **pk_up)
    cstate = (
        _closure_host_state(snap, cl, config, us_gk, t_kw.get("t_slots", ()))
        if config.closure_delta and BS
        else None
    )
    return out, meta, fstate, cstate


# ---------------------------------------------------------------------------
# bucket-sharded layout (a mesh: parallel/sharded.py over the model axis)
# ---------------------------------------------------------------------------
#
# Hash tables shard by BUCKET RANGE: shard s of M owns buckets
# [s·bpd, (s+1)·bpd) (bpd = size/M, both pow2), the bucket-ordered
# interleaved rows for those buckets (a contiguous slice), and the
# normalized local offsets.  A probe hashes globally, masks "is this my
# bucket", probes locally, and the site's boolean outputs OR-reduce over
# the model axis (an int psum, parallel/collectives.py); value blocks
# (userset/arrow candidate rows) broadcast from their single owner via a
# psum of the masked block.  This keeps a shard's table memory at 1/M
# while the program stays the same straight-line probe pipeline.


def _stack_point(h: HashIndex, cols: Sequence[np.ndarray], M: int, pad: int = 64):
    """Bucket-sharded point table: (off int32[M·(bpd+1)],
    tbl int32[M·R_pad, w]) — the mesh splits both on the leading axis.
    Fully batched: one interleaved gather for the payload rows, one
    advanced-index scatter placing every shard's slice, one broadcast
    subtraction for the normalized local offsets (no per-shard loops)."""
    from ..native.sort import fill_interleaved

    size, bpd = h.size, h.size // M
    assert bpd * M == h.size and bpd >= 1
    w = max(len(cols), 1)
    n = int(h.rows.shape[0]) if h.n else 0
    off = h.off.astype(np.int64)
    starts = off[np.arange(M) * bpd]
    ends = off[(np.arange(M) + 1) * bpd]
    R_pad = _ceil_pow2(int((ends - starts).max() if M else 1) + max(pad, h.cap))
    tbl = np.full((M, R_pad, w), -1, np.int32)
    if n:
        # rows [0, n) partition contiguously into shards [starts, ends):
        # shard id + local position per global row, then one scatter
        lens = ends - starts
        sh = np.repeat(np.arange(M), lens)
        loc = np.arange(n, dtype=np.int64) - np.repeat(starts, lens)
        rows_mat = np.empty((n, w), np.int32)
        if not fill_interleaved(rows_mat, cols, h.rows[:n]):
            for j, c in enumerate(cols):
                rows_mat[:, j] = np.ascontiguousarray(c, np.int32)[h.rows[:n]]
        tbl[sh, loc] = rows_mat
    bidx = np.arange(M)[:, None] * bpd + np.arange(bpd + 1)[None, :]
    offs = (off[bidx] - starts[:, None]).astype(np.int32)
    return offs.reshape(-1), tbl.reshape(M * R_pad, w)


def _stack_range(ri, row_cols: Sequence[np.ndarray], M: int, fan_pad: int):
    """Bucket-sharded range view: the group table shards like a point
    table, and the underlying rows are PERMUTED into group-bucket order so
    each device's rows are its own groups' rows, contiguous and locally
    indexed.  ``ri`` is a RangeIndex built with min_size ≥ M (its group
    hash is reused, not rebuilt).  Returns (goff, gtbl, rows_tbl,
    group_cap) stacked for the mesh to split."""
    gk, glo, ghi, gh = ri.gk, ri.glo, ri.ghi, ri.index
    G = int(gk.shape[0])
    size, bpd = gh.size, gh.size // M
    assert bpd * M == size, "RangeIndex must be built with min_size >= M"
    lens = ghi.astype(np.int64) - glo.astype(np.int64)
    w = max(len(row_cols), 1)
    goff = gh.off.astype(np.int64)
    g_starts = goff[np.arange(M) * bpd]
    g_ends = goff[(np.arange(M) + 1) * bpd]
    # one global bucket-ordered row permutation (vectorized), sliced per
    # shard: order_groups lists groups bucket-ordered; their row ranges
    # concatenate in that order
    order_groups = gh.rows[:G]
    lens_o = lens[order_groups] if G else np.zeros(0, np.int64)
    ends_all = np.cumsum(lens_o)
    starts_all = ends_all - lens_o
    total = int(ends_all[-1]) if G else 0
    row_src = (
        np.repeat(glo[order_groups].astype(np.int64), lens_o)
        + (np.arange(total, dtype=np.int64) - np.repeat(starts_all, lens_o))
        if G
        else np.zeros(0, np.int64)
    )
    # batched stacking: groups [0, G) and their rows [0, total) partition
    # contiguously into shards — compute shard-row bases with a running
    # max (empty shards carry the previous base), then place every
    # shard's group and row slices with advanced-index scatters
    shard_row_base = np.zeros(M + 1, np.int64)
    if G:
        cand = np.where(
            g_ends > g_starts, ends_all[np.clip(g_ends - 1, 0, None)], 0
        )
        shard_row_base[1:] = np.maximum.accumulate(cand)
    row_counts = np.diff(shard_row_base)
    R_pad = _ceil_pow2(int(row_counts.max() if M else 1) + max(fan_pad, 64))
    G_pad = _ceil_pow2(int((g_ends - g_starts).max() if M else 1) + max(64, gh.cap))
    rows_tbl = np.full((M, R_pad, w), -1, np.int32)
    gtbl = np.full((M, G_pad, 3), -1, np.int32)
    cols32 = [np.ascontiguousarray(c, np.int32) for c in row_cols]
    if total:
        from ..native.sort import fill_interleaved

        sh_r = np.repeat(np.arange(M), row_counts)
        loc_r = np.arange(total, dtype=np.int64) - np.repeat(
            shard_row_base[:-1], row_counts
        )
        rows_mat = np.empty((total, w), np.int32)
        if not fill_interleaved(rows_mat, cols32, row_src.astype(np.int32)):
            for ci, c in enumerate(cols32):
                rows_mat[:, ci] = c[row_src]
        rows_tbl[sh_r, loc_r] = rows_mat
    if G:
        g_lens = g_ends - g_starts
        sh_g = np.repeat(np.arange(M), g_lens)
        loc_g = np.arange(G, dtype=np.int64) - np.repeat(g_starts, g_lens)
        r0_of = np.repeat(shard_row_base[:-1], g_lens)
        gtbl[sh_g, loc_g, 0] = gk[order_groups]
        gtbl[sh_g, loc_g, 1] = (starts_all - r0_of).astype(np.int32)
        gtbl[sh_g, loc_g, 2] = (ends_all - r0_of).astype(np.int32)
    bidx = np.arange(M)[:, None] * bpd + np.arange(bpd + 1)[None, :]
    goffs = (
        gh.off.astype(np.int64)[bidx] - g_starts[:, None]
    ).astype(np.int32)
    return (
        goffs.reshape(-1),
        gtbl.reshape(M * G_pad, 3),
        rows_tbl.reshape(M * R_pad, w),
        gh.cap,
    )


def _groups_of(k: np.ndarray):
    """(gk, glo, ghi) distinct-key groups of a sorted key column — the
    group arrays build_range_hash materializes, shared by the partitioned
    range stacking and the per-slot fanout meta."""
    from ..native.sort import sorted_runs

    n = int(k.shape[0])
    if n == 0:
        z64 = np.zeros(0, np.int64)
        return np.zeros(0, np.int32), z64, z64
    starts = sorted_runs(k)
    ends = np.concatenate([starts[1:], np.asarray([n])])
    return np.ascontiguousarray(k[starts], np.int32), starts, ends


def _primary_hash_chunked(
    rel: np.ndarray, res: np.ndarray, subj: np.ndarray, srel1: np.ndarray,
    maps: SlotMaps, N: int, S1: int, chunk: int,
):
    """uint32 bucket hash of every primary row's dense (k1, k2) key,
    computed in bounded row chunks: the partitioned build's ownership
    pass never materializes a full-size packed key column.  Column-based,
    so any feed of the same rows (sorted snapshot columns or raw ones)
    hashes them with ONE definition — the bitwise-parity-critical
    pass."""
    from .partition import _hash_cols

    n = int(rel.shape[0])
    h = np.empty(n, np.uint32)
    for at in range(0, n, max(chunk, 1)):
        sl = slice(at, min(at + chunk, n))
        k1 = _pack(maps.k1[rel[sl]], N, res[sl])
        k2 = _pack(subj[sl], S1, _m_srel1(maps, srel1[sl]))
        h[sl] = _hash_cols([k1, k2])
    return h


def _e_cols_at(snap, maps: SlotMaps, N: int, S1: int, gates):
    """Partition-local primary-table columns: the dense key packs are
    recomputed per shard over just that shard's rows (matching the
    chunked hash pass — no O(E) pack scratch)."""
    from ..native.sort import take32

    def at(rows: np.ndarray):
        idx = np.ascontiguousarray(rows, np.int64)
        rel = take32(snap.e_rel, idx)
        res = take32(snap.e_res, idx)
        subj = take32(snap.e_subj, idx)
        srel1 = take32(snap.e_srel1, idx)
        cols = [
            _pack(maps.k1[rel], N, res),
            _pack(subj, S1, _m_srel1(maps, srel1)),
        ]
        cols.extend(take32(g, idx) for g in gates)
        return cols

    return at


def _rev_key_hash_chunked(
    snap, maps: SlotMaps, N: int, S1: int, chunk: int, which: str
):
    """uint32 bucket hash of every primary row's single-column reverse-
    index key (``which`` = "k2" for the reverse view, "k1" for the
    forward view), computed in bounded row chunks — the reverse index's
    ownership pass materializes no full-size packed key column, same
    contract as _primary_hash_chunked."""
    from .partition import _hash_cols

    n = int(snap.e_rel.shape[0])
    h = np.empty(n, np.uint32)
    for at in range(0, n, max(chunk, 1)):
        sl = slice(at, min(at + chunk, n))
        if which == "k2":
            k = _pack(snap.e_subj[sl], S1, _m_srel1(maps, snap.e_srel1[sl]))
        else:
            k = _pack(maps.k1[snap.e_rel[sl]], N, snap.e_res[sl])
        h[sl] = _hash_cols([k])
    return h


def _rev_cols_at(snap, maps: SlotMaps, N: int, S1: int, gates, which: str):
    """Partition-local reverse-index row columns ([key, other-key] +
    gates), packed per shard — the rv/fw counterpart of _e_cols_at."""
    from ..native.sort import take32

    def at(rows: np.ndarray):
        idx = np.ascontiguousarray(rows, np.int64)
        k1 = _pack(
            maps.k1[take32(snap.e_rel, idx)], N, take32(snap.e_res, idx)
        )
        k2 = _pack(
            take32(snap.e_subj, idx), S1,
            _m_srel1(maps, take32(snap.e_srel1, idx)),
        )
        cols = [k2, k1] if which == "k2" else [k1, k2]
        cols.extend(take32(g, idx) for g in gates)
        return cols

    return at


def build_flat_arrays_sharded(
    snap, config: EngineConfig, model_size: int,
    plan: Optional[DevicePlan] = None,
) -> Optional[Tuple[Dict[str, np.ndarray], FlatMeta, Optional[object],
                    Optional[ClosureHostState]]]:
    """The bucket-sharded counterpart of build_flat_arrays: every hash /
    range / closure / T table stacked per model shard (the leading axis
    splits M ways over the mesh; probes mask bucket ownership and
    OR-reduce).  Array names and FlatMeta fields match the single-chip
    layout — the program distinguishes the layouts by FlatMeta.sharded
    and must be built with the matching ``axis``.  Returns None when keys
    don't pack (the sharded legacy program serves then)."""
    from ..store.closure import build_closure
    from ..utils import faults, metrics

    faults.fire("prepare.build")
    M = model_size
    with metrics.default.timer("prepare.closure_s"):
        cl = build_closure(snap, per_source_cap=config.closure_source_cap)

    # the permission fold shards like every other table (stacked pf_e /
    # pf_t; the kernel's pf probes already mask bucket ownership and
    # OR-reduce) — folded slots join the k1 radix
    fr = fstate = None
    if plan is not None:
        from .fold import fold_permissions

        got_fold = fold_permissions(snap, config, plan, cl)
        if got_fold is not None:
            fr, fstate = got_fold
    maps = _active_maps(
        snap, cl, {slot for _, slot in fr.pairs} if fr is not None else ()
    )
    N = _node_radix(snap, maps)
    if N is None:
        return None
    S1 = maps.S1

    us_gk = _pack(maps.k1[snap.us_rel], N, snap.us_res)
    ar_gk = _pack(maps.k1[snap.ar_rel], N, snap.ar_res)
    cl_k1 = _pack(cl.c_src, S1, _m_srel1(maps, cl.c_srel1))
    cl_k2 = _pack(cl.c_g, S1, maps.k2[cl.c_grel] + 1)
    pus_k = _pack(snap.pus_n, S1, maps.k2[snap.pus_r] + 1)
    ovf_k = _pack(cl.ovf_src, S1, _m_srel1(maps, cl.ovf_srel1))

    flags = _view_flags_of(snap)

    ms = max(8, M)
    # partition-first mode (engine/partition.py; config.flat_partition_
    # build, the default): the O(E) tables — primary hash, userset/arrow
    # range views, T-index, fold pf_e — are hashed to bucket shards
    # FIRST and each shard's slice of the stacked arrays is built
    # independently, so the sort/hash/interleave scratch peaks at
    # O(E/M), never O(E).  Output is BITWISE-identical to the
    # build-full-then-stack path below.  Globally-small derived tables
    # (closure, pus/ovf, fold csr) keep the full build: they are sized by
    # the group structure
    PART = bool(config.flat_partition_build)
    if PART:
        faults.fire("prepare.partition")
        from .partition import (
            _hash_cols, gather_cols, point_geom, range_geom,
            stack_point, stack_range,
        )
    _t_part = time.perf_counter()

    PKD = config.packed_on()
    hk = (
        {"max_factor": config.flat_packed_max_factor, "lean": True}
        if PKD else {}
    )
    dom = _pack_domains(snap, config)
    dom["until"]["clx"] = _until_dom(cl.c_d_until, cl.c_p_until)

    clh = build_hash([cl_k1, cl_k2], min_size=ms, **hk)
    push = build_hash([pus_k], min_size=ms, **hk)
    ovfh = build_hash([ovf_k], min_size=ms, **hk)

    out: Dict[str, np.ndarray] = {}
    e_gates = (
        ([snap.e_caveat, snap.e_ctx] if flags["e_hascav"] else [])
        + ([snap.e_exp] if flags["e_hasexp"] else [])
    )
    if PART:
        h_e = _primary_hash_chunked(
            snap.e_rel, snap.e_res, snap.e_subj, snap.e_srel1,
            maps, N, S1, config.flat_partition_chunk,
        )
        ge, e_ord = point_geom(
            h_e, M, min_size=ms, return_order=True, **hk
        )
        out["eh_off"], out["ehx"] = stack_point(
            h_e, _e_cols_at(snap, maps, N, S1, e_gates), ge,
            2 + len(e_gates), order=e_ord,
        )
        del h_e, e_ord
        eh_cap, eh_n = ge.cap, ge.n
    else:
        e_k1 = _pack(maps.k1[snap.e_rel], N, snap.e_res)
        e_k2 = _pack(snap.e_subj, S1, _m_srel1(maps, snap.e_srel1))
        eh = build_hash([e_k1, e_k2], min_size=ms, **hk)
        out["eh_off"], out["ehx"] = _stack_point(eh, [e_k1, e_k2] + e_gates, M)
        eh_cap, eh_n = eh.cap, eh.n
    out["clh_off"], out["clx"] = _stack_point(
        clh, [cl_k1, cl_k2, cl.c_d_until, cl.c_p_until], M
    )
    out["push_off"], out["pusx"] = _stack_point(push, [pus_k], M)
    out["ovfh_off"], out["ovfx"] = _stack_point(ovfh, [ovf_k], M)

    # srel rides DENSE, matching the dense closure/T keys
    us_cols = (
        [snap.us_subj, maps.k2[snap.us_srel]]
        + ([snap.us_caveat, snap.us_ctx] if flags["us_hascav"] else [])
        + ([snap.us_exp] if flags["us_hasexp"] else [])
        + ([snap.us_perm] if flags["us_hasperm"] else [])
    )
    ar_cols = (
        [snap.ar_child]
        + ([snap.ar_caveat, snap.ar_ctx] if flags["ar_hascav"] else [])
        + ([snap.ar_exp] if flags["ar_hasexp"] else [])
    )
    if PART:
        us_gkg, us_glo, us_ghi = _groups_of(us_gk)
        ar_gkg, ar_glo, ar_ghi = _groups_of(ar_gk)
        h_usg = _hash_cols([us_gkg])
        gus = range_geom(
            us_gkg, us_ghi - us_glo, h_usg, M, min_size=ms,
            fan_pad=max(64, config.us_leaf_cap), **hk,
        )
        out["usr_off"], out["usgx"], out["usx"] = stack_range(
            us_gkg, us_glo, us_ghi - us_glo, h_usg,
            gather_cols(us_cols), gus, len(us_cols),
        )
        usr_cap = gus.cap
        dom["fan"]["usgx"] = gus.max_run
        h_arg = _hash_cols([ar_gkg])
        gar = range_geom(
            ar_gkg, ar_ghi - ar_glo, h_arg, M, min_size=ms,
            fan_pad=max(64, config.arrow_fanout), **hk,
        )
        out["arr_off"], out["argx"], out["arx"] = stack_range(
            ar_gkg, ar_glo, ar_ghi - ar_glo, h_arg,
            gather_cols(ar_cols), gar, len(ar_cols),
        )
        arr_cap = gar.cap
        dom["fan"]["argx"] = gar.max_run
    else:
        usr = build_range_hash(us_gk, min_size=ms, **hk)
        arr = build_range_hash(ar_gk, min_size=ms, **hk)
        out["usr_off"], out["usgx"], out["usx"], usr_cap = _stack_range(
            usr, us_cols, M, max(64, config.us_leaf_cap),
        )
        out["arr_off"], out["argx"], out["arx"], arr_cap = _stack_range(
            arr, ar_cols, M, max(64, config.arrow_fanout),
        )
        dom["fan"]["usgx"] = usr.max_run
        dom["fan"]["argx"] = arr.max_run
        # the RangeIndexes already hold the group arrays: reuse them for
        # the per-slot fanout meta instead of a second sorted-runs pass
        us_gkg, us_glo, us_ghi = usr.gk, usr.glo, usr.ghi
        ar_gkg, ar_glo, ar_ghi = arr.gk, arr.glo, arr.ghi

    t_kw = dict(has_tindex=False, t_cap=4, t_n=8, t_slots=())
    tj = _tindex_join(snap, config, cl, us_gk, cl_k1, cl_k2, pus_k, maps)
    if tj is not None:
        T_k1, T_k2, T_d, T_p, t_slots = tj
        dom["until"]["tx"] = _until_dom(T_d, T_p)
        if PART:
            h_T = _hash_cols([T_k1, T_k2])
            gT, t_ord = point_geom(
                h_T, M, min_size=ms, return_order=True, **hk
            )
            out["th_off"], out["tx"] = stack_point(
                h_T, gather_cols([T_k1, T_k2, T_d, T_p]), gT, 4,
                order=t_ord,
            )
            th_cap, th_n = gT.cap, gT.n
        else:
            th = build_hash([T_k1, T_k2], min_size=ms, **hk)
            out["th_off"], out["tx"] = _stack_point(
                th, [T_k1, T_k2, T_d, T_p], M
            )
            th_cap, th_n = th.cap, th.n
        t_kw = dict(
            has_tindex=True,
            t_cap=_round_cap(th_cap),
            t_n=_ceil_pow2(max(th_n, 1)),
            t_slots=t_slots,
        )

    # ---- reverse-CSR lookup index (engine/rev.py), stacked M ways ------
    # partition-first on the PART path (owner shard from the key hash,
    # O(E/M) sort/gather scratch per shard); the other path builds
    # full-then-stack (build_rev_full), the bitwise parity oracle
    rev_kw: Dict = {}
    if config.flat_rev_index:
        from .partition import _hash_cols as _rvh
        from .rev import (
            build_rev_full, build_rev_partitioned, rev_geom, rev_meta_kw,
        )

        _t_rev = time.perf_counter()
        ra_cols_full = [snap.ar_child, ar_gk] + ar_cols[1:]
        if PART:
            ck = config.flat_partition_chunk
            h_rv = _rev_key_hash_chunked(snap, maps, N, S1, ck, "k2")
            ge_rv = rev_geom(h_rv, M)
            w_rv = 2 + len(e_gates)
            out["rv_off"], out["rvx"] = build_rev_partitioned(
                h_rv, _rev_cols_at(snap, maps, N, S1, e_gates, "k2"),
                ge_rv, w_rv,
            )
            del h_rv
            h_ra = _rvh([snap.ar_child])
            ge_ra = rev_geom(h_ra, M)
            out["ra_off"], out["rax"] = build_rev_partitioned(
                h_ra, gather_cols(ra_cols_full), ge_ra, len(ra_cols_full)
            )
            del h_ra
            h_fw = _rev_key_hash_chunked(snap, maps, N, S1, ck, "k1")
            ge_fw = rev_geom(h_fw, M)
            out["fw_off"], out["fwx"] = build_rev_partitioned(
                h_fw, _rev_cols_at(snap, maps, N, S1, e_gates, "k1"),
                ge_fw, w_rv,
            )
            del h_fw
        else:
            h_rv = _rvh([e_k2])
            ge_rv = rev_geom(h_rv, M)
            out["rv_off"], out["rvx"] = build_rev_full(
                h_rv, [e_k2, e_k1] + e_gates, ge_rv, 2 + len(e_gates)
            )
            h_ra = _rvh([snap.ar_child])
            ge_ra = rev_geom(h_ra, M)
            out["ra_off"], out["rax"] = build_rev_full(
                h_ra, ra_cols_full, ge_ra, len(ra_cols_full)
            )
            h_fw = _rvh([e_k1])
            ge_fw = rev_geom(h_fw, M)
            out["fw_off"], out["fwx"] = build_rev_full(
                h_fw, [e_k1, e_k2] + e_gates, ge_fw, 2 + len(e_gates)
            )
        rev_kw = rev_meta_kw(ge_rv, ge_ra, ge_fw)
        metrics.default.observe(
            "prepare.rev_s", time.perf_counter() - _t_rev
        )

    wc_nodes = snap.wildcard_node_of_type[snap.wildcard_node_of_type >= 0]
    fold_kw: Dict = {}
    got = _fold_packed(fr, snap, maps, N, config) if fr is not None else None
    if got is not None:
        csr = build_range_hash(cl_k1, min_size=ms, **hk)
        if int(csr.max_run) > config.flat_fold_subj_fan_cap:
            got = None
    if got is not None:
        pf_k1, pf_k2, pf_subj, (u_k1, u_gk, u_until, u_fan), pff = got
        pf_cols = (
            [pf_k1, pf_k2]
            + ([fr.e_cav, fr.e_ctx] if pff["pf_hascav"] else [])
            + ([fr.e_until] if pff["pf_hasuntil"] else [])
        )
        dom["until"]["pfx"] = _until_dom(fr.e_until)
        dom["until"]["pfux"] = _until_dom(u_until)
        if PART:
            h_pf = _hash_cols([pf_k1, pf_k2])
            gpf, pf_ord = point_geom(
                h_pf, M, min_size=ms, return_order=True, **hk
            )
            out["pfh_off"], out["pfx"] = stack_point(
                h_pf, gather_cols(pf_cols), gpf, len(pf_cols),
                order=pf_ord,
            )
            pfh_cap = gpf.cap
        else:
            pfh = build_hash([pf_k1, pf_k2], min_size=ms, **hk)
            out["pfh_off"], out["pfx"] = _stack_point(pfh, pf_cols, M)
            pfh_cap = pfh.cap
        if PART:
            # fold userset view (u_k1 arrives k1-sorted): partitioned
            # group stacking, same discipline as the usr/arr views
            pfu_gk, pfu_glo, pfu_ghi = _groups_of(u_k1)
            h_pfu = _hash_cols([pfu_gk])
            gpfu = range_geom(
                pfu_gk, pfu_ghi - pfu_glo, h_pfu, M, min_size=ms,
                fan_pad=max(64, u_fan), **hk,
            )
            out["pfu_off"], out["pfugx"], out["pfux"] = stack_range(
                pfu_gk, pfu_glo, pfu_ghi - pfu_glo, h_pfu,
                gather_cols([u_gk, u_until]), gpfu, 2,
            )
            pfu_cap = gpfu.cap
        else:
            pfu = build_range_hash(u_k1, min_size=ms, **hk)
            out["pfu_off"], out["pfugx"], out["pfux"], pfu_cap = _stack_range(
                pfu, [u_gk, u_until], M, max(64, u_fan)
            )
        s_fan = _round_fan(max(int(csr.max_run), 1))
        dom["fan"]["pfugx"] = u_fan
        dom["fan"]["csrgx"] = s_fan
        out["csr_off"], out["csrgx"], out["csrx"], csr_cap = _stack_range(
            csr, [cl_k2, cl.c_d_until, cl.c_p_until], M, max(64, s_fan)
        )
        fold_kw = dict(
            fold_pairs=fr.pairs,
            pf_e_cap=_round_cap(pfh_cap),
            pf_u_cap=_round_cap(pfu_cap),
            pf_u_fan=u_fan,
            pf_s_cap=_round_cap(csr_cap),
            pf_s_fan=s_fan,
            pf_haswc=bool(np.isin(pf_subj, wc_nodes).any()),
            pf_has_e=pf_k1.shape[0] > 0,
            pf_has_u=u_k1.shape[0] > 0,
            **pff,
        )
        # arm the maintenance state with the packing context it
        # needs at delta time (fold_delta_update)
        fstate.maps, fstate.N = maps, N
    else:
        fstate = None

    ar_dd = _arrow_data_depth(snap)
    rc_list = []
    for ts_slot, (src, anc, d_u, p_u, fan) in _rc_build(
        snap, config, plan, ar_dd
    ).items():
        dom["until"][f"rc{ts_slot}x"] = _until_dom(d_u, p_u)
        dom["fan"][f"rc{ts_slot}gx"] = fan
        if PART:
            # ancestor-closure view (src arrives sorted): partitioned
            # group stacking — O(rc/M) fill scratch per shard
            rc_gk, rc_glo, rc_ghi = _groups_of(src)
            h_rc = _hash_cols([rc_gk])
            grc = range_geom(
                rc_gk, rc_ghi - rc_glo, h_rc, M, min_size=ms,
                fan_pad=max(64, fan), **hk,
            )
            (
                out[f"rc{ts_slot}_off"],
                out[f"rc{ts_slot}gx"],
                out[f"rc{ts_slot}x"],
            ) = stack_range(
                rc_gk, rc_glo, rc_ghi - rc_glo, h_rc,
                gather_cols([anc, d_u, p_u]), grc, 3,
            )
            gcap = grc.cap
        else:
            ri = build_range_hash(src, min_size=ms, **hk)
            (
                out[f"rc{ts_slot}_off"],
                out[f"rc{ts_slot}gx"],
                out[f"rc{ts_slot}x"],
                gcap,
            ) = _stack_range(ri, [anc, d_u, p_u], M, max(64, fan))
        rc_list.append((int(ts_slot), _round_cap(gcap), fan))

    if PART:
        metrics.default.observe(
            "prepare.partition_s", time.perf_counter() - _t_part
        )
    meta = FlatMeta(
        N=N, S1=S1,
        k1_dense=tuple(int(x) for x in maps.k1),
        k2_dense=tuple(int(x) for x in maps.k2),
        **fold_kw,
        **rev_kw,
        rc_slots=tuple(sorted(rc_list)),
        e_cap=_round_cap(eh_cap), e_n=_ceil_pow2(max(eh_n, 1)),
        usr_cap=_round_cap(usr_cap),
        usr_gn=8,  # legacy-probe geometry: unused (local shapes rule)
        us_rows=8,
        arr_cap=_round_cap(arr_cap),
        arr_gn=8,
        ar_rows=8,
        cl_cap=_round_cap(clh.cap), cl_n=_ceil_pow2(max(clh.n, 1)),
        has_closure=clh.n > 0,
        pus_cap=_round_cap(push.cap), pus_n=_ceil_pow2(max(push.n, 1)),
        ovf_cap=_round_cap(ovfh.cap), ovf_n=_ceil_pow2(max(ovfh.n, 1)),
        has_ovf=ovfh.n > 0,
        ar_fanout_by_slot=_run_maxes(ar_gkg, ar_glo, ar_ghi, N, maps.k1_raw),
        us_fanout_by_slot=_run_maxes(us_gkg, us_glo, us_ghi, N, maps.k1_raw),
        **t_kw,
        **flags,
        blockslice=True,
        sharded=True,
        ar_data_depth=ar_dd,
        e_slots=tuple(int(s) for s in _uniq_small([snap.e_rel], snap.num_slots)),
        us_slots=tuple(int(s) for s in _uniq_small([snap.us_rel], snap.num_slots)),
        has_wc_edges=bool(np.isin(snap.e_subj, wc_nodes).any()),
        has_wc_closure=bool(
            np.isin(cl.c_src[cl.c_srel1 == 0], wc_nodes).any()
            or np.isin(cl.ovf_src[cl.ovf_srel1 == 0], wc_nodes).any()
        ),
    )
    if PKD:
        with metrics.default.timer("prepare.pack_lanes_s"):
            pk_up = _pack_flat(out, meta, config, dom, pack_off=False)
        if pk_up:
            from dataclasses import replace as _dc_replace

            meta = _dc_replace(meta, **pk_up)
    # closure-delta maintenance is single-chip for now: the sharded
    # incremental prepare bails to a full rebuild on membership rows
    return out, meta, fstate, None


def _perm_table(compiled: CompiledSchema, interner) -> np.ndarray:
    """bool[interner types, slots]: slot is a *permission* on the type."""
    num_slots = max(compiled.num_slots, 1)
    t = np.zeros((max(interner.num_types, 1), num_slots), bool)
    for tname, d in compiled.schema.definitions.items():
        itid = interner.type_lookup(tname)
        if itid < 0:
            continue
        for pname in d.permissions:
            t[itid, compiled.slot_of_name[pname]] = True
    return t


_ACC_COLS = ("rel", "res", "subj", "srel1", "cav", "ctx", "exp")


def _acc_collapse(acc: Optional[Dict], di, N: int, S1: int, m1, m2) -> Dict:
    """Fold one revision's DeltaInfo into the accumulated delta state.

    ``acc`` holds the collapsed adds (payload columns keyed by primary
    identity) and tombstone identities since the base revision; identities
    pack into one int64 (both DENSE halves < 2³¹ by the radix check —
    ``m1``/``m2`` are the base meta's slot maps; the caller bails before
    accumulating any unmappable row)."""

    def pack(rel, res, subj, srel1):
        k1 = m1(rel).astype(np.int64) * N + res.astype(np.int64)
        k2 = subj.astype(np.int64) * S1 + m2(srel1).astype(np.int64)
        return (k1 << np.int64(31)) | k2

    if acc is None:
        acc = {
            "a_key": np.empty(0, np.int64),
            **{f"a_{c}": np.empty(0, np.int32) for c in _ACC_COLS},
            "g_key": np.empty(0, np.int64),
            **{f"g_{c}": np.empty(0, np.int32) for c in _ACC_COLS[:4]},
        }
    a_key = pack(di.a_rel, di.a_res, di.a_subj, di.a_srel1)
    g_key = pack(di.g_rel, di.g_res, di.g_subj, di.g_srel1)

    # Invariant: device view = (base − tombstones) ∪ adds.  EVERY touched
    # identity — deleted OR upserted — goes into the tombstone set: an
    # upsert of a row that lives in the base must void the base copy (its
    # stale payload would otherwise answer alongside the new one), and
    # tombstoning an identity the base never had is a harmless probe miss.
    touched = np.concatenate([g_key, a_key])
    keep = ~np.isin(acc["a_key"], touched)
    out = {"a_key": acc["a_key"][keep]}
    for c in _ACC_COLS:
        out[f"a_{c}"] = acc[f"a_{c}"][keep]
    gk = np.concatenate([acc["g_key"], g_key, a_key])
    gcols = {
        f"g_{c}": np.concatenate(
            [acc[f"g_{c}"], getattr(di, f"g_{c}"), getattr(di, f"a_{c}")]
        )
        for c in _ACC_COLS[:4]
    }
    order = np.argsort(gk, kind="stable")
    gk_sorted = gk[order]
    first = np.ones(gk_sorted.shape[0], bool)
    first[1:] = gk_sorted[1:] != gk_sorted[:-1]
    res = {"g_key": gk_sorted[first]}
    for c in _ACC_COLS[:4]:
        res[f"g_{c}"] = gcols[f"g_{c}"][order][first]
    new_cols = {
        "rel": di.a_rel, "res": di.a_res, "subj": di.a_subj,
        "srel1": di.a_srel1, "cav": di.a_cav, "ctx": di.a_ctx,
        "exp": di.a_exp,
    }
    merged_key = np.concatenate([out["a_key"], a_key])
    order = np.argsort(merged_key, kind="stable")
    res["a_key"] = merged_key[order]
    for c in _ACC_COLS:
        res[f"a_{c}"] = np.concatenate(
            [out[f"a_{c}"], new_cols[c].astype(np.int32)]
        )[order]
    return res


def build_delta_arrays(
    snap, prev_dsnap, compiled: CompiledSchema, config: EngineConfig
) -> Optional[Tuple[Dict[str, np.ndarray], "DeltaMeta", Dict, Dict]]:
    """Advance a blockslice-prepared DeviceSnapshot by one revision's
    delta: returns the small ``dl_*`` overlay arrays, the static DeltaMeta,
    the new accumulated-delta state, and an extras dict ({"meta_up":
    FlatMeta field overrides, "closure_state": the advanced closure host
    state}) — or None when the delta cannot be applied incrementally
    (caller does a full prepare).

    Membership-subgraph rows no longer force a rebuild: the flattened
    closure advances in place (store/closure.py advance_closure, O(Δ·depth)
    host work) and the closure-derived device tables — clx/ovfx, sized
    O(closure), not O(E) — reship with the same names and bucketing, so
    the compiled kernel keeps serving.  Baked T-index rows of groups whose
    member set changed are voided through the dirty mechanism (dl_td);
    past the dirty budget the chain flips the T-index off (sticky
    ``t_off``) and the KU path probes the live closure instead.

    Used-set SHRINK (a userset losing its last referencing row) does NOT
    bail: classification stays pinned to the chain-base superset
    (ClosureHostState.used), whose extra closure rows are unreachable by
    any probe and keep later re-references exact.

    Remaining sound-bail conditions (every one falls back to a FULL
    rebuild, never to wrong answers): affected-source set past the cap,
    newly-used userset subjects, permission-valued userset rows,
    closure-overflow or wildcard-source transitions the compiled kernel
    has no probe sites for, node-radix overflow, wildcard introduction,
    renumbered contexts, gate columns the base layout lacks, and
    accumulated-delta size beyond the compaction threshold."""
    di = getattr(snap, "delta_info", None)
    meta = prev_dsnap.flat_meta
    if (
        di is None
        or meta is None
        or not meta.blockslice
        or di.prev_revision != prev_dsnap.revision
        or di.contexts_renumbered
    ):
        return None
    prev_snap = prev_dsnap.snapshot
    used = getattr(prev_snap, "us_used_keys", None)
    if used is None:
        return None
    if snap.num_nodes > meta.N:
        return None  # node radix outgrown: repack
    if not np.array_equal(
        snap.wildcard_node_of_type, prev_snap.wildcard_node_of_type
    ):
        return None
    num_slots = snap.num_slots
    all_rel = np.concatenate([di.a_rel, di.g_rel])
    all_res = np.concatenate([di.a_res, di.g_res])
    all_subj = np.concatenate([di.a_subj, di.g_subj])
    all_srel1 = np.concatenate([di.a_srel1, di.g_srel1])
    # membership-subgraph test: a row FEEDS the closure when the userset
    # it grants is used as a subject anywhere.  Such rows ride the normal
    # dl_* overlays like any other (they ARE primary/us/ar rows) and
    # ADDITIONALLY advance the flattened closure below.  Classification
    # MUST use the closure state's own base used-set (a chain superset —
    # see ClosureHostState): a mid-chain materialization may recompute a
    # smaller truth on the snapshot, and classifying against that would
    # desynchronize the advance from its own edge sets
    chs = getattr(prev_dsnap, "closure_state", None)
    if chs is not None:
        used = chs.used
    edge_key = all_res.astype(np.int64) * num_slots + all_rel.astype(np.int64)
    mem_any = bool(np.isin(edge_key, used).any())
    if mem_any and (
        not config.closure_delta
        or meta.sharded
        or chs is None
        or not meta.has_closure
    ):
        return None
    us_rows = all_srel1 > 0
    if us_rows.any():
        subj_key = (
            all_subj[us_rows].astype(np.int64) * num_slots
            + (all_srel1[us_rows].astype(np.int64) - 1)
        )
        # a userset subject not already used would need new ms/mp rows
        if not np.isin(subj_key, used).all():
            return None
        pt = _perm_table(compiled, snap.interner)
        stypes = snap.node_type[all_subj[us_rows]]
        if pt[stypes, np.clip(all_srel1[us_rows] - 1, 0, pt.shape[1] - 1)].any():
            return None
    # gate columns ride the BASE layouts, PER VIEW: a caveated/expiring
    # delta row landing in a view whose base layout lacks that column
    # would silently evaluate ungated — bail instead
    a_is_us = di.a_srel1 > 0
    ts_set = np.asarray(sorted(compiled.tupleset_slots), np.int64)
    a_is_ar = np.isin(di.a_rel, ts_set) & (di.a_srel1 == 0)
    for mask, hascav, hasexp in (
        (slice(None), meta.e_hascav, meta.e_hasexp),  # primary: all adds
        (a_is_us, meta.us_hascav, meta.us_hasexp),
        (a_is_ar, meta.ar_hascav, meta.ar_hasexp),
    ):
        if di.a_cav[mask].any() and not hascav:
            return None
        if di.a_exp[mask].any() and not hasexp:
            return None
    # a wildcard-subject add is invisible unless the base kernel compiled
    # its wildcard probe sites
    if not meta.has_wc_edges:
        wc_nodes = snap.wildcard_node_of_type[snap.wildcard_node_of_type >= 0]
        if wc_nodes.size and np.isin(di.a_subj, wc_nodes).any():
            return None

    S1 = meta.S1
    N = meta.N
    # dense remap through the BASE meta's maps: a delta touching a slot
    # the base never packed (fresh relation first used mid-chain) has no
    # dense id — bail to a full prepare, which rebuilds the maps.  The
    # check runs BEFORE accumulation so unmappable keys never enter the
    # chain state
    k1d = np.asarray(meta.k1_dense, np.int32)
    k2d = np.asarray(meta.k2_dense, np.int32)

    def m1(rel):
        return k1d[np.clip(rel, 0, max(k1d.shape[0] - 1, 0))]

    def m2(srel1):
        return np.where(
            srel1 == 0, 0,
            k2d[np.clip(srel1 - 1, 0, max(k2d.shape[0] - 1, 0))] + 1,
        )

    for rel_col, srel_col in (
        (di.a_rel, di.a_srel1), (di.g_rel, di.g_srel1)
    ):
        if rel_col.shape[0] and (
            (m1(rel_col) < 0).any()
            or (m2(srel_col) <= 0)[srel_col > 0].any()
        ):
            return None
    prev_acc = getattr(prev_dsnap, "delta_acc", None)
    acc = _acc_collapse(prev_acc, di, N, S1, m1, m2)
    # chain-stable anchor for the shape floor below: the BASE revision's
    # edge count (a floor derived from the oscillating current count
    # would retrace on every boundary crossing)
    acc["base_edges"] = (
        prev_acc["base_edges"] if prev_acc else int(prev_snap.num_edges)
    )
    if prev_acc and prev_acc.get("pf_off"):
        acc["pf_off"] = True  # sticky downgrade for the chain remainder
    if prev_acc:
        if prev_acc.get("t_off"):
            acc["t_off"] = True  # sticky T disable for the chain remainder
        elif prev_acc.get("cl_dirty_k1") is not None:
            acc["cl_dirty_k1"] = prev_acc["cl_dirty_k1"]
    if meta.rc_slots:
        # rows of a FLATTENED tupleset shift its ancestor closure: bail
        # EARLY (before any table builds) to a full rebuild.  Incremental
        # rc-closure maintenance is a possible future middle ground
        rc_ts = np.asarray([t for t, _, _ in meta.rc_slots], np.int64)
        if (
            (np.isin(acc["a_rel"], rc_ts) & (acc["a_srel1"] == 0)).any()
            or (np.isin(acc["g_rel"], rc_ts) & (acc["g_srel1"] == 0)).any()
        ):
            return None
    n_adds = acc["a_key"].shape[0]
    n_tombs = acc["g_key"].shape[0]
    if n_adds + n_tombs > max(
        config.flat_delta_min_compact, snap.num_edges // 8
    ):
        return None  # compaction: fold the delta into a fresh base

    out: Dict[str, np.ndarray] = {}
    meta_up: Dict = {}
    new_chs = chs
    # packed-base maintenance: reshipped closure-derived tables repack
    # with the BASE spec (no retrace) when their values still fit; a
    # value outside the pinned domain (e.g. a fresh expiring membership
    # edge under a {NEVER, NO_EXP} dictionary) DESPECS that one table —
    # the kernel reads it raw for the rest of the chain (one retrace,
    # never a wrong decode)
    from . import packed as _pkm

    pk_map = dict(meta.packed)
    pko_map = dict(meta.packed_off)
    pk_drop: set = set()
    pko_drop: set = set()
    drop_keys: List[str] = []
    hk = (
        {"max_factor": config.flat_packed_max_factor, "lean": True}
        if config.packed_on() else {}
    )

    def _repack_tbl(tbl_key: str, tbl: np.ndarray) -> np.ndarray:
        spec = pk_map.get(tbl_key)
        if spec is None or tbl_key in pk_drop:
            return tbl
        try:
            return _pkm.pack_rows(tbl, spec)
        except _pkm.PackError:
            pk_drop.add(tbl_key)
            return tbl

    def _reship_off(off_key: str, off: np.ndarray) -> None:
        if off_key in pko_map and off_key not in pko_drop:
            got = _pkm.pack_off(off)
            if got is not None:
                out[off_key], out[off_key + "_a"] = got
                return
            pko_drop.add(off_key)
            drop_keys.append(off_key + "_a")
        out[off_key] = off

    def _extras() -> Dict:
        # runs once per successful incremental advance; a revision span
        # > 1 means this ONE device reship covered a whole write group
        if int(snap.revision) - int(prev_dsnap.revision) > 1:
            from ..utils import metrics as _metrics

            _metrics.default.inc("flat.group_reships")
        if pk_drop:
            meta_up["packed"] = tuple(
                t for t in meta.packed if t[0] not in pk_drop
            )
        if pko_drop:
            meta_up["packed_off"] = tuple(
                t for t in meta.packed_off if t[0] not in pko_drop
            )
        return {
            "meta_up": meta_up, "closure_state": new_chs,
            "drop_keys": drop_keys,
        }

    # ---- membership-closure advance ------------------------------------
    if mem_any:
        from ..store.closure import advance_closure

        S1r = np.int64(num_slots + 1)
        a_mem = np.isin(
            di.a_res.astype(np.int64) * num_slots + di.a_rel, used
        )
        g_mem = np.isin(
            di.g_res.astype(np.int64) * num_slots + di.g_rel, used
        )

        def edges4(mask):
            if not mask.any():
                return None
            return (
                di.a_subj[mask].astype(np.int64) * S1r + di.a_srel1[mask],
                di.a_res[mask].astype(np.int64) * S1r + di.a_rel[mask] + 1,
                di.a_cav[mask], di.a_exp[mask],
            )

        def edges2(mask):
            if not mask.any():
                return None
            return (
                di.g_subj[mask].astype(np.int64) * S1r + di.g_srel1[mask],
                di.g_res[mask].astype(np.int64) * S1r + di.g_rel[mask] + 1,
            )

        adv = advance_closure(
            chs.st, snap.revision,
            pair_add=edges4(a_mem & (di.a_srel1 > 0)),
            pair_del=edges2(g_mem & (di.g_srel1 > 0)),
            seed_add=edges4(a_mem & (di.a_srel1 == 0)),
            seed_del=edges2(g_mem & (di.g_srel1 == 0)),
            affected_cap=config.closure_delta_affected_cap,
        )
        if adv is None:
            return None  # affected set over cap / unconverged: rebuild
        new_cl = adv.state.cl
        wc_nodes = snap.wildcard_node_of_type[snap.wildcard_node_of_type >= 0]
        # transitions the compiled kernel has no probe sites for: overflow
        # appearing under a no-ovf kernel, or under an armed fold (fold
        # eligibility requires an overflow-free closure, so any overflow
        # here IS a transition)
        if adv.state.ovf.shape[0] and (not meta.has_ovf or meta.fold_pairs):
            return None
        if (
            not meta.has_wc_closure
            and wc_nodes.size
            and np.isin(
                (adv.affected_users // S1r).astype(np.int32), wc_nodes
            ).any()
        ):
            return None  # wildcard closure source may appear: rebuild

        # dense-repacked closure keys (the advance cannot introduce slots
        # the base maps lack — `used` is stable — but verify cheaply)
        m_srel = m2(new_cl.c_srel1)
        if ((m_srel <= 0) & (new_cl.c_srel1 > 0)).any():
            return None
        grel_d = k2d[np.clip(new_cl.c_grel, 0, max(k2d.shape[0] - 1, 0))]
        if new_cl.c_grel.shape[0] and (grel_d < 0).any():
            return None
        cl_k1 = (
            new_cl.c_src.astype(np.int64) * S1 + m_srel
        ).astype(np.int32)
        cl_k2 = (
            new_cl.c_g.astype(np.int64) * S1 + grel_d + 1
        ).astype(np.int32)
        aligned_tbls = {t[0]: (t[1], t[2]) for t in meta.aligned}

        def reship_point(tbl_key, off_key, key_cols, cols,
                         cap_key, n_key):
            """Rebuild one closure-derived point table in the base
            layout.  Aligned tables must reproduce their exact geometry
            (width/cap ladder are part of the compiled kernel) — a
            mismatch rebuilds; the legacy layout just re-buckets and
            records the (pow2-stable) cap/size in meta_up.  Packed
            tables repack under the base spec (despec'd on misfit)."""
            if tbl_key in aligned_tbls and tbl_key + "_al" in prev_dsnap.arrays:
                ai = build_aligned(
                    key_cols, cols, max_bytes=config.flat_aligned_max_bytes,
                    cover=config.flat_aligned_cover,
                )
                if ai is None or (ai.w, ai.caps) != aligned_tbls[tbl_key]:
                    return False
                spec = pk_map.get(tbl_key)
                packed_lvls = []
                if spec is not None and tbl_key not in pk_drop:
                    try:
                        for tbl, _c in ai.levels:
                            size, roww = tbl.shape
                            cap = roww // ai.w
                            packed_lvls.append(_pkm.pack_rows(
                                tbl.reshape(size * cap, ai.w), spec
                            ).reshape(size, cap * spec[1]))
                    except _pkm.PackError:
                        pk_drop.add(tbl_key)
                        packed_lvls = []
                if packed_lvls:
                    for lvl, tbl in enumerate(packed_lvls):
                        out[_al_key(tbl_key, lvl)] = tbl
                else:
                    for lvl, (tbl, _c) in enumerate(ai.levels):
                        out[_al_key(tbl_key, lvl)] = tbl
                return True
            h = build_hash(key_cols, **hk)
            _reship_off(off_key, h.off)
            out[tbl_key] = _repack_tbl(tbl_key, interleave_buckets(h, cols))
            meta_up[cap_key] = _round_cap(h.cap)
            meta_up[n_key] = _ceil_pow2(max(h.n, 1))
            return True

        if not reship_point(
            "clx", "clh_off", [cl_k1, cl_k2],
            [cl_k1, cl_k2, new_cl.c_d_until, new_cl.c_p_until],
            "cl_cap", "cl_n",
        ):
            return None
        if meta.has_ovf:
            ovf_srel_d = m2(new_cl.ovf_srel1)
            if ((ovf_srel_d <= 0) & (new_cl.ovf_srel1 > 0)).any():
                return None
            ovf_k = (
                new_cl.ovf_src.astype(np.int64) * S1 + ovf_srel_d
            ).astype(np.int32)
            if not reship_point(
                "ovfx", "ovfh_off", [ovf_k], [ovf_k], "ovf_cap", "ovf_n"
            ):
                return None
        if meta.fold_pairs:
            # the fold's subject-side csr view IS the closure re-keyed by
            # source: reship it alongside clx so pf intersections see the
            # advanced membership.  Gated on the fold being ARMED, not on
            # pf_has_u — a fold with no base userset rows can still grow
            # dl_pfu overlay rows mid-chain, and those intersect against
            # these tables
            from ..store.closure import NO_EXP as _NO_EXP

            s_run = _max_run_sorted(cl_k1)
            if s_run > config.flat_fold_subj_fan_cap:
                return None  # a subject's closure outgrew the tile cap
            s_fan = _round_fan(max(s_run, 1))
            pad_s = max(64, s_fan)
            out["csr_gk"] = _pf_col(cl_k2, pad_s, -1)
            s_alllive = (
                bool(
                    (new_cl.c_d_until == _NO_EXP).all()
                    and (new_cl.c_p_until == _NO_EXP).all()
                )
                if cl_k1.shape[0] else True
            )
            if not s_alllive:
                out["csr_d"] = _pf_col(new_cl.c_d_until, pad_s, 0)
                out["csr_p"] = _pf_col(new_cl.c_p_until, pad_s, 0)
            meta_up["pf_s_fan"] = s_fan
            meta_up["pf_s_alllive"] = s_alllive
            # hash-backed csr along the chain: rebuilding the dense
            # offset array per revision costs more host time + H2D than
            # the whole write budget; the probe-side hash penalty only
            # applies until the next full prepare restores direct
            csr = build_range_hash(cl_k1, **hk)
            _reship_off("csr_off", csr.index.off)
            out["csrgx"] = _repack_tbl("csrgx", interleave_buckets(
                csr.index, [csr.gk, csr.glo, csr.ghi]
            ))
            meta_up["pf_s_cap"] = _round_cap(csr.index.cap)
            if meta.pf_s_direct:
                # the direct offset array (and its packed anchor, when
                # the base packed it) is dead for the rest of the chain:
                # drop it so device_bytes stays honest
                drop_keys.extend(["csr_start", "csr_start_a"])
                if "csr_start" in pko_map:
                    pko_drop.add("csr_start")
            meta_up["pf_s_direct"] = False

        # stale baked T rows: every T-covered userset row whose group's
        # member set changed gets its (slot·N + res) key dirtied; past
        # the budget the chain turns the T-index off instead
        if meta.has_tindex and not acc.get("t_off"):
            from ..store.closure import _expand_join as _xj

            if adv.changed_dsts.shape[0] and new_chs.t_pe.shape[0]:
                _, ii = _xj(new_chs.t_pe, adv.changed_dsts)
                fresh_dirty = np.unique(new_chs.t_k1[ii])
            else:
                fresh_dirty = np.zeros(0, np.int32)
            prev_dirty = acc.get("cl_dirty_k1")
            dirty = (
                np.union1d(prev_dirty, fresh_dirty)
                if prev_dirty is not None else fresh_dirty
            )
            if dirty.shape[0] > config.flat_tindex_dirty_cap:
                acc["t_off"] = True
                acc.pop("cl_dirty_k1", None)
            elif dirty.shape[0]:
                acc["cl_dirty_k1"] = dirty.astype(np.int32)
        new_chs = ClosureHostState(adv.state, chs.used, chs.t_pe, chs.t_k1)

    def pk(a, radix, b):
        return (a.astype(np.int64) * radix + b).astype(np.int32)

    a_k1 = pk(m1(acc["a_rel"]), N, acc["a_res"])
    a_k2 = pk(acc["a_subj"], S1, m2(acc["a_srel1"]))
    g_k1 = pk(m1(acc["g_rel"]), N, acc["g_res"])
    g_k2 = pk(acc["g_subj"], S1, m2(acc["g_srel1"]))

    # shape floor: every dl_* table pre-sizes to F rows (2F buckets), so
    # a chain of Watch revisions reuses ONE compiled kernel — without it,
    # each pow2 row-count boundary retraces (~1s), dominating the
    # re-index loop.  Scaled down for small graphs where retraces are
    # cheap and the floor would out-size the base
    F = min(
        config.flat_delta_floor,
        _ceil_pow2(max(64, acc["base_edges"] // 4)),
    )

    def _q4(n: int) -> int:
        # pow2 with the exponent rounded up to EVEN — shapes step in 4×
        # bands, so a chain whose accumulated rows outgrow the F floor
        # retraces half as often on its way to the compaction bound
        p = _ceil_pow2(max(n, 1))
        return p if (p.bit_length() - 1) % 2 == 0 else p << 1

    def dlband(n: int) -> int:
        """THE shared shape band of a dl_* table of ``n`` rows: the 2F
        floor, then 4×-quantized steps.  Both the hash size and the
        interleave pad derive from this one value, so a table's off and
        row shapes step at the same revision (one retrace, not two) —
        including when F itself is an odd power of two."""
        return max(2 * F, _q4(4 * n))

    dlpad = dlband  # interleave pad target — same band by construction

    def floored_hash(cols):
        # deterministic sizing (max_factor=1): the adaptive cap-chasing
        # growth in build_hash would re-step the off shape at pow2
        # boundaries of its own; a fixed ≤0.25 load factor in 4× bands
        # keeps shapes put, and the declared probe caps below carry a
        # floor of 16 to absorb the occupancy wobble that load allows
        n = int(cols[0].shape[0]) if cols else 0
        return build_hash(cols, min_size=dlband(n), max_factor=1)

    kw = {}
    if n_adds:
        eh = floored_hash([a_k1, a_k2])
        out["dl_eh_off"] = eh.off
        out["dl_ehx"] = interleave_buckets(
            eh,
            [a_k1, a_k2]
            + ([acc["a_cav"], acc["a_ctx"]] if meta.e_hascav else [])
            + ([acc["a_exp"]] if meta.e_hasexp else []),
            pad=dlpad(n_adds),
        )
        kw.update(
            has_adds=True,
            e_cap=_round_cap(max(16, eh.cap)),
            e_slots=tuple(int(s) for s in np.unique(acc["a_rel"])),
            e_hascav=meta.e_hascav,
            e_hasexp=meta.e_hasexp,
        )
    if n_tombs:
        tb = floored_hash([g_k1, g_k2])
        out["dl_tb_off"] = tb.off
        out["dl_tbx"] = interleave_buckets(tb, [g_k1, g_k2], pad=dlpad(n_tombs))
        kw.update(has_tombs=True, tb_cap=_round_cap(max(16, tb.cap)))

    # delta userset view (adds with a subject relation)
    am = acc["a_srel1"] > 0
    if am.any():
        gk_all = a_k1[am]
        order = np.argsort(gk_all, kind="stable")
        u_gk = gk_all[order]
        usr = build_range_hash(
            u_gk, min_size=max(2 * F, _q4(4 * int(u_gk.shape[0]))),
            max_factor=1,
        )
        out["dl_usr_off"] = usr.index.off
        out["dl_usgx"] = interleave_buckets(
            usr.index, [usr.gk, usr.glo, usr.ghi], pad=dlpad(int(am.sum()))
        )
        cols = [
            acc["a_subj"][am][order],
            # dense srel, matching the base us view and the closure keys
            (m2(acc["a_srel1"][am]) - 1)[order],
        ]
        if meta.us_hascav:
            cols += [acc["a_cav"][am][order], acc["a_ctx"][am][order]]
        if meta.us_hasexp:
            cols += [acc["a_exp"][am][order]]
        if meta.us_hasperm:
            # permission-valued delta rows bail above: flag column is 0
            cols += [np.zeros(int(am.sum()), np.int32)]
        # fan floor 8: per-group occupancy creeps up as a chain
        # accumulates, and each pow2 step would retrace
        fan = _round_fan(max(8, min(usr.max_run, 32)))
        out["dl_usx"] = interleave_rows(cols, pad=max(dlpad(int(am.sum())), fan))
        kw.update(
            has_us=True,
            us_cap=_round_cap(max(16, usr.index.cap)),
            us_fan=fan,
            us_slots=tuple(int(s) for s in np.unique(acc["a_rel"][am])),
        )
    gm = acc["g_srel1"] > 0
    if gm.any():
        utb = floored_hash([g_k1[gm], g_k2[gm]])
        out["dl_utb_off"] = utb.off
        out["dl_utbx"] = interleave_buckets(
            utb, [g_k1[gm], g_k2[gm]], pad=dlpad(int(gm.sum()))
        )
        kw.update(has_ustomb=True, utb_cap=_round_cap(max(16, utb.cap)))
    if acc.get("t_off"):
        kw.update(t_off=True)  # T disabled: no voiding needed, KU answers
    elif meta.has_tindex:
        dirty_parts = []
        if gm.any():
            dirty_parts.append(np.unique(
                g_k1[gm][
                    np.isin(acc["g_rel"][gm], np.asarray(meta.t_slots, np.int64))
                ]
            ))
        cld = acc.get("cl_dirty_k1")
        if cld is not None and cld.shape[0]:
            dirty_parts.append(cld)
        dirty = (
            np.unique(np.concatenate(dirty_parts))
            if dirty_parts else np.zeros(0, np.int32)
        )
        if dirty.size:
            td = floored_hash([dirty])
            out["dl_td_off"] = td.off
            out["dl_tdx"] = interleave_buckets(
                td, [dirty], pad=dlpad(int(dirty.size))
            )
            kw.update(t_dirty=True, td_cap=_round_cap(max(16, td.cap)))

    # delta arrow view (tupleset relations, direct subjects)
    ts = np.asarray(sorted(compiled.tupleset_slots), np.int64)
    aam = np.isin(acc["a_rel"], ts) & (acc["a_srel1"] == 0)
    if aam.any():
        gk_all = a_k1[aam]
        order = np.argsort(gk_all, kind="stable")
        arr = build_range_hash(
            gk_all[order],
            min_size=max(2 * F, _q4(4 * int(gk_all.shape[0]))),
            max_factor=1,
        )
        out["dl_arr_off"] = arr.index.off
        out["dl_argx"] = interleave_buckets(
            arr.index, [arr.gk, arr.glo, arr.ghi], pad=dlpad(int(aam.sum()))
        )
        cols = [acc["a_subj"][aam][order]]
        if meta.ar_hascav:
            cols += [acc["a_cav"][aam][order], acc["a_ctx"][aam][order]]
        if meta.ar_hasexp:
            cols += [acc["a_exp"][aam][order]]
        fan = _round_fan(max(8, min(arr.max_run, 32)))
        out["dl_arx"] = interleave_rows(cols, pad=max(dlpad(int(aam.sum())), fan))
        kw.update(
            has_ar=True,
            ar_cap=_round_cap(max(16, arr.index.cap)),
            ar_fan=fan,
            ar_slots=tuple(int(s) for s in np.unique(acc["a_rel"][aam])),
        )
    gam = np.isin(acc["g_rel"], ts) & (acc["g_srel1"] == 0)
    if gam.any():
        # identity for arrow-candidate masking is (group key, child node) —
        # the kernel holds the child id, not the packed subject key
        atb = floored_hash([g_k1[gam], acc["g_subj"][gam]])
        out["dl_atb_off"] = atb.off
        out["dl_atbx"] = interleave_buckets(
            atb, [g_k1[gam], acc["g_subj"][gam]], pad=dlpad(int(gam.sum()))
        )
        kw.update(has_artomb=True, atb_cap=_round_cap(max(16, atb.cap)))

    # permission-fold maintenance: folded slots KEEP answering from the
    # pf probe pair across the chain — base hits at dirty resources are
    # voided and replacement rows (recomputed for exactly those
    # resources against current data) ride small replicated overlays.
    # When the subset recompute can't stay sound/cheap it DOWNGRADES
    # (sticky pf_off: folded pairs walk, with the overlays, until
    # compaction re-folds) rather than forcing an O(E) rebuild
    if meta.fold_pairs:
        fstate = getattr(prev_dsnap, "fold_state", None)
        from .fold import fold_delta_update

        got = None
        if fstate is not None and not acc.get("pf_off"):
            got = fold_delta_update(fstate, acc, snap.node_type, config)
        if got is None:
            acc["pf_off"] = True
            kw.update(pf_off=True)
            return out, DeltaMeta(**kw), acc, _extras()
        dirty_k1, ovl = got
        if dirty_k1.shape[0]:
            pdh = floored_hash([dirty_k1])
            out["dl_pfd_off"] = pdh.off
            out["dl_pfdx"] = interleave_buckets(
                pdh, [dirty_k1], pad=dlpad(int(dirty_k1.shape[0]))
            )
            kw.update(pf_dirty=True, pfd_cap=_round_cap(max(16, pdh.cap)))
        if ovl is not None:
            packed = _fold_packed(ovl, snap, fstate.maps, N, config)
            if packed is None:
                # overlay fan past the cap: downgrade the chain (sticky
                # pf_off — folded pairs walk until compaction re-folds)
                acc["pf_off"] = True
                kw.update(pf_off=True)
                return out, DeltaMeta(**kw), acc, _extras()
            pf_k1, pf_k2, pf_subj, (u_k1, u_gk, u_until, u_fan), pff = packed
            if pf_k1.shape[0]:
                peh = floored_hash([pf_k1, pf_k2])
                out["dl_pfe_off"] = peh.off
                out["dl_pfex"] = interleave_buckets(
                    peh,
                    [pf_k1, pf_k2]
                    + ([ovl.e_cav, ovl.e_ctx] if pff["pf_hascav"] else [])
                    + ([ovl.e_until] if pff["pf_hasuntil"] else []),
                    pad=dlpad(int(pf_k1.shape[0])),
                )
                kw.update(
                    pf_ovl_e=True,
                    pfo_e_cap=_round_cap(max(16, peh.cap)),
                    pf_ovl_hascav=pff["pf_hascav"],
                    pf_ovl_hasuntil=pff["pf_hasuntil"],
                    pf_ovl_haswc=bool(
                        np.isin(pf_subj, fstate.wc_nodes).any()
                    ),
                )
            if u_k1.shape[0]:
                n_u = int(u_k1.shape[0])
                pfu = build_range_hash(
                    u_k1, min_size=max(2 * F, _q4(4 * n_u)), max_factor=1
                )
                out["dl_pfu_off"] = pfu.index.off
                out["dl_pfugx"] = interleave_buckets(
                    pfu.index, [pfu.gk, pfu.glo, pfu.ghi], pad=dlpad(n_u)
                )
                fan = _round_fan(max(8, u_fan))
                out["dl_pfux"] = interleave_rows(
                    [u_gk, u_until], pad=max(dlpad(n_u), fan)
                )
                kw.update(
                    pf_ovl_u=True,
                    pfo_u_cap=_round_cap(max(16, pfu.index.cap)),
                    pfo_u_fan=fan,
                )

    return out, DeltaMeta(**kw), acc, _extras()



class _WitColl:
    """Witness-mask collector (the armed program only).  ``add``
    OR-accumulates a branch's definite mask, gated by the collector's
    selection mask (which root slot / node type the enclosing program
    applies to): an ungated mask from another type's program must never
    claim a branch for a query it cannot grant.  Masks that are not 1-D
    (deeper node lattices: arrow children, rc ancestors) are skipped, so
    grants found there report as the ``rewrite`` branch."""

    __slots__ = ("store", "mask")

    def __init__(self, store, mask=None):
        self.store = store
        self.mask = mask

    def add(self, key, m):
        if m.dim() != 1:
            return
        if self.mask is not None:
            m = m & self.mask
        prev = self.store.get(key)
        self.store[key] = m if prev is None else (prev | m)

    def masked(self, mask):
        return _WitColl(
            self.store,
            mask if self.mask is None else (self.mask & mask),
        )


def make_flat_fn(
    compiled: CompiledSchema,
    plan: DevicePlan,
    cfg: EngineConfig,
    meta: FlatMeta,
    slots: Tuple[int, ...],
    kernels: bool = False,
    caveat_plan=None,
    witness: bool = False,
    axis: Optional[str] = None,
    model_size: int = 1,
):
    """Build the batched flat check function for a static set of permission
    slots.  Queries select their slot's result with a vectorized compare —
    evaluating ≤ flat_max_slots programs over the whole batch is far
    cheaper than any per-query dispatch.

    The returned ``fn(arrs, tid_map, now, qm, qctx, specs)`` runs eagerly on
    the device of its tensors and returns bool (definite, possible,
    overflow) planes of the padded batch.  ``now`` is the snapshot-relative
    clock, an int or a 0-dim int32 tensor on that device (the engine
    passes a tensor: the kernels read it by pointer, so a CUDA graph of
    ``fn`` answers at the clock its caller fills in before each replay).
    ``fn`` makes no host copy and no host sync: its constants are built
    once per device (engine/consts.py), so it can be captured whole.
    ``qctx`` holds the batch's encoded request contexts
    (``vi``/``vf``/``pr``/``host``), which row 5 of ``qm`` indexes; with
    ``caveat_plan`` a caveated row's gate runs the
    CEL tri-state VM (caveats/device.py ``make_tri_fn``) on its caveat id,
    its stored context (``ectx_*`` arrays) and the query's context:
    TRUE grants both planes, UNKNOWN only the possible one.  Every bucket
    probe goes through ONE seam, ``psite``, into ``kernels.fused_probe``
    (or ``fused_probe_aligned`` for a bucket-aligned table): the
    hand-written CUDA kernel when ``kernels`` is True, else its plain
    PyTorch twin.  Both compute the reference's gather chain bit for bit,
    so the planes do not depend on the switch.

    A delta level (``meta.delta``, a DeltaMeta from build_delta_arrays)
    rides on the base tables: its small ``dl_*`` overlays (adds,
    tombstones, T-dirty and fold-dirty voids, replacement fold rows) are
    probed through the plain ``probe_block``, as the reference probes
    them, and composed with the base sites' answers; base tables stay on
    ``psite``.

    ``witness=True`` arms decision provenance: ``fn`` returns a fourth
    int32 plane, a per-query witness code naming the winning branch
    (self / direct edge / wildcard / T-probe / fold / userset x closure
    / rewrite, plus a recursion-level class; codes in engine/explain.py)
    of device-definite allowed verdicts, 0 elsewhere.  The masks are the
    ones the probe sites compute anyway (after the delta overlays are
    composed with them), so the armed program launches the same kernels
    and adds only the final select cascade, a few elementwise ops over
    the batch.  Disarmed (the default) the program is the same ops and
    launches, and returns three planes.

    The scattered layout (``meta.blockslice`` False: bucket offsets, a
    row permutation and full-width int32 columns) probes every site with
    the plain ``probe_rows``/``probe_range`` gathers, as the reference
    does: it has no ``psite`` call, so it launches no probe kernel
    whatever ``kernels`` says.  It has no fold, no ancestor closure and
    no delta level.

    With ``axis`` (the model axis of a mesh, parallel/sharded.py; tables
    built by ``build_flat_arrays_sharded`` across ``model_size`` shards)
    ``fn`` runs once per shard, over that shard's slice of every stacked
    table, and takes a fifth keyword ``comm``: the shard's
    ``parallel.collectives.Collectives`` handle.  Every base-table probe
    hashes globally, masks bucket ownership and probes locally; boolean
    site outputs OR-reduce over the axis (``comm.por``), and userset /
    arrow / closure candidate blocks broadcast from their single owning
    shard (``comm.psum`` of the masked block) — the reference's
    shard-mapped program, collective for collective.  Those probes are
    plain gathers: no probe kernel launches on a mesh, whatever
    ``kernels`` says, as the reference runs no Pallas kernel there.  The
    delta overlays stay replicated and probe plainly, after the base
    sites' reductions.  The partitioned serve (``meta.part_serve``) is
    not ported and raises NotImplementedError."""
    if meta.part_serve:
        raise NotImplementedError(
            "the partitioned serve (with_mesh(partitioned=True)) is not"
            " ported yet")
    SH = axis is not None
    if SH != meta.sharded:
        raise ValueError(
            "kernel/layout mismatch: bucket-sharded tables need the model"
            " axis and vice versa (FlatMeta.sharded vs make_flat_fn axis)")
    BS = meta.blockslice
    tri = make_tri_fn(caveat_plan) if caveat_plan is not None else None
    perm_programs: Dict[int, List[Tuple[str, int, ExprIR]]] = {}
    for (tname, tid, slot, expr) in plan.topo_programs:
        perm_programs.setdefault(slot, []).append((tname, tid, expr))
    # flattened recursive hierarchies whose closure tables were built:
    # (type, slot) → (ts_slot, rest_ir); geometry per ts_slot from meta
    rc_geom = {ts: (cap, fan) for ts, cap, fan in meta.rc_slots}
    rc_map = {
        key: (ts_slot, rest)
        for key, (ts_slot, rest) in rc_candidates(compiled, plan).items()
        if ts_slot in rc_geom
    }
    rel_slots = frozenset(plan.rel_leaf_slots)
    dm = meta.delta
    # permission fold: BASE answers come from the pf_e/pf_u probe pair;
    # folded programs compile to nothing.  A delta level keeps the fold
    # armed (dirty resources voided, replacement rows from the dl_pf*
    # overlays) until the chain's sticky downgrade (pf_off), after which
    # folded pairs run their walked programs
    fold_on = bool(meta.fold_pairs) and not (dm is not None and dm.pf_off)
    folded_pairs = frozenset(meta.fold_pairs) if fold_on else frozenset()
    pf_slots = frozenset(s for _, s in folded_pairs)
    fold_slot_list = sorted({s for _, s in meta.fold_pairs})
    cyclic = _eval_cyclic_pairs(compiled)
    KU = cfg.us_leaf_cap
    K = cfg.arrow_fanout
    all_types = frozenset(compiled.type_ids)
    tname_of_tid = {tid: t for t, tid in compiled.type_ids.items()}

    def arrow_child_types(ts_slot: int, types: frozenset) -> frozenset:
        """Types an arrow through ``ts_slot`` can reach from ``types`` —
        the static pruning that makes the unroll follow the TYPE-level
        dependency graph, not name collisions."""
        out = set()
        for tname in types:
            ct = compiled.types[compiled.type_ids[tname]]
            rel = ct.relations.get(ts_slot)
            if rel is None:
                continue
            for a in rel.allowed:
                if a.relation_slot < 0:  # arrows traverse direct subjects
                    out.add(tname_of_tid[a.type_id])
        return frozenset(out)

    K1D = meta.k1_dense  # static sites pack with DENSE slot ids

    def k1c(slot: int) -> int:
        return K1D[slot] if slot < len(K1D) else -1

    PK = dict(meta.packed)
    PKO = dict(meta.packed_off)
    ALD = {k: (w, caps) for (k, w, caps) in meta.aligned}
    eL, usL, arL = e_layout(meta), us_layout(meta), ar_layout(meta)
    _view_flags = {
        "e": (meta.e_hascav, meta.e_hasexp),
        "us": (meta.us_hascav, meta.us_hasexp),
        "ar": (meta.ar_hascav, meta.ar_hasexp),
    }
    us_fans = dict(meta.us_fanout_by_slot)
    # the dynamic root leaf serves exactly the dispatch's static slot
    # set: base sites whose slots can't occur compile to nothing
    dyn_e = any(s in meta.e_slots for s in slots)
    dyn_us_fan = max((us_fans.get(s, 0) for s in slots), default=0)
    # sticky chain-level T disable (membership deltas staled more baked T
    # rows than the dirty budget): the KU path probes the live closure
    t_on = meta.has_tindex and not (dm is not None and dm.t_off)
    t_cover = t_on and all(
        s in meta.t_slots for s in slots if s in meta.us_slots
    )
    dyn_t = t_on and t_cover and any(s in meta.t_slots for s in slots)
    pfL = _lay(
        ["k1", "k2"]
        + (["cav", "ctx"] if meta.pf_hascav else [])
        + (["until"] if meta.pf_hasuntil else [])
    )
    Nc = meta.N
    S1c = meta.S1
    # arrow-recursion cut at the data's longest arrow chain; a delta level
    # with arrow adds may deepen chains, so it reverts to the schema's
    # recursion budget
    ar_bound = meta.ar_data_depth
    if dm is not None and dm.has_ar:
        ar_bound = -1

    # fold-slot compact ids for the direct pfu_start lookup (host side,
    # built once; the device copy is a cached constant)
    if fold_on and meta.pf_has_u and meta.pf_direct:
        pf_fidx_np = np.full(max(plan.num_slots, 1), -1, np.int32)
        for _i, _s in enumerate(fold_slot_list):
            pf_fidx_np[_s] = _i
    else:
        pf_fidx_np = None

    def fn(arrs, tid_map, now, qm, qctx, specs, comm=None):
        dev = qm.device
        # packed query matrix int32[8, B] (QM_LAYOUT); rows 3 and 7
        # arrive DENSE-mapped (build_qm)
        q_res, q_perm, q_subj = qm[0], qm[1], qm[2]
        q_srel1, q_wc, q_ctx = qm[3], qm[4], qm[5]
        q_self = qm[6] != 0
        q_perm_k1 = qm[7]
        if tri is not None:
            tables = {
                "ectx_vi": arrs["ectx_vi"], "ectx_vf": arrs["ectx_vf"],
                "ectx_pr": arrs["ectx_pr"], "ectx_host": arrs["ectx_host"],
                "qctx_vi": qctx["vi"], "qctx_vf": qctx["vf"],
                "qctx_pr": qctx["pr"], "qctx_host": qctx["host"],
            }
        else:
            tables = None
        node_type = arrs["node_type"]
        # ids interned AFTER this snapshot exceed the packing radix: treat
        # them as invalid (-1) — they have no edges at this revision
        q_res = torch.where(q_res < Nc, q_res, -1)
        q_subj = torch.where(q_subj < Nc, q_subj, -1)
        q_wc = torch.where(q_wc < Nc, q_wc, -1)
        # wildcard closure-source only applies to direct-object subjects
        q_wcc = torch.where(q_srel1 == 0, q_wc, -1)

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.bool, device=dev)

        def arange(n: int):
            return torch.arange(n, dtype=torch.int32, device=dev)

        def bq(a, nd: int):
            """Broadcast a [B] query column against [B, ...] node dims."""
            return a.reshape(tuple(a.shape) + (1,) * (nd - 1))

        def reduceB(x):
            return x if x.dim() == 1 else x.reshape(x.shape[0], -1).any(-1)

        def any2(x):
            return x.any(dim=-1).any(dim=-1)

        tk = take_in_bounds  # indices below are clipped non-negative

        def _dec(tbl_key: str, blk):
            spec = PK.get(tbl_key)
            return blk.to(torch.int32) if spec is None else _pk_decode(blk, spec)

        def off_read(off_key: str, idx):
            A = PKO.get(off_key)
            if A is None:
                return tk(arrs[off_key], idx)
            return tk(arrs[off_key + "_a"], idx >> A) + (
                tk(arrs[off_key], idx).to(torch.int32) & 0xFFFF
            )

        def sblock(tbl_key: str, lo, cap: int):
            """slice_blocks through the packed decode."""
            return _dec(tbl_key, slice_blocks(arrs[tbl_key], lo, cap))

        def tri_planes(live, cav, ctxc):
            """(definite, possible) of live caveated rows: caveat 0
            grants both; else the tri VM on the caveat id, the stored
            context and the query's context (stored wins) — TRUE both,
            UNKNOWN possible only.  (Caveated rows exist only in schemas
            that declare caveats, whose engine passes ``caveat_plan``.)"""
            qb = bq(q_ctx, cav.dim()).expand(cav.shape)
            t = tri(cav, ctxc, qb, tables)
            return live & (t == 2), live & (t >= 1)

        def gate2(prefix: str, rowidx, hit):
            """(definite, possible) admissibility of the hit rows of a
            raw per-edge view (the scattered layout), the CEL VM run once
            a site and skipped for views with no caveated or expiring
            rows."""
            hascav, hasexp = _view_flags[prefix]
            if not hascav and not hasexp:
                return hit, hit
            rc = rowidx.clamp(0, arrs[prefix + "_caveat"].shape[0] - 1)
            live = hit
            if hasexp:
                exp = tk(arrs[prefix + "_exp"], rc)
                live = hit & ((exp == 0) | (exp > now))
            if not hascav:
                return live, live
            cav = tk(arrs[prefix + "_caveat"], rc)
            if tri is None:
                return live & (cav == 0), live
            return tri_planes(live, cav, tk(arrs[prefix + "_ctx"], rc))

        def gate2_blk(prefix: str, blk, lay: Dict[str, int], hit):
            """gate2 over an interleaved block's payload columns: the gate
            values ride in the SAME contiguous slice as the keys, so no
            second gather happens.  Padded/overshoot rows are neutralized
            through ``hit`` (their gate inputs are clamped first — they
            may hold -1 or a neighbouring bucket's payloads)."""
            hascav, hasexp = _view_flags[prefix]
            if not hascav and not hasexp:
                return hit, hit
            live = hit
            if hasexp:
                exp = torch.where(hit, blk[..., lay["exp"]], 0)
                live = hit & ((exp == 0) | (exp > now))
            if not hascav:
                return live, live
            cav = torch.where(hit, blk[..., lay["cav"]], 0)
            ctxc = torch.where(hit, blk[..., lay["ctx"]], -1)
            return tri_planes(live, cav, ctxc)

        me = comm.axis_index() if SH else None

        def por(x):
            """Boolean OR-reduce over the model axis (identity off a
            mesh)."""
            return comm.por(x) if SH else x

        def vbcast(own, x):
            """Single-owner int32 broadcast over the model axis: exactly
            one shard contributes (its bucket owns the key), so the psum
            of the masked values IS the value (identity off a mesh)."""
            return comm.psum(torch.where(own, x, 0)) if SH else x

        def sh_site(off_key: str, tbl_key: str, cap: int, q_cols, mode: str,
                    exp_lane, cav_lane, ctx_lane):
            """One probe of a bucket-sharded table on this shard: the
            global bucket's owner is its high bits, the local bucket its
            low bits (``bpd`` from the LOCAL offsets).  The ownership mask
            rides in the hit: a lane this shard does not own reads
            ``block`` as -1 rows, which no query key (>= 0) matches, and
            misses in every other mode.  The reduced modes (``any``,
            ``until2``) OR-reduce over the axis here; ``block`` and
            ``gate`` lanes are reduced by their site, which ORs after its
            own fold (the reference's ``por_m``)."""
            off = arrs[off_key]
            bpd = int(off.shape[0]) - 1
            h = bucket_of(q_cols, bpd * model_size)
            mine = torch.div(h, bpd, rounding_mode="floor") == me
            blk = sblock(tbl_key, tk(off, h & (bpd - 1)), cap)
            if mode == "block":
                return torch.where(mine[..., None, None], blk, -1)
            hit = _K.blk_hit(blk, torch.broadcast_tensors(*q_cols)) & (
                mine.unsqueeze(-1))
            if mode == "any":
                return por(hit.any(dim=-1))
            if mode == "until2":
                return (por((hit & (blk[..., 2] > now)).any(dim=-1)),
                        por((hit & (blk[..., 3] > now)).any(dim=-1)))
            live = hit
            if exp_lane is not None:
                exp = torch.where(hit, blk[..., exp_lane], 0)
                live = hit & ((exp == 0) | (exp > now))
            if cav_lane is None:
                return hit, live
            return (hit, live, torch.where(hit, blk[..., cav_lane], 0),
                    torch.where(hit, blk[..., ctx_lane], -1))

        def psite(off_key: str, tbl_key: str, cap: int, q_cols,
                  mode: str = "block", exp_lane: Optional[int] = None,
                  cav_lane: Optional[int] = None,
                  ctx_lane: Optional[int] = None):
            """THE seam between every bucket probe and the fused probe
            kernels (or their plain twins, by the engine's kernel
            switch): bucket-ALIGNED tables (listed in ``meta.aligned``)
            probe their width-stratum levels through
            ``fused_probe_aligned``, the rest their offsets + interleaved
            rows through ``fused_probe``.  A bucket-sharded table probes
            on its shard with plain gathers (``sh_site``)."""
            if SH:
                return sh_site(off_key, tbl_key, cap, q_cols, mode,
                               exp_lane, cav_lane, ctx_lane)
            al = ALD.get(tbl_key)
            if al is not None:
                w_, caps = al
                spec = PK.get(tbl_key)
                return _K.fused_probe_aligned(
                    q_cols, aligned_levels(arrs, tbl_key, caps), caps,
                    w_ if spec is None else spec[1], spec=spec,
                    spec_dev=specs.get(tbl_key), mode=mode, now=now,
                    exp_lane=exp_lane, cav_lane=cav_lane, ctx_lane=ctx_lane,
                    plain=not kernels,
                )
            A = PKO.get(off_key)
            return _K.fused_probe(
                q_cols, arrs[off_key], arrs[tbl_key], cap=cap,
                spec=PK.get(tbl_key), spec_dev=specs.get(tbl_key),
                off_a=arrs[off_key + "_a"] if A is not None else None,
                ashift=A, mode=mode, now=now, exp_lane=exp_lane,
                cav_lane=cav_lane, ctx_lane=ctx_lane, plain=not kernels,
            )

        def pblock(off_key: str, tbl_key: str, cap: int, q_cols):
            """Bucket probe → the decoded candidate block [..., cap, W]."""
            return psite(off_key, tbl_key, cap, q_cols, mode="block")

        def oblock(key: str, cap: int, q_cols):
            """A delta overlay's bucket block (``dl_{key}_off`` offsets,
            int32 ``dl_{key}x`` rows): the plain probe, as the reference
            probes its overlays."""
            return probe_block(arrs[f"dl_{key}_off"], arrs[f"dl_{key}x"],
                               cap, q_cols)

        def ohit(key: str, cap: int, q_cols):
            """Any exact-key hit in a delta overlay (tombstones, dirty
            voids)."""
            return _K.blk_hit(oblock(key, cap, q_cols), q_cols).any(dim=-1)

        def range_probe(off_key: str, tbl_key: str, cap: int, q,
                        rep: bool = False):
            """(lo, hi) row range of group key ``q``; (0, 0) on a miss.
            ``rep`` marks a delta overlay's group table (plain probe)."""
            if rep:
                blk = probe_block(arrs[off_key], arrs[tbl_key], cap, (q,))
            else:
                blk = pblock(off_key, tbl_key, cap, (q,))
            hit = _K.blk_hit(blk, (q,))
            lo = torch.where(hit, blk[..., 1], 0).amax(dim=-1)
            hi = torch.where(hit, blk[..., 2], 0).amax(dim=-1)
            return lo, hi

        def range_of(prefix: str, cap: int, q):
            if BS:
                return range_probe(
                    prefix + "_off", {"usr": "usgx", "arr": "argx"}[prefix],
                    cap, q,
                )
            ri = {
                k: arrs[prefix + "_" + k]
                for k in ("gk", "glo", "ghi", "off", "rows")
            }
            n = meta.usr_gn if prefix == "usr" else meta.arr_gn
            return probe_range(ri, cap, n, q)

        def cl_probe(srck, gk):
            """Closure containment per plane via until-value comparison.
            Keys are packed (src·S1+srel1, g·S1+grel+1); -1 never matches."""
            if not meta.has_closure:
                z = zeros(torch.broadcast_shapes(srck.shape, gk.shape))
                return z, z
            if BS:
                return psite("clh_off", "clx", meta.cl_cap, (srck, gk),
                             mode="until2")
            row = probe_rows(
                arrs["clh_off"], arrs["clh_rows"],
                (arrs["cl_k1"], arrs["cl_k2"]), (srck, gk),
                meta.cl_cap, meta.cl_n,
            )
            rc = row.clamp(0, arrs["cl_k1"].shape[0] - 1)
            hit = row >= 0
            return (
                hit & (tk(arrs["cl_d_until"], rc) > now),
                hit & (tk(arrs["cl_p_until"], rc) > now),
            )

        zB = zeros(q_res.shape)
        # packed per-query subject keys: -1 = "matches nothing"
        q_k2 = torch.where(
            (q_subj >= 0) & (q_srel1 >= 0), q_subj * S1c + q_srel1, -1
        )
        w_k2 = torch.where((q_wc >= 0) & (q_srel1 == 0), q_wc * S1c, -1)
        wcl_k = torch.where(q_wcc >= 0, q_wcc * S1c, -1)

        # fold subject side: the query subject's (and wildcard node's)
        # group-closure slices from the csr closure-by-source view,
        # computed ONCE per dispatch — [B, S] key/plane-liveness tiles
        _pf_subj_cell: List = []

        def pf_subj_slices():
            if _pf_subj_cell:
                return _pf_subj_cell[0]
            fanS = max(meta.pf_s_fan, 1)

            def csr_slice(k):
                ok = k >= 0
                if SH:
                    # the stacked rows table: the owner's rows broadcast
                    lo, hi = range_probe("csr_off", "csrgx", meta.pf_s_cap, k)
                    valid = (
                        (arange(fanS) < (hi - lo).unsqueeze(-1))
                        & ok.unsqueeze(-1)
                    )
                    blk = vbcast(valid.unsqueeze(-1), sblock("csrx", lo, fanS))
                    valid = por(valid)
                    gk = torch.where(valid, blk[..., 0], -1)
                    dok = valid & (torch.where(valid, blk[..., 1], 0) > now)
                    pok = valid & (torch.where(valid, blk[..., 2], 0) > now)
                    return gk, dok, pok
                if meta.pf_s_direct:
                    kc = torch.where(ok, k, 0)
                    lo = off_read("csr_start", kc)
                    hi = torch.where(ok, off_read("csr_start", kc + 1), lo)
                else:
                    # hash group table (the key space is over the direct
                    # budget, or a delta chain reshipped the closure):
                    # the rows stay the split csr_* columns
                    lo, hi = range_probe("csr_off", "csrgx", meta.pf_s_cap, k)
                valid = (arange(fanS) < (hi - lo).unsqueeze(-1)) & ok.unsqueeze(-1)
                gk = slice_blocks(arrs["csr_gk"], lo, fanS)[..., 0]
                gk = torch.where(valid, gk, -1)
                if meta.pf_s_alllive:
                    # None planes: containment alone grants both
                    return gk, None, None
                dv = slice_blocks(arrs["csr_d"], lo, fanS)[..., 0]
                pv = slice_blocks(arrs["csr_p"], lo, fanS)[..., 0]
                dok = valid & (torch.where(valid, dv, 0) > now)
                pok = valid & (torch.where(valid, pv, 0) > now)
                return gk, dok, pok

            slices = [csr_slice(q_k2)]
            if meta.has_wc_closure:
                slices.append(csr_slice(wcl_k))
            _pf_subj_cell.append(slices)
            return slices

        # fold-slot compact ids for the direct pfu_start lookup
        pf_fidx_t = (None if pf_fidx_np is None else device_const(
            ("pf_fidx", pf_fidx_np.tobytes()), dev,
            lambda d: torch.from_numpy(pf_fidx_np).to(d)))

        def pf_isect(gk, live):
            """(d, p) of the folded userset rows ``gk``/``live``
            ([..., fan], lattice-shaped) against the subject slices:
            a broadcast [fan × S] compare, reduced over both axes."""
            d = zeros(live.shape[:-1])
            p = zeros(live.shape[:-1])
            for (sgk, sdok, spok) in pf_subj_slices():
                shp = (sgk.shape[0],) + (1,) * (gk.dim() - 2) + (1, sgk.shape[1])
                m = live.unsqueeze(-1) & (gk.unsqueeze(-1) == sgk.reshape(shp))
                if sdok is None:  # all-live closure: one containment reduce
                    hit = any2(m)
                    d, p = d | hit, p | hit
                else:
                    d = d | any2(m & sdok.reshape(shp))
                    p = p | any2(m & spok.reshape(shp))
            return d, p

        def pf_probe(slot, nodes, coll=None):
            """Folded-permission test at a [B, ...] node lattice: ONE
            direct-identity probe (pf_e) + one bounded-fan userset slice
            (pf_u) intersected with the member closure.  ``slot=None`` =
            dynamic (q_perm is the slot).  ``coll`` (witness armed)
            collects the definite mask as the ``fold`` branch."""
            nd = nodes.dim()
            d = p = zeros(nodes.shape)
            exists = nodes >= 0
            sc = bq(q_perm_k1, nd) if slot is None else k1c(slot)
            k1 = sc * Nc + torch.where(exists, nodes, 0)
            if meta.pf_has_e:
                def pe_site(k2q):
                    blk = pblock("pfh_off", "pfx", meta.pf_e_cap, (k1, k2q))
                    hit = _K.blk_hit(
                        blk, torch.broadcast_tensors(k1, k2q)
                    ) & exists.unsqueeze(-1)
                    live = hit
                    if meta.pf_hasuntil:
                        u = torch.where(hit, blk[..., pfL["until"]], 0)
                        live = hit & (u > now)
                    if not meta.pf_hascav:
                        hd = hp = live
                    else:
                        cav = torch.where(live, blk[..., pfL["cav"]], 0)
                        ctxc = torch.where(live, blk[..., pfL["ctx"]], -1)
                        hd, hp = tri_planes(live, cav, ctxc)
                    return por(hd.any(dim=-1)), por(hp.any(dim=-1))

                ed, ep = pe_site(bq(q_k2, nd))
                d, p = d | ed, p | ep
                if meta.pf_haswc:
                    wd, wp = pe_site(bq(w_k2, nd))
                    d, p = d | wd, p | wp
            if meta.pf_has_u and SH:
                # the stacked rows table: the owner's rows broadcast
                fanU = max(meta.pf_u_fan, 1)
                lo, hi = range_probe("pfu_off", "pfugx", meta.pf_u_cap, k1)
                valid = (
                    (arange(fanU) < (hi - lo).unsqueeze(-1))
                    & exists.unsqueeze(-1)
                )
                ublk = vbcast(valid.unsqueeze(-1), sblock("pfux", lo, fanU))
                valid = por(valid)
                gk = torch.where(valid, ublk[..., 0], -1)
                live = valid & (torch.where(valid, ublk[..., 1], 0) > now)
                nd2 = nd + 1
                ud, up = pf_isect(gk, live)
                refl = (gk == bq(q_k2, nd2)) & (bq(q_k2, nd2) >= 0)
                r_hit = (live & refl).any(dim=-1)
                d = d | ud | r_hit
                p = p | up | r_hit
            elif meta.pf_has_u:
                fanU = max(meta.pf_u_fan, 1)
                if meta.pf_direct:
                    fc = (
                        tk(pf_fidx_t, bq(q_perm, nd).clamp(min=0))
                        if slot is None
                        else fold_slot_list.index(slot)
                    )
                    ok = exists & (fc >= 0) if slot is None else exists
                    base = torch.where(ok, fc * Nc + nodes, 0)
                    lo = off_read("pfu_start", base)
                    hi = torch.where(ok, off_read("pfu_start", base + 1), lo)
                else:
                    lo, hi = range_probe("pfu_off", "pfugx", meta.pf_u_cap, k1)
                valid = (
                    (arange(fanU) < (hi - lo).unsqueeze(-1))
                    & exists.unsqueeze(-1)
                )
                gk = slice_blocks(arrs["pfu_gk"], lo, fanU)[..., 0]
                gk = torch.where(valid, gk, -1)
                if meta.pf_u_alllive:
                    live = valid
                else:
                    uv = slice_blocks(arrs["pfu_u"], lo, fanU)[..., 0]
                    live = valid & (torch.where(valid, uv, 0) > now)
                nd2 = nd + 1
                ud, up = pf_isect(gk, live)
                refl = (gk == bq(q_k2, nd2)) & (bq(q_k2, nd2) >= 0)
                r_hit = (live & refl).any(dim=-1)
                d = d | ud | r_hit
                p = p | up | r_hit
            # incremental maintenance: void base hits at DIRTY resources,
            # then OR in the recomputed replacement rows
            if dm is not None and dm.pf_dirty:
                dirty = ohit("pfd", dm.pfd_cap, (k1,))
                d, p = d & ~dirty, p & ~dirty
            if dm is not None and dm.pf_ovl_e:
                oL = _lay(
                    ["k1", "k2"]
                    + (["cav", "ctx"] if dm.pf_ovl_hascav else [])
                    + (["until"] if dm.pf_ovl_hasuntil else [])
                )

                def po_site(k2q):
                    blk = oblock("pfe", dm.pfo_e_cap, (k1, k2q))
                    hit = _K.blk_hit(
                        blk, torch.broadcast_tensors(k1, k2q)
                    ) & exists.unsqueeze(-1)
                    live = hit
                    if dm.pf_ovl_hasuntil:
                        u = torch.where(hit, blk[..., oL["until"]], 0)
                        live = hit & (u > now)
                    if not dm.pf_ovl_hascav:
                        hd = hp = live
                    else:
                        cav = torch.where(live, blk[..., oL["cav"]], 0)
                        ctxc = torch.where(live, blk[..., oL["ctx"]], -1)
                        hd, hp = tri_planes(live, cav, ctxc)
                    return hd.any(dim=-1), hp.any(dim=-1)

                od, op_ = po_site(bq(q_k2, nd))
                d, p = d | od, p | op_
                if dm.pf_ovl_haswc:
                    owd, owp = po_site(bq(w_k2, nd))
                    d, p = d | owd, p | owp
            if dm is not None and dm.pf_ovl_u:
                # replacement folded-userset rows for dirty resources: the
                # overlay's range view, the same intersection
                fanO = max(dm.pfo_u_fan, 1)
                lo, hi = range_probe("dl_pfu_off", "dl_pfugx", dm.pfo_u_cap,
                                     k1, rep=True)
                valid = (
                    (arange(fanO) < (hi - lo).unsqueeze(-1))
                    & exists.unsqueeze(-1)
                )
                ublk = slice_blocks(arrs["dl_pfux"], lo, fanO)
                gk = torch.where(valid, ublk[..., 0], -1)
                live = valid & (torch.where(valid, ublk[..., 1], 0) > now)
                nd2 = nd + 1
                od, op_ = pf_isect(gk, live)
                refl = (gk == bq(q_k2, nd2)) & (bq(q_k2, nd2) >= 0)
                r_hit = (live & refl).any(dim=-1)
                d = d | od | r_hit
                p = p | op_ | r_hit
            if coll is not None:
                coll.add("fold", d)
            return d, p

        # Every eval function returns (definite, possible, ovf, used):
        # d/p shaped like the node lattice, ovf/used reduced to [B].

        def leaf(slot, nodes, coll=None):
            """Direct + wildcard + userset leaf tests at a [B, ...] node
            lattice.  ``slot`` None means dynamic — the query's own
            q_perm column is the relation, so ONE probe site at the root
            covers every slot's direct relation check.  ``coll`` (witness
            armed) collects each branch's definite mask, after the delta
            overlays are composed with it."""
            nd = nodes.dim()
            zn = zeros(nodes.shape)
            d, p, ovf, used = zn, zn, zB, zB
            exists = nodes >= 0
            dyn = slot is None
            sc = bq(q_perm_k1, nd) if dyn else k1c(slot)
            # packed (slot, node) key; invalid nodes use 0 and are masked
            # by `exists` wherever the (possibly aliased) probe lands
            k1 = sc * Nc + torch.where(exists, nodes, 0)

            run_e = dyn_e if dyn else (slot in meta.e_slots)
            run_ed = dm is not None and dm.has_adds and (
                bool(dm.e_slots) if dyn else (slot in dm.e_slots)
            )
            if run_e and BS or run_ed:
                def e_site(k2q):
                    """Direct-edge test: (base hit minus tombstones) OR
                    delta-level hit — exact replacement semantics, since
                    tombstones carry full primary identities.  The base
                    probe fuses the expiry gate and returns the caveat-id
                    and context planes of a caveated table for the tri
                    VM."""
                    hd = hp = zeros(nodes.shape)
                    if run_e:
                        pg = psite(
                            "eh_off", "ehx", meta.e_cap, (k1, k2q),
                            mode="gate",
                            exp_lane=eL["exp"] if meta.e_hasexp else None,
                            cav_lane=eL["cav"] if meta.e_hascav else None,
                            ctx_lane=eL["ctx"] if meta.e_hascav else None,
                        )
                        # exists is lane-constant: ANDing it after the
                        # kernel's hit/live masks commutes (dead lanes'
                        # cav/ctx feed tri but live kills them), so parity
                        # with gate2_blk is exact
                        live = pg[1] & exists.unsqueeze(-1)
                        if not meta.e_hascav:
                            bd = bp = live
                        else:
                            bd, bp = tri_planes(live, pg[2], pg[3])
                        hd, hp = por(bd.any(dim=-1)), por(bp.any(dim=-1))
                        if dm is not None and dm.has_tombs:
                            tomb = ohit("tb", dm.tb_cap, (k1, k2q))
                            hd, hp = hd & ~tomb, hp & ~tomb
                    if run_ed:
                        dblk = oblock("eh", dm.e_cap, (k1, k2q))
                        dhit = _K.blk_hit(
                            dblk, torch.broadcast_tensors(k1, k2q)
                        ) & exists.unsqueeze(-1)
                        dd, dp = gate2_blk("e", dblk, eL, dhit)
                        hd = hd | dd.any(dim=-1)
                        hp = hp | dp.any(dim=-1)
                    return hd, hp

                d, p = e_site(bq(q_k2, nd))
                if coll is not None:
                    coll.add("direct", d)
                if meta.has_wc_edges:
                    # wildcard edges only grant direct-object subjects
                    wd, wp = e_site(bq(w_k2, nd))
                    if coll is not None:
                        coll.add("wildcard", wd)
                    d, p = d | wd, p | wp
            elif run_e:
                # scattered layout (no delta level exists there)
                ecols = (arrs["e_k1"], arrs["e_k2"])
                row = probe_rows(
                    arrs["eh_off"], arrs["eh_rows"], ecols,
                    (k1, bq(q_k2, nd)), meta.e_cap, meta.e_n,
                )
                d, p = gate2("e", row, (row >= 0) & exists)
                if coll is not None:
                    coll.add("direct", d)
                if meta.has_wc_edges:
                    wrow = probe_rows(
                        arrs["eh_off"], arrs["eh_rows"], ecols,
                        (k1, bq(w_k2, nd)), meta.e_cap, meta.e_n,
                    )
                    wd, wp = gate2("e", wrow, (wrow >= 0) & exists)
                    if coll is not None:
                        coll.add("wildcard", wd)
                    d, p = d | wd, p | wp

            # T-index fast path: one probe folds {userset edge × closure}
            use_t = dyn_t if dyn else (t_on and slot in meta.t_slots)
            if use_t:
                def t_site(k2q):
                    if BS:
                        td_, tp_ = psite("th_off", "tx", meta.t_cap,
                                         (k1, k2q), mode="until2")
                        # exists is lane-constant, so ANDing it after the
                        # in-probe OR-reduce is exact
                        return td_ & exists, tp_ & exists
                    trow = probe_rows(
                        arrs["th_off"], arrs["th_rows"],
                        (arrs["t_k1"], arrs["t_k2"]), (k1, k2q),
                        meta.t_cap, meta.t_n,
                    )
                    trc = trow.clamp(0, arrs["t_k1"].shape[0] - 1)
                    thit = (trow >= 0) & exists
                    return (
                        thit & (tk(arrs["t_d"], trc) > now),
                        thit & (tk(arrs["t_p"], trc) > now),
                    )

                td, tp = t_site(bq(q_k2, nd))
                if meta.has_wc_closure:
                    wtd, wtp = t_site(bq(wcl_k, nd))
                    td, tp = td | wtd, tp | wtp
                if dm is not None and dm.t_dirty:
                    # groups with tombstoned userset rows or a changed
                    # closure: the base T rows may cite dead edges — void
                    # them; the forced KU pass below re-derives the union
                    dirty = ohit("td", dm.td_cap, (k1,))
                    td, tp = td & ~dirty, tp & ~dirty
                if coll is not None:
                    coll.add("t", td)
                d, p = d | td, p | tp
                if meta.has_ovf:
                    # T is incomplete for overflowed closure sources: flag
                    # queries whose (slot, node) has userset rows at all
                    lo2, hi2 = range_of("usr", meta.usr_cap, k1)
                    used = used | por(reduceB(exists & (hi2 > lo2)))

            def ku_fetch(delta: bool, cap: int, fan: int):
                """Range-probe a userset view (the base's, or the delta
                level's overlay) and fetch its candidate block: (block,
                valid lanes, overflow)."""
                if delta:
                    lo, hi = range_probe("dl_usr_off", "dl_usgx", cap, k1,
                                         rep=True)
                else:
                    lo, hi = range_of("usr", cap, k1)
                over = reduceB(exists & ((hi - lo) > fan))
                valid = (
                    (arange(fan) < (hi - lo).unsqueeze(-1))
                    & exists.unsqueeze(-1)
                )
                if delta:
                    return slice_blocks(arrs["dl_usx"], lo, fan), valid, over
                ublk = sblock("usx", lo, fan)
                if SH:
                    # the owning shard's rows broadcast; every shard then
                    # tests them against ITS closure / pus buckets
                    over = por(over)
                    ublk = vbcast(valid.unsqueeze(-1), ublk)
                    valid = por(valid)
                return ublk, valid, over

            def ku_eval(ublk, valid, tombstoned: bool = False):
                """Userset-grant evaluation over one candidate block:
                per-candidate closure/reflexivity/permission tests gated
                by the row's expiry column.  ``tombstoned`` masks deleted
                base rows by their exact (group, subject) identity."""
                s = torch.where(valid, ublk[..., usL["subj"]], -1)
                r = torch.where(valid, ublk[..., usL["srel"]], -1)
                gk = s * S1c + (r + 1)  # invalid rows (-1, -1) → negative
                if tombstoned:
                    tomb = ohit("utb", dm.utb_cap, (k1.unsqueeze(-1), gk))
                    valid = valid & ~tomb
                    gk = torch.where(valid, gk, -1)
                nd2 = nd + 1
                in_d, in_p = cl_probe(bq(q_k2, nd2), gk)
                if meta.has_wc_closure:
                    win_d, win_p = cl_probe(bq(wcl_k, nd2), gk)
                    in_d, in_p = in_d | win_d, in_p | win_p
                refl = (gk == bq(q_k2, nd2)) & (bq(q_k2, nd2) >= 0)
                if plan.has_permission_usersets:
                    permf = (
                        (torch.where(valid, ublk[..., usL["perm"]], 0) != 0)
                        if meta.us_hasperm
                        else zeros(valid.shape)
                    )
                    in_pus = psite("push_off", "pusx", meta.pus_cap, (gk,),
                                   mode="any")
                    in_d = (in_d | refl) & ~permf
                    in_p = in_p | refl | in_pus | permf
                else:
                    in_d = in_d | refl
                    in_p = in_p | refl
                ugd, ugp = gate2_blk("us", ublk, usL, valid)
                return (
                    (ugd & in_d).any(dim=-1),
                    (ugp & in_p).any(dim=-1),
                    reduceB(valid),
                )

            # KU probe path: ineligible slots; the dynamic root leaf on a
            # mixed schema (eligible slots repeat the T answer, sound
            # under OR); or a delta level with T-dirty groups (the forced
            # pass replaces the voided T answers)
            run_ku = (
                (not use_t)
                or (dyn and not t_cover)
                or (dm is not None and dm.t_dirty)
            )
            KU_site = min(KU, dyn_us_fan if dyn else us_fans.get(slot, 0))
            if run_ku and KU_site > 0 and BS:
                ublk, valid, over = ku_fetch(False, meta.usr_cap, KU_site)
                ovf = ovf | over
                kd, kp, ku_used = ku_eval(
                    ublk, valid,
                    tombstoned=dm is not None and dm.has_ustomb,
                )
                if coll is not None:
                    coll.add("us", kd)
                d, p, used = d | kd, p | kp, used | ku_used
            elif run_ku and KU_site > 0:
                # scattered layout: the candidates are raw userset rows
                lo, hi = range_of("usr", meta.usr_cap, k1)
                ovf = ovf | reduceB(exists & ((hi - lo) > KU_site))
                valid = (
                    (arange(KU_site) < (hi - lo).unsqueeze(-1))
                    & exists.unsqueeze(-1)
                )
                used = used | reduceB(valid)
                idx = lo.unsqueeze(-1) + arange(KU_site)
                idxc = idx.clamp(0, max(meta.us_rows - 1, 0))
                s = tk(arrs["us_subj"], idxc)
                r = tk(arrs["us_srel_d"], idxc)
                gk = s * S1c + (r + 1)  # invalid rows (-1, -1) → negative
                nd2 = nd + 1
                in_d, in_p = cl_probe(bq(q_k2, nd2), gk)
                if meta.has_wc_closure:
                    win_d, win_p = cl_probe(bq(wcl_k, nd2), gk)
                    in_d, in_p = in_d | win_d, in_p | win_p
                refl = (gk == bq(q_k2, nd2)) & (bq(q_k2, nd2) >= 0)
                if plan.has_permission_usersets:
                    permf = tk(arrs["us_perm"], idxc) != 0
                    in_pus = probe_rows(
                        arrs["push_off"], arrs["push_rows"],
                        (arrs["pus_k"],), (gk,),
                        meta.pus_cap, meta.pus_n,
                    ) >= 0
                    in_d = (in_d | refl) & ~permf
                    in_p = in_p | refl | in_pus | permf
                else:
                    in_d = in_d | refl
                    in_p = in_p | refl
                ugd, ugp = gate2("us", idxc, valid)
                kd = (ugd & in_d).any(dim=-1)
                if coll is not None:
                    coll.add("us", kd)
                d = d | kd
                p = p | (ugp & in_p).any(dim=-1)
            # delta-level userset grants (adds with subject relations)
            run_kud = (
                dm is not None
                and dm.has_us
                and (bool(dm.us_slots) if dyn else (slot in dm.us_slots))
            )
            if run_kud:
                ublk, valid, over = ku_fetch(True, dm.us_cap, dm.us_fan)
                ovf = ovf | over
                kd, kp, ku_used = ku_eval(ublk, valid)
                if coll is not None:
                    coll.add("us", kd)
                d, p, used = d | kd, p | kp, used | ku_used
            return d, p, ovf, used

        memo: Dict = {}
        pins: List = []  # keep node arrays alive so id() keys stay unique

        def eval_progs(slot: int, nodes, stack: Tuple, types, ar_hops: int,
                       coll=None):
            """The permission programs of ``slot`` at ``nodes`` (no leaf).
            ``coll`` (witness armed) threads into each program's
            expression gated by that program's node-type mask, so a leaf
            mask from another type's program never claims a branch for a
            query it cannot grant."""
            zn = zeros(nodes.shape)
            d, p, ovf, used = zn, zn, zB, zB
            progs = [
                (tname, tid, expr)
                for (tname, tid, expr) in perm_programs.get(slot, ())
                if tname in types and (tname, slot) not in folded_pairs
            ]
            if progs:
                ntype = torch.where(
                    nodes >= 0,
                    tk(node_type, nodes.clamp(0, node_type.shape[0] - 1)).to(
                        torch.int32
                    ),
                    -1,
                )
            width = 1
            for dim in nodes.shape[1:]:
                width *= int(dim)
            for (tname, tid, expr) in progs:
                mask = ntype == tid_map[tid]
                rc = rc_map.get((tname, slot))
                if rc is not None and width * (
                    rc_geom[rc[0]][1] + 1
                ) <= cfg.flat_max_width:
                    # flattened hierarchy: ONE level over the ancestor
                    # closure instead of recursive unrolling
                    ed, ep, eo, eu = rc_eval(
                        rc[0], rc[1], nodes, stack + ((tname, slot),),
                        frozenset((tname,)), ar_hops,
                    )
                    d = d | (mask & ed)
                    p = p | (mask & ep)
                    ovf, used = ovf | eo, used | eu
                    continue
                if (tname, slot) in cyclic and stack.count(
                    (tname, slot)
                ) >= cfg.flat_recursion:
                    # recursion budget exhausted: deeper evaluation is
                    # unknown → possible-only, the host oracle finishes it
                    p = p | (mask & (nodes >= 0))
                    continue
                ed, ep, eo, eu = eval_expr(
                    expr, nodes, stack + ((tname, slot),),
                    frozenset((tname,)), ar_hops,
                    None if coll is None else coll.masked(mask),
                )
                d = d | (mask & ed)
                p = p | (mask & ep)
                ovf, used = ovf | eo, used | eu
            return d, p, ovf, used

        def rc_eval(ts_slot: int, rest: ExprIR, nodes, stack, types,
                    ar_hops: int):
            """perm(n) = ∃ a ∈ {n} ∪ ancestors(n): rest(a), with the
            ancestor paths' two-plane admissibility from the flattened
            arrow closure (rc{ts} tables)."""
            cap, fan = rc_geom[ts_slot]
            exists = nodes >= 0
            nq = torch.where(exists, nodes, -1)
            lo, hi = range_probe(f"rc{ts_slot}_off", f"rc{ts_slot}gx", cap, nq)
            valid = (arange(fan) < (hi - lo).unsqueeze(-1)) & exists.unsqueeze(-1)
            blk = sblock(f"rc{ts_slot}x", lo, fan)
            if SH:
                blk = vbcast(valid.unsqueeze(-1), blk)
                valid = por(valid)
            anc = torch.where(valid, blk[..., 0], -1)
            path_d = valid & (blk[..., 1] > now)
            path_p = valid & (blk[..., 2] > now)
            # reflexive lane 0: the node itself, path trivially live
            lattice = torch.cat([nodes.unsqueeze(-1), anc], dim=-1)
            path_d = torch.cat([exists.unsqueeze(-1), path_d], dim=-1)
            path_p = torch.cat([exists.unsqueeze(-1), path_p], dim=-1)
            rd, rp, ro, ru = eval_expr(rest, lattice, stack, types, ar_hops)
            return (
                (rd & path_d).any(dim=-1),
                (rp & path_p).any(dim=-1),
                ro, ru,
            )

        def eval_slot(slot: int, nodes, stack: Tuple, types, ar_hops: int,
                      coll=None):
            cyc_sig = tuple(
                sorted((pr, stack.count(pr)) for pr in set(stack) if pr in cyclic)
            )
            key = (
                slot, id(nodes), types, cyc_sig,
                ar_hops if ar_bound >= 0 else 0,
            )
            got = memo.get(key)
            if got is not None:
                return got
            zn = zeros(nodes.shape)
            d, p, ovf, used = zn, zn, zB, zB
            if slot in rel_slots:
                d, p, ovf, used = leaf(slot, nodes, coll)
            if slot in pf_slots:
                # folded permission reached as an arrow target / ref from
                # an unfolded program: its base answer is the probe pair
                fd, fp = pf_probe(slot, nodes, coll)
                d, p = d | fd, p | fp
            pd, pp, po, pu = eval_progs(slot, nodes, stack, types, ar_hops,
                                        coll)
            d, p = d | pd, p | pp
            ovf, used = ovf | po, used | pu
            pins.append(nodes)
            memo[key] = (d, p, ovf, used)
            return memo[key]

        def eval_expr(ir: ExprIR, nodes, stack: Tuple, types, ar_hops: int,
                      coll=None):
            tag = ir[0]
            if tag == "ref":
                return eval_slot(ir[1], nodes, stack, types, ar_hops, coll)
            if tag == "nil":
                z = zeros(nodes.shape)
                return z, z, zB, zB
            if tag == "arrow":
                if 0 <= ar_bound <= ar_hops:
                    # deeper than any real chain in the data: no children
                    z = zeros(nodes.shape)
                    return z, z, zB, zB
                ts_slot = plan.ts_slots[ir[1]]
                child_types = arrow_child_types(ts_slot, types)
                data_fan = dict(meta.ar_fanout_by_slot).get(ts_slot, 0)
                d_run = dm is not None and dm.has_ar and ts_slot in dm.ar_slots
                Ksd = dm.ar_fan if d_run else 0
                if not child_types or (data_fan == 0 and Ksd == 0):
                    # no reachable types / no edges of this tupleset at all
                    z = zeros(nodes.shape)
                    return z, z, zB, zB
                Ks = min(K, data_fan)
                exists = nodes >= 0
                ak = k1c(ts_slot) * Nc + torch.where(exists, nodes, 0)
                zi = torch.zeros(nodes.shape, dtype=torch.int32, device=dev)
                if Ks:
                    lo, hi = range_of("arr", meta.arr_cap, ak)
                else:
                    lo = hi = zi
                if Ksd:
                    lod, hid = range_probe("dl_arr_off", "dl_argx", dm.ar_cap,
                                           ak, rep=True)
                else:
                    lod = hid = zi
                width = 1
                for dim in nodes.shape[1:]:
                    width *= int(dim)
                if width * (Ks + Ksd) > cfg.flat_max_width:
                    # lattice budget spent: probe child existence only;
                    # real deeper grants surface as possible
                    return (zeros(nodes.shape),
                            por((hi > lo) | (hid > lod)) & exists, zB, zB)
                ovf = por(reduceB(exists & ((hi - lo) > Ks)))
                if Ks == 0:
                    children = torch.full(nodes.shape + (0,), -1,
                                          dtype=torch.int32, device=dev)
                    gd = gp = zeros(nodes.shape + (0,))
                else:
                    valid = (
                        (arange(Ks) < (hi - lo).unsqueeze(-1))
                        & exists.unsqueeze(-1)
                    )
                    if BS:
                        ablk = sblock("arx", lo, Ks)
                        if SH:
                            # the owning shard's rows broadcast; every
                            # shard then recurses on the SAME children
                            ablk = vbcast(valid.unsqueeze(-1), ablk)
                            valid = por(valid)
                        children = torch.where(valid, ablk[..., arL["child"]],
                                               -1)
                        gd, gp = gate2_blk("ar", ablk, arL, valid)
                    else:
                        # scattered layout: the candidates are raw arrow rows
                        idx = lo.unsqueeze(-1) + arange(Ks)
                        idxc = idx.clamp(0, max(meta.ar_rows - 1, 0))
                        children = torch.where(
                            valid, tk(arrs["ar_child"], idxc), -1)
                        gd, gp = gate2("ar", idxc, valid)
                    if dm is not None and dm.has_artomb:
                        # mask deleted base rows by (group, child) identity
                        tomb = ohit("atb", dm.atb_cap,
                                    (ak.unsqueeze(-1), children))
                        children = torch.where(tomb, -1, children)
                        gd, gp = gd & ~tomb, gp & ~tomb
                if Ksd:
                    # delta-level arrow rows: extra candidates on the axis
                    ovf = ovf | reduceB(exists & ((hid - lod) > Ksd))
                    dvalid = (
                        (arange(Ksd) < (hid - lod).unsqueeze(-1))
                        & exists.unsqueeze(-1)
                    )
                    dblk = slice_blocks(arrs["dl_arx"], lod, Ksd)
                    dchildren = torch.where(dvalid, dblk[..., arL["child"]], -1)
                    dgd, dgp = gate2_blk("ar", dblk, arL, dvalid)
                    children = torch.cat([children, dchildren], dim=-1)
                    gd = torch.cat([gd, dgd], dim=-1)
                    gp = torch.cat([gp, dgp], dim=-1)
                cd, cp, co, cu = eval_slot(
                    ir[2], children, stack, child_types, ar_hops + 1
                )
                return (
                    (cd & gd).any(dim=-1),
                    (cp & gp).any(dim=-1),
                    ovf | co,
                    cu,
                )
            if tag == "union":
                z = zeros(nodes.shape)
                d, p, ovf, used = z, z, zB, zB
                for c in ir[1]:
                    cd, cp, co, cu = eval_expr(c, nodes, stack, types,
                                               ar_hops, coll)
                    d, p = d | cd, p | cp
                    ovf, used = ovf | co, used | cu
                return d, p, ovf, used
            if tag == "inter":
                # children collect into a sub-store gated by the whole
                # intersection's definite output: a branch hit inside a
                # failed intersection is not on the allowed path
                o = torch.ones(nodes.shape, dtype=torch.bool, device=dev)
                d, p, ovf, used = o, o, zB, zB
                sub = None if coll is None else _WitColl({})
                for c in ir[1]:
                    cd, cp, co, cu = eval_expr(c, nodes, stack, types,
                                               ar_hops, sub)
                    d, p = d & cd, p & cp
                    ovf, used = ovf | co, used | cu
                if sub is not None:
                    for wk, wm in sub.store.items():
                        coll.add(wk, wm & d)
                return d, p, ovf, used
            if tag == "excl":
                # the subtracted operand's grants deny (never collected);
                # the base operand's count only where the exclusion as a
                # whole definitely grants
                sub = None if coll is None else _WitColl({})
                bd, bp, bo, bu = eval_expr(ir[1], nodes, stack, types,
                                           ar_hops, sub)
                sd, sp, so, su = eval_expr(ir[2], nodes, stack, types, ar_hops)
                rd = bd & ~sp
                if sub is not None:
                    for wk, wm in sub.store.items():
                        coll.add(wk, wm & rd)
                return rd, bp & ~sd, bo | so, bu | su
            raise TypeError(f"bad expression IR {ir!r}")

        # subject-closure overflow: the flattened table is incomplete for
        # these sources, so any query that touched a userset probe falls
        # back to the host oracle
        if not meta.has_ovf:
            q_cl_ovf = zB
        else:
            def ovf_probe(k):
                if BS:
                    return psite("ovfh_off", "ovfx", meta.ovf_cap, (k,),
                                 mode="any")
                return probe_rows(
                    arrs["ovfh_off"], arrs["ovfh_rows"],
                    (arrs["ovf_k"],), (k,), meta.ovf_cap, meta.ovf_n,
                ) >= 0

            q_cl_ovf = ovf_probe(q_k2) | ovf_probe(wcl_k)

        valid_q = (q_res >= 0) & (q_perm >= 0)
        # witness collection (armed only): the root-level sites and the
        # root resource's program expressions drop their definite masks
        # in here; None skips every collection
        coll = _WitColl({}) if witness else None
        # one dynamic-slot leaf site answers every query whose permission
        # is (also) a stored relation; per-slot work below is programs only
        if meta.e_slots or meta.us_fanout_by_slot:
            d_out, p_out, lovf, lused = leaf(None, q_res, coll)
            ovf_out = lovf | (q_cl_ovf & lused)
        else:
            d_out, p_out, ovf_out = zB, zB, zB
        if fold_on and any(s in pf_slots for s in slots):
            # one dynamic pf site answers every folded permission in the
            # dispatch — for a fully folded slot set this IS the kernel
            fd, fp = pf_probe(None, q_res, coll)
            d_out, p_out = d_out | fd, p_out | fp
        for slot in slots:
            if not perm_programs.get(slot):
                continue
            sel = q_perm == slot
            sd, sp, so, su = eval_progs(
                int(slot), q_res, (), all_types, 0,
                None if coll is None else coll.masked(sel),
            )
            d_out = d_out | (sel & sd)
            p_out = p_out | (sel & sp)
            ovf_out = ovf_out | (sel & (so | (q_cl_ovf & su)))
            if coll is not None:
                coll.add("rewrite", sel & sd)

        d_out = (d_out & valid_q) | q_self
        p_out = (p_out & valid_q) | q_self
        if coll is None:
            return d_out, p_out, ovf_out & ~q_self
        # the witness plane: lowest-priority branch first, each later
        # select overwrites, so the leaf-most explanation wins (self >
        # direct > wildcard > T > fold > userset > rewrite); nonzero only
        # for definite allowed verdicts
        wit = torch.zeros(q_res.shape, dtype=torch.int32, device=dev)
        for wkey, wcode in (
            ("rewrite", WIT_REWRITE | (1 << WIT_LEVEL_SHIFT)),
            ("us", WIT_USERSET),
            ("fold", WIT_FOLD),
            ("t", WIT_TPROBE),
            ("wildcard", WIT_WILDCARD),
            ("direct", WIT_DIRECT),
        ):
            wm = coll.store.get(wkey)
            if wm is not None:
                wit = wit.masked_fill(wm & valid_q, wcode)
        wit = wit.masked_fill(q_self, WIT_SELF).masked_fill(~d_out, 0)
        return d_out, p_out, ovf_out & ~q_self, wit

    return fn
