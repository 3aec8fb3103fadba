"""Static device-program structure compiled from a schema.

``build_plan`` turns a CompiledSchema into the *static* structure the
engine's program builder closes over: tupleset slot numbering, the relation slots
that need leaf tests, permission expressions lowered to nested tuples, a
global topological update order, and schema-derived iteration bounds.  None
of this touches tuple data — it is fixed at WriteSchema time.

``EngineConfig`` holds the static capacity caps; queries beyond a cap are
flagged and re-checked on the host oracle.  ``EngineConfig.for_schema``
derives the legacy program's hop caps from the schema's depth analysis:
non-recursive schemas get provably sufficient caps, recursive ones keep
the configurable defaults with overflow detection.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from ..schema.ast import (
    Arrow,
    Exclusion,
    Expr,
    Intersection,
    Nil,
    RelationRef,
    Union,
)
from ..schema.compiler import CompiledSchema, _expr_refs
from .hash import ALIGNED_COVER, ALIGNED_MAX_BYTES

# Expression IR: nested tuples, all leaves static ints.
#   ("ref", slot) ("arrow", ts_idx, right_slot) ("union", (c...))
#   ("inter", (c...)) ("excl", base, sub) ("nil",)
ExprIR = tuple


@dataclass(frozen=True)
class EngineConfig:
    """Static capacity caps of the flat check engine.  Every cap has an
    overflow flag on device; overflowing queries are re-checked on the host
    oracle, so caps trade device coverage for speed, never correctness.
    The defaults equal the reference package's, so both build identical
    tables from the same snapshot."""

    # -- the legacy two-phase program (engine/legacy.py) ----------------
    closure_size: int = 256  # max usersets a subject transitively belongs to
    seed_cap: int = 64  # max direct group memberships gathered per subject
    prop_cap: int = 8  # max parents per userset per closure hop
    closure_hops: int = 8  # userset-nesting depth walked on device
    subgraph_nodes: int = 8  # max arrow-reachable nodes per resource
    eval_iters: int = 2  # fixpoint iterations over the rewrite system
    #: checks use the flat program; False serves every batch on the
    #: legacy two-phase program (so does a batch with more distinct
    #: permissions than flat_max_slots, or a graph whose keys do not pack)
    use_flat: bool = True
    arrow_fanout: int = 4  # max tuples walked per (node, tupleset relation)
    us_leaf_cap: int = 8  # max userset grants tested per (node, relation)
    batch_bucket_min: int = 8  # pad batch counts to pow2 ≥ this
    flat_recursion: int = 8  # inline budget per recursive (type, slot) pair
    flat_max_slots: int = 8  # max distinct permissions per flat dispatch
    closure_source_cap: int = 4096  # max flattened pairs per closure source
    #: max product of arrow-child dims per query in the unrolled lattice;
    #: beyond it an arrow probes child-existence only (possible → host)
    flat_max_width: int = 256
    #: materialize the userset-grant join index (engine/flat.py T-index):
    #: us-edges ⋈ closure, so a userset grant test is ONE hash probe
    flat_tindex: bool = True
    #: T-index size budget as a multiple of the userset row count;
    #: exceeding it disables the index (KU probe path still answers)
    flat_tindex_factor: int = 64
    #: block-slice table layout: bucket-ordered interleaved tables probed
    #: with ONE contiguous [cap, w] slice per query.  The only layout the
    #: port serves; False (the scattered probe_rows path) raises
    flat_blockslice: bool = True
    #: flatten self-recursive arrow hierarchies into precomputed ancestor
    #: closures: a depth-D folder tree evaluates in ONE level
    flat_rc_index: bool = True
    #: fold whole union/arrow-chain permission rewrites into root-level
    #: probe tables (engine/fold.py P-index)
    flat_fold: bool = True
    #: folded row budget as a multiple of (E + US) row counts
    flat_fold_factor: int = 16
    #: max userset-group fan per folded (slot, resource)
    flat_fold_u_fan_cap: int = 64
    #: max closure rows per SOURCE in the fold's subject-side slice
    flat_fold_subj_fan_cap: int = 64
    #: per-array entry budget for the fold's DIRECT offset arrays
    flat_pf_direct_max_entries: int = 1 << 25
    #: bit-packed device tables (engine/packed.py).  None = auto (on with
    #: the blockslice layout); False keeps full-width int32 columns
    flat_packed: Optional[bool] = None
    #: bucket-count growth bound for the packed layout's hash builds
    flat_packed_max_factor: int = 2
    #: partition-first sharded builds (engine/partition.py): keys hash to
    #: their bucket shard first, then each model shard's slice of the
    #: stacked tables builds on its own — the same bits as the
    #: build-full-then-stack path (False), with O(E/M) scratch a shard
    flat_partition_build: bool = True
    #: row chunk of the partitioned build's primary-key hash pass: the
    #: dense (k1, k2) packs are made a chunk at a time, never as one
    #: O(E) column
    flat_partition_chunk: int = 1 << 22
    #: bucket-ALIGNED probe tables (engine/hash.py build_aligned): each
    #: bucket is ONE table row, a probe one row read per width-stratum
    #: level with no dependent offset read.  Off by default in the port.
    #: (The reference turns it on by default on a TPU backend; its "~48M
    #: vs 0.75M probes/s" figure is a TPU's, measured by
    #: tpu_attempts/micro_blocks.py, not this card's.)
    flat_aligned: bool = False
    #: per-table byte budget of the aligned layout: a table whose aligned
    #: form exceeds it keeps the off+interleave layout
    flat_aligned_max_bytes: int = ALIGNED_MAX_BYTES
    #: width-stratification ladder of the aligned layout (engine/hash.py
    #: build_aligned ``cover``): level i's row width is the smallest cap
    #: covering this share of its entries, overflow cascades to the next
    #: (salted) level, and a fit-all level closes the ladder.  The
    #: 1-entry default is the classic primary+spill pair
    flat_aligned_cover: Tuple[float, ...] = ALIGNED_COVER
    #: the fused probe kernel switch: None = the CUDA kernel on a ``cuda``
    #: device and the plain PyTorch version on ``cpu``; True = the kernel,
    #: raising if it cannot build or launch; False = the plain version on
    #: any device (the parity harness).  Never a silent fallback
    kernels: Optional[bool] = None
    #: build the reverse-CSR lookup index alongside the forward tables
    #: (engine/rev.py: rvx/rax/fwx + offsets): LookupResources/
    #: LookupSubjects then run on the device (engine/spmv.py: the fused
    #: K-hop program of engine/spmm.py when ``spmm`` is on, else the
    #: looped per-hop frontier) instead of the host walker
    flat_rev_index: bool = True
    #: per-dispatch row budget of the looped frontier's emission: each
    #: hop emits matches in chunks of at most this many rows
    lookup_chunk: int = 65_536
    #: frontier-key padding floor of the looped path, pow2 tiers above it
    lookup_frontier_min: int = 1_024
    # -- the fused K-hop lookup program (engine/spmm.py) ----------------
    #: serve multi-hop lookups through the fused K-hop program (the whole
    #: reverse/forward frontier fixpoint in one dispatch, one CUDA-graph
    #: replay on ``cuda``, the frontier carried on the device between
    #: hops) and route the fold T-join through the same semiring product.
    #: False is the parity lever: the looped per-hop spmv path and the
    #: bespoke t_join_core, byte for byte
    spmm: bool = True
    #: hop rounds per fused dispatch; a frontier still live after this
    #: many rounds overflows to the looped path
    spmm_rounds: int = 10
    #: on-device frontier capacity per round (keys and nodes, pow2);
    #: wider frontiers overflow to the looped path
    spmm_frontier: int = 1_024
    #: per-round emission budget of each fused probe (pow2): the emit
    #: lanes run at full width every round, so this is the program's
    #: dominant cost; overflow falls back to the looped path
    spmm_emit: int = 2_048
    #: candidate-buffer capacity of one fused dispatch; larger answers
    #: overflow to the looped (streaming) path
    spmm_candidates: int = 8_192
    # -- the Watch-driven delta chain (engine/flat.py build_delta_arrays) -
    #: accumulated delta-level rows (adds + tombstones) beyond
    #: max(this, E/8) trigger compaction: the next prepare rebuilds the
    #: base instead of growing the overlay
    flat_delta_min_compact: int = 65_536
    #: host-side mirror of the same bound: overlay rows beyond
    #: max(this, E/8) make store/delta.py materialize the LSM chain into
    #: a fresh base instead of deferring the merge.  Lower keeps probe
    #: depth small at the price of more frequent O(E) merges; the
    #: background chain compactor (store/group.py) works against half
    #: this trip so the merge lands off the write path.  The client
    #: threads it to ``Store.lsm_compact_min``
    lsm_compact_min: int = 65_536
    #: dl_* table shape floor: delta tables pre-size to this many rows so
    #: consecutive revisions keep one table geometry (one FlatMeta, one
    #: cached flat program) instead of stepping at every pow2 row-count
    #: boundary; beyond the floor, shapes step in 4x bands
    flat_delta_floor: int = 16_384
    #: incremental fold maintenance (engine/fold.py fold_delta_update):
    #: max total dirty resources per delta chain.  Past it the chain
    #: DOWNGRADES folded pairs to their walked programs (sticky pf_off
    #: until compaction re-folds the base)
    flat_fold_delta_dirty_cap: int = 16_384
    #: advance the flattened membership closure in place on membership-
    #: subgraph deltas (store/closure.py advance_closure) instead of
    #: bailing to a full prepare — the O(delta * depth) write path
    closure_delta: bool = True
    #: max affected closure sources per advance; a delta whose reverse
    #: reachability fans past this rebuilds instead
    closure_delta_affected_cap: int = 65_536
    #: max accumulated T-index-dirty resource keys per delta chain; past
    #: it the chain flips the T-index OFF (sticky, like pf_off) and the
    #: KU path, which probes the live closure, answers those slots
    flat_tindex_dirty_cap: int = 65_536
    #: prewarm the transposed lookup index in a background thread at
    #: prepare time (worlds of at least LOOKUP_PREWARM_MIN_EDGES edges,
    #: engine/device.py) when the host walker would serve lookups: a
    #: delta chain's snapshots, or ones without the reverse-CSR index
    lookup_prewarm: bool = True
    # -- the latency path (engine/latency.py) ---------------------------
    #: batch tiers of the latency path: a latency-mode batch pads to the
    #: smallest tier >= B and replays the program pinned for that tier (a
    #: CUDA graph on ``cuda``); batches past the top tier take the
    #: throughput path.  Any sorted tuple of positive ints
    latency_tiers: Tuple[int, ...] = (256, 1024, 4096)

    @staticmethod
    def for_schema(compiled: CompiledSchema, **overrides) -> "EngineConfig":
        """The defaults with the legacy program's hop caps derived from
        the schema, then ``overrides``."""
        cfg = EngineConfig()
        userset_depth = _userset_depth(compiled)
        arrow_depth = _arrow_depth(compiled)
        if userset_depth == 0:
            cfg = replace(cfg, closure_hops=0)
        elif userset_depth > 0:
            cfg = replace(cfg, closure_hops=min(userset_depth, cfg.closure_hops))
        # -1 (cyclic): keep the default cap.
        if arrow_depth == 0:
            cfg = replace(cfg, subgraph_nodes=1)
        elif arrow_depth > 0:
            # acyclic arrows: the subgraph is as deep as the longest
            # type-level arrow chain (fanout beyond the cap overflows)
            cfg = replace(cfg, subgraph_nodes=max(2, min(1 + 2 * arrow_depth, 32)))
        # Fixpoint iterations: one topo-ordered pass resolves any acyclic
        # rewrite system; cycles through evaluation dependencies propagate
        # one step per iteration, so the bound covers the cycle length AND
        # the subgraph chain length.  Userset recursion is the closure
        # phase's job and forces no iterations here.
        rec = _eval_recursion_bound(compiled)
        if rec == 0:
            cfg = replace(cfg, eval_iters=1)
        else:
            cfg = replace(
                cfg, eval_iters=min(32, max(cfg.subgraph_nodes, rec + 1))
            )
        return replace(cfg, **overrides)

    def packed_on(self) -> bool:
        """The resolved flat_packed flag (None = auto: packed whenever
        the blockslice layout is active)."""
        if self.flat_packed is not None:
            return bool(self.flat_packed) and self.flat_blockslice
        return self.flat_blockslice


def _longest_path(edges: Dict) -> Tuple[int, set]:
    """Longest path length over an adjacency dict {node: iterable(node)}.
    Returns (depth, cyclic_nodes): depth is -1 if cyclic; cyclic_nodes are
    the nodes observed on a cycle."""
    if not edges:
        return 0, set()
    memo: Dict = {}
    stack: List = []
    on_stack: set = set()
    cyclic_nodes: set = set()

    def depth(node) -> int:
        if node in memo:
            return memo[node]
        if node in on_stack:
            # every node from the first occurrence onward is on the cycle
            i = stack.index(node)
            cyclic_nodes.update(stack[i:])
            return 0
        stack.append(node)
        on_stack.add(node)
        d = 0
        for nxt in edges.get(node, ()):  # noqa: B905
            d = max(d, 1 + depth(nxt))
        stack.pop()
        on_stack.discard(node)
        memo[node] = d
        return d

    m = max(depth(n) for n in list(edges))
    return (-1 if cyclic_nodes else m), cyclic_nodes


def _userset_depth(compiled: CompiledSchema) -> int:
    """Nesting depth of the relation-userset graph: 0 = no relation admits
    userset subjects; -1 = cyclic (groups-in-groups); else the max depth."""
    edges: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for tname, d in compiled.schema.definitions.items():
        for rname, relation in d.relations.items():
            for a in relation.allowed:
                if a.relation:
                    edges.setdefault((tname, rname), []).append((a.type, a.relation))
    depth, _ = _longest_path(edges)
    return depth


def _arrow_depth(compiled: CompiledSchema) -> int:
    """Longest type-level chain of arrow (tupleset) traversals: 0 = no
    arrows, -1 = cyclic (recursive hierarchies), else the max chain
    length.  It bounds the resource-subgraph BFS, which walks only arrow
    edges."""
    edges: Dict[str, set] = {}
    for tname, d in compiled.schema.definitions.items():
        for perm in d.permissions.values():
            for ref in _expr_refs(perm.expr):
                if isinstance(ref, Arrow):
                    for a in d.relations[ref.left].allowed:
                        if not a.wildcard:
                            edges.setdefault(tname, set()).add(a.type)
    depth, _ = _longest_path(edges)
    return depth


def _eval_dep_graph(
    compiled: CompiledSchema,
) -> Dict[Tuple[str, str], List[Tuple[str, str]]]:
    """Evaluation-dependency graph over (type, item): permissions depend on
    same-type references and arrow targets; relations are leaves (their
    userset indirection is resolved by the closure phase)."""
    schema = compiled.schema
    edges: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for tname, d in schema.definitions.items():
        for pname, perm in d.permissions.items():
            deps: List[Tuple[str, str]] = []
            for ref in _expr_refs(perm.expr):
                if isinstance(ref, RelationRef):
                    deps.append((tname, ref.name))
                elif isinstance(ref, Arrow):
                    for a in d.relations[ref.left].allowed:
                        if not a.wildcard and schema.definitions[a.type].item(ref.right):
                            deps.append((a.type, ref.right))
            edges[(tname, pname)] = deps
    return edges


def _eval_recursion_bound(compiled: CompiledSchema) -> int:
    """Cycle bound for the fixpoint ITERATION (not the closure): 0 if
    acyclic, else the number of nodes observed on cycles — an upper bound
    on the extra propagation steps a cycle needs."""
    depth, cyclic_nodes = _longest_path(_eval_dep_graph(compiled))
    if depth >= 0:
        return 0
    return max(1, len(cyclic_nodes))


def _eval_cyclic_pairs(compiled: CompiledSchema) -> frozenset:
    """(type_name, slot) pairs on an evaluation-dependency cycle — the
    pairs whose static unrolling needs a recursion budget (engine/flat.py);
    everything else terminates by schema acyclicity."""
    _, cyclic_nodes = _longest_path(_eval_dep_graph(compiled))
    return frozenset(
        (tname, compiled.slot_of_name[iname]) for tname, iname in cyclic_nodes
    )


@dataclass(frozen=True)
class DevicePlan:
    """Everything static the device codegen needs."""

    ts_slots: Tuple[int, ...]  # tupleset slots; index = ts_idx in arrays
    rel_leaf_slots: Tuple[int, ...]  # relation slots needing leaf tests
    #: (type_name, schema_tid, perm_slot, expr_ir), globally topo-ordered by
    #: dependency depth so one fixpoint iteration resolves any acyclic chain
    topo_programs: Tuple[Tuple[str, int, int, ExprIR], ...]
    num_slots: int
    two_plane: bool  # caveats present → track (definite, possible) planes
    has_permission_usersets: bool
    num_schema_types: int


def _lower_expr(
    e: Expr, ts_index: Dict[int, int], slot_of: Dict[str, int]
) -> ExprIR:
    if isinstance(e, RelationRef):
        return ("ref", slot_of[e.name])
    if isinstance(e, Arrow):
        return ("arrow", ts_index[slot_of[e.left]], slot_of[e.right])
    if isinstance(e, Union):
        return ("union", tuple(_lower_expr(c, ts_index, slot_of) for c in e.children))
    if isinstance(e, Intersection):
        return ("inter", tuple(_lower_expr(c, ts_index, slot_of) for c in e.children))
    if isinstance(e, Exclusion):
        return (
            "excl",
            _lower_expr(e.base, ts_index, slot_of),
            _lower_expr(e.subtracted, ts_index, slot_of),
        )
    if isinstance(e, Nil):
        return ("nil",)
    raise TypeError(f"unknown expression node {e!r}")


def build_plan(compiled: CompiledSchema) -> DevicePlan:
    ts_slots = tuple(sorted(compiled.tupleset_slots))
    ts_index = {slot: i for i, slot in enumerate(ts_slots)}
    slot_of = compiled.slot_of_name

    rel_leaf = set()
    for d in compiled.schema.definitions.values():
        for rname in d.relations:
            rel_leaf.add(slot_of[rname])

    programs: List[Tuple[str, int, int, ExprIR]] = []
    for tname, d in compiled.schema.definitions.items():
        tid = compiled.type_ids[tname]
        for pname, perm in d.permissions.items():
            programs.append(
                (
                    tname,
                    tid,
                    slot_of[pname],
                    _lower_expr(perm.expr, ts_index, slot_of),
                )
            )
    # Global topological order by dependency depth: shallow first, so within
    # one iteration every acyclic dependency is already updated when read.
    programs.sort(key=lambda p: (compiled.item_depths.get((p[0], _name_of(compiled, p[2])), 0), p[0], p[2]))

    return DevicePlan(
        ts_slots=ts_slots,
        rel_leaf_slots=tuple(sorted(rel_leaf)),
        topo_programs=tuple(programs),
        num_slots=max(compiled.num_slots, 1),
        two_plane=bool(compiled.schema.caveats),
        has_permission_usersets=compiled.has_permission_usersets,
        num_schema_types=len(compiled.type_ids),
    )


def _name_of(compiled: CompiledSchema, slot: int) -> str:
    for name, s in compiled.slot_of_name.items():
        if s == slot:
            return name
    return ""
