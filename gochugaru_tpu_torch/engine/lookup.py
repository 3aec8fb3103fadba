"""Device-backed LookupResources / LookupSubjects.

The reference streams these from the server (client/client.go:508-552,
561-599).  This module is the two-stage pipeline (SURVEY.md §7.7
"lookups as reverse-BFS on transposed adjacency"):

1. **Candidate expansion.**  On snapshots carrying the reverse-CSR index
   (engine/rev.py) the device frontier (engine/spmv.py) expands a
   **provable superset** of the answer hop by hop; elsewhere the host
   walker below does the same over transposed sorted views (numpy
   ``searchsorted`` range scans), built lazily once per Snapshot.  Every
   grant needs at least one positive edge path from resource to subject
   through the rewrite graph, so reverse reachability over
   {direct-grant edges ∪ arrows ∪ userset membership ∪
   permission-valued userset chains} (ignoring caveat/expiry gates,
   which only shrink results) covers union/intersection/exclusion/
   arrow/wildcard/self-identity semantics.

2. **Exact forward filter (device).**  The candidates run through the
   engine's batched check in one dispatch per block (``check_columns``);
   definite grants stream back through the interner.  Overflowed and
   possible-not-definite candidates re-check on the host oracle, which
   keeps exactly the definite ones — matching oracle.lookup_*'s
   conditional omission (the bool collapse, client/client.go:277).

Along a Watch/delta chain the transposed index is not rebuilt: the
store's merge advances a live index by the chain's removals and
additions in O(E + D log E) (``advance_lookup_index``), or stashes the
O(D) advance inputs for the first real lookup (``redeem_chain_stash``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..native.sort import argsort1, lexsort2
from ..rel.relationship import WILDCARD_ID
from ..store.snapshot import Snapshot

#: padding floor for the lookup exact-filter batch (see _exact_filter)
LOOKUP_BUCKET_MIN = 4096

_B32 = np.int64(2**32)


def _ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenated index ranges [lo[i], hi[i]) — the ragged gather that
    turns per-key searchsorted bounds into one flat index array."""
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    starts = np.repeat(lo.astype(np.int64), counts)
    ends = np.cumsum(counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)
    return starts + offs


@dataclass
class LookupIndex:
    """Transposed sorted views for reverse expansion, built once per
    Snapshot (lazily) and cached on it."""

    #: all edges keyed by packed (subject, srel1), sorted
    rs_key: np.ndarray  # int64[E] = subj * (num_slots+1) + srel1
    rs_res: np.ndarray  # int32[E]
    rs_rel: np.ndarray  # int32[E]
    #: arrow edges keyed by child node, sorted
    ra_child: np.ndarray  # int32[A]
    ra_res: np.ndarray  # int32[A]
    #: all edges keyed by resource node, sorted (stable → within a run the
    #: residual order is the primary (rel, subj, srel1))
    er_res: np.ndarray  # int32[E]
    er_rel: np.ndarray  # int32[E]
    er_subj: np.ndarray  # int32[E]
    er_srel1: np.ndarray  # int32[E]
    #: primary view packed (rel, res) — already sorted by construction
    e_relres: np.ndarray  # int64[E]
    #: arrow view packed (rel, res) — already sorted by construction
    ar_relres: np.ndarray  # int64[A]
    #: [interner num_types, num_slots] — slot is a permission on the type
    perm_table: np.ndarray
    #: interner tid → permission slots on that type (int64 array)
    perm_slots_of_tid: Dict[int, np.ndarray]


def _perm_tables(snap: Snapshot):
    """Per-interner-type permission tables, sized to the CURRENT interner
    (a delta can intern the first node of a schema type, growing it)."""
    interner = snap.interner
    compiled = snap.compiled
    perm_table = np.zeros((max(interner.num_types, 1), snap.num_slots), bool)
    perm_slots_of_tid: Dict[int, np.ndarray] = {}
    for tname, d in compiled.schema.definitions.items():
        itid = interner.type_lookup(tname)
        if itid < 0:
            continue
        slots = np.asarray(
            sorted(compiled.slot_of_name[p] for p in d.permissions), np.int64
        )
        if slots.size:
            perm_table[itid, slots] = True
            perm_slots_of_tid[itid] = slots
    return perm_table, perm_slots_of_tid


_BUILD_LOCK_GUARD = threading.Lock()


def lookup_index(snap: Snapshot, mark_used: bool = True) -> LookupIndex:
    """The transposed index, built once per snapshot.  ``mark_used``
    records that lookups are actually consumed on this snapshot — the
    signal apply_delta's defer heuristic reads; the prepare-time prewarm
    passes False so merely prewarming never pushes Watch revisions onto
    the eager O(E) path (store/delta.py)."""
    if mark_used:
        snap._lookup_used = True
    idx = getattr(snap, "_lookup_index", None)
    if idx is not None:
        return idx
    # race-safe: the prepare-time prewarm thread (engine/device.py) and a
    # first user lookup may arrive together — one builds, the other
    # waits.  Lock creation itself goes through a module-level guard so
    # two racers can't each mint their own lock and build twice
    with _BUILD_LOCK_GUARD:
        lock = getattr(snap, "_lookup_build_lock", None)
        if lock is None:
            lock = threading.Lock()
            snap._lookup_build_lock = lock
    with lock:
        idx = getattr(snap, "_lookup_index", None)
        if idx is not None:
            return idx
        # chain-advance fast path: materializing a chained LSM snapshot
        # whose BASE carries a LIVE index advances it as part of the
        # merge (store/delta.py _materialize_locked) in O(E + D log E)
        # identity merges; an UNUSED (prewarm-only) index is not paid
        # for per revision — the merge stashes the O(D) advance inputs
        # and the first real lookup advances from the stash here.
        # Either way the O(E log E) rebuild is skipped
        if getattr(snap, "_lsm_base", None) is not None:
            snap._materialize()
        idx = getattr(snap, "_lookup_index", None)
        if idx is not None:  # the materialization advanced it
            return idx
        if redeem_chain_stash(snap):
            return snap._lookup_index
        return _build_lookup_index(snap)


def _build_lookup_index(snap: Snapshot) -> LookupIndex:
    NS1 = snap.num_slots + 1
    order = lexsort2(snap.e_subj, snap.e_srel1)
    rs_key = (
        snap.e_subj[order].astype(np.int64) * NS1
        + snap.e_srel1[order].astype(np.int64)
    )
    ra_order = argsort1(snap.ar_child)
    er_order = argsort1(snap.e_res)
    perm_table, perm_slots_of_tid = _perm_tables(snap)
    idx = LookupIndex(
        rs_key=rs_key,
        rs_res=snap.e_res[order],
        rs_rel=snap.e_rel[order],
        ra_child=snap.ar_child[ra_order],
        ra_res=snap.ar_res[ra_order],
        er_res=snap.e_res[er_order],
        er_rel=snap.e_rel[er_order],
        er_subj=snap.e_subj[er_order],
        er_srel1=snap.e_srel1[er_order],
        e_relres=snap.e_rel.astype(np.int64) * _B32 + snap.e_res.astype(np.int64),
        ar_relres=snap.ar_rel.astype(np.int64) * _B32 + snap.ar_res.astype(np.int64),
        perm_table=perm_table,
        perm_slots_of_tid=perm_slots_of_tid,
    )
    snap._lookup_index = idx
    return idx


def _setdiff(new: np.ndarray, seen: np.ndarray) -> np.ndarray:
    if new.size == 0 or seen.size == 0:
        return new
    return new[~np.isin(new, seen)]


def _exact_filter(
    engine,
    dsnap,
    cand: np.ndarray,
    q_res: np.ndarray,
    q_perm: np.ndarray,
    q_subj: np.ndarray,
    q_srel: np.ndarray,
    q_wc: np.ndarray,
    now_us: Optional[int],
    oracle_check: Callable[[int], bool],
) -> np.ndarray:
    """Run the device forward check over candidate queries; returns the
    subset of ``cand`` definitively granted.  Overflowed AND
    possible-not-definite items re-check on the host oracle — the oracle
    includes the ones it resolves to T and drops genuinely-conditional
    ones, exactly matching oracle.lookup_* (conditional omission = the
    bool collapse, client/client.go:277).  Resolving p&~d on the host
    matters for permission-valued userset subjects, where the device can
    only ever report "possible" but the host answer is definite."""
    # coarse bucket floor: per-subject candidate counts vary, and every
    # fresh pow2 bucket costs a kernel retrace — with a 4096 floor, warm
    # lookups share one compiled program
    d, p, ovf = engine.check_columns(
        dsnap, q_res, q_perm, q_subj, q_srel=q_srel, q_wc=q_wc,
        now_us=now_us, bucket_min=LOOKUP_BUCKET_MIN,
    )
    needs_host = ovf | (p & ~d)
    granted = list(cand[d & ~needs_host])
    for i in np.nonzero(needs_host)[0]:
        if oracle_check(int(cand[i])):
            granted.append(int(cand[i]))
    return np.asarray(granted, np.int64)


def _resolve_resources(dsnap, resource_type, permission, subject_type,
                       subject_id, subject_relation):
    """Shared query lowering of a LookupResources call: (rtid,
    perm_slot, srel_slot, subj_node, wc_node) or None when the answer is
    [] by construction (unknown names)."""
    snap: Snapshot = dsnap.snapshot
    interner = snap.interner
    compiled = snap.compiled
    perm_slot = compiled.slot_of_name.get(permission)
    rtid = interner.type_lookup(resource_type)
    if perm_slot is None or rtid < 0:
        return None
    if subject_relation and subject_relation not in compiled.slot_of_name:
        return None
    srel_slot = compiled.slot_of_name[subject_relation] if subject_relation else -1
    subj_node = interner.lookup(subject_type, subject_id)
    stid = interner.type_lookup(subject_type)
    wc_node = -1
    if (
        srel_slot < 0
        and subject_id != WILDCARD_ID
        and 0 <= stid < snap.wildcard_node_of_type.shape[0]
    ):
        wc_node = int(snap.wildcard_node_of_type[stid])
    if subj_node < 0 and wc_node < 0:
        return None
    return rtid, perm_slot, srel_slot, subj_node, wc_node


def _walk_resource_candidates(
    snap: Snapshot, subj_node: int, srel_slot: int, wc_node: int
) -> np.ndarray:
    """The host walker's reverse worklist expansion: every node on a
    positive reverse path from the subject — the PARITY ORACLE of the
    device frontier path (engine/spmv.py), and the serving path for
    snapshots without the reverse-CSR index (``flat_rev_index=False``)
    and for LSM delta chains, whose advance_lookup_index keeps it
    exact.

    The worklist is over *subject-occurrence keys* packed
    (node, srel1): scanning a key yields every edge where that userset
    (or direct subject / wildcard) appears as the subject; each hit's
    resource becomes a candidate, is closed under reverse arrows, and
    contributes new keys — (res, rel+1) for the granted relation (the
    membership chain, generalizing the device's Phase-A closure) and,
    for schemas with permission-valued usersets, (n, p+1) for every
    permission p on each new node n (the subject may hold p on n, so
    edges granted to n#p may be granted to the subject)."""
    compiled = snap.compiled
    NS1 = snap.num_slots + 1
    idx = lookup_index(snap)
    perm_chains = bool(compiled.has_permission_usersets)

    def rev_arrows(frontier: np.ndarray) -> np.ndarray:
        lo = np.searchsorted(idx.ra_child, frontier, "left")
        hi = np.searchsorted(idx.ra_child, frontier, "right")
        return idx.ra_res[_ranges(lo, hi)].astype(np.int64)

    init: List[np.ndarray] = []
    if subj_node >= 0:
        init.append(
            np.array(
                [subj_node * NS1 + (srel_slot + 1 if srel_slot >= 0 else 0)], np.int64
            )
        )
    if wc_node >= 0:
        init.append(np.array([wc_node * NS1], np.int64))
    seen_keys = np.unique(np.concatenate(init))
    key_frontier = seen_keys
    # self-identity: the subject node itself may be the resource
    seen_nodes = (
        np.array([subj_node], np.int64) if subj_node >= 0 else np.empty(0, np.int64)
    )
    while key_frontier.size:
        lo = np.searchsorted(idx.rs_key, key_frontier, "left")
        hi = np.searchsorted(idx.rs_key, key_frontier, "right")
        ii = _ranges(lo, hi)
        new_keys: List[np.ndarray] = []
        if ii.size:
            res = idx.rs_res[ii].astype(np.int64)
            relk = idx.rs_rel[ii].astype(np.int64)
            # granted usersets continue the membership chain
            new_keys.append(res * NS1 + relk + 1)
            # candidates: the resources themselves, closed under reverse
            # arrows (parents granting through tupleset traversal)
            fresh_rounds: List[np.ndarray] = []
            node_frontier = _setdiff(np.unique(res), seen_nodes)
            while node_frontier.size:
                seen_nodes = np.union1d(seen_nodes, node_frontier)
                fresh_rounds.append(node_frontier)
                parents = np.unique(rev_arrows(node_frontier))
                node_frontier = _setdiff(parents, seen_nodes)
            if perm_chains and fresh_rounds:
                # the subject may hold any permission on any fresh
                # candidate node; edges granted to n#p extend the chain
                fresh = np.concatenate(fresh_rounds)
                tids = snap.node_type[fresh]
                for t in np.unique(tids):
                    slots = idx.perm_slots_of_tid.get(int(t))
                    if slots is None:
                        continue
                    nn = fresh[tids == t]
                    new_keys.append(
                        (nn[:, None] * NS1 + slots[None, :] + 1).ravel()
                    )
        if new_keys:
            nk = np.unique(np.concatenate(new_keys))
            key_frontier = _setdiff(nk, seen_keys)
            seen_keys = np.union1d(seen_keys, key_frontier)
        else:
            key_frontier = np.empty(0, np.int64)

    return seen_nodes


def _resolve_subjects(dsnap, resource_type, resource_id, permission,
                      subject_type, subject_relation):
    """Shared query lowering of a LookupSubjects call: (res_node,
    perm_slot, srel_slot, stid, wc_node) or None when the answer is []
    by construction."""
    snap: Snapshot = dsnap.snapshot
    interner = snap.interner
    compiled = snap.compiled
    perm_slot = compiled.slot_of_name.get(permission)
    res_node = interner.lookup(resource_type, resource_id)
    stid = interner.type_lookup(subject_type)
    if perm_slot is None or res_node < 0 or stid < 0:
        return None
    if subject_relation and subject_relation not in compiled.slot_of_name:
        return None
    srel_slot = compiled.slot_of_name[subject_relation] if subject_relation else -1
    wc_node = -1
    if 0 <= stid < snap.wildcard_node_of_type.shape[0]:
        wc_node = int(snap.wildcard_node_of_type[stid])
    return res_node, perm_slot, srel_slot, stid, wc_node


def _walk_subject_candidates(
    snap: Snapshot, res_node: int, stid: int, srel_slot: int, wc_node: int
) -> np.ndarray:
    """The host walker's forward worklist expansion — the parity oracle
    of the device forward-frontier path and the fallback for layouts
    without the reverse-CSR index.

    The worklist alternates nodes and userset pairs: a node contributes
    its arrow subgraph and every edge hanging off it (direct subjects →
    candidates, userset subjects → pairs); a pair (g, r) contributes g's
    members when r is a relation (edges (r, g)), or puts g back on the
    node worklist when r is a *permission* — holders of r on g are found
    by expanding g itself (superset; the forward check is exact)."""
    compiled = snap.compiled
    NS = snap.num_slots
    idx = lookup_index(snap)
    ts_slots = np.asarray(sorted(compiled.tupleset_slots), np.int64)

    def fwd_arrows(frontier: np.ndarray) -> np.ndarray:
        if ts_slots.size == 0:
            return np.empty(0, np.int64)
        kk = (ts_slots[:, None] * _B32 + frontier[None, :]).ravel()
        lo = np.searchsorted(idx.ar_relres, kk, "left")
        hi = np.searchsorted(idx.ar_relres, kk, "right")
        return snap.ar_child[_ranges(lo, hi)].astype(np.int64)

    cand_parts: List[np.ndarray] = []
    wildcard_found = False
    seen_nodes = np.empty(0, np.int64)
    seen_pairs = np.empty(0, np.int64)
    node_frontier = np.array([res_node], np.int64)
    pair_frontier = np.empty(0, np.int64)

    def absorb_edges(subs: np.ndarray, sr1: np.ndarray) -> np.ndarray:
        """Direct subjects → candidates / wildcard flag; userset subjects
        → packed pairs.  Returns the new pairs."""
        nonlocal wildcard_found
        direct = subs[sr1 == 0].astype(np.int64)
        if srel_slot < 0 and direct.size:
            cand_parts.append(direct[snap.node_type[direct] == stid])
        if wc_node >= 0 and not wildcard_found and np.any(direct == wc_node):
            wildcard_found = True
        um = sr1 > 0
        return subs[um].astype(np.int64) * NS + (sr1[um].astype(np.int64) - 1)

    while node_frontier.size or pair_frontier.size:
        new_pairs: List[np.ndarray] = []
        next_nodes: List[np.ndarray] = []
        if node_frontier.size:
            # arrow closure of the frontier, then every edge off the new nodes
            frontier = node_frontier
            fresh_all: List[np.ndarray] = []
            while frontier.size:
                fresh = _setdiff(np.unique(frontier), seen_nodes)
                if fresh.size == 0:
                    break
                seen_nodes = np.union1d(seen_nodes, fresh)
                fresh_all.append(fresh)
                frontier = fwd_arrows(fresh)
            if fresh_all:
                nodes = np.concatenate(fresh_all)
                lo = np.searchsorted(idx.er_res, nodes, "left")
                hi = np.searchsorted(idx.er_res, nodes, "right")
                ii = _ranges(lo, hi)
                new_pairs.append(absorb_edges(idx.er_subj[ii], idx.er_srel1[ii]))
        if pair_frontier.size:
            g = pair_frontier // NS
            r = pair_frontier % NS
            is_perm = idx.perm_table[snap.node_type[g], r]
            # permission pairs: holders of g#p ⊆ expansion of g itself
            if np.any(is_perm):
                next_nodes.append(g[is_perm])
            # relation pairs: members are the subjects of edges (r, g)
            rel_g, rel_r = g[~is_perm], r[~is_perm]
            if rel_g.size:
                kk = rel_r * _B32 + rel_g
                lo = np.searchsorted(idx.e_relres, kk, "left")
                hi = np.searchsorted(idx.e_relres, kk, "right")
                jj = _ranges(lo, hi)
                new_pairs.append(
                    absorb_edges(
                        snap.e_subj[jj].astype(np.int64),
                        snap.e_srel1[jj].astype(np.int64),
                    )
                )
        if new_pairs:
            np_all = np.unique(np.concatenate(new_pairs))
            pair_frontier = _setdiff(np_all, seen_pairs)
            seen_pairs = np.union1d(seen_pairs, pair_frontier)
        else:
            pair_frontier = np.empty(0, np.int64)
        node_frontier = (
            _setdiff(np.unique(np.concatenate(next_nodes)), seen_nodes)
            if next_nodes
            else np.empty(0, np.int64)
        )

    if srel_slot >= 0 and seen_pairs.size:
        # userset-subject lookup: candidate usersets with matching relation
        gs = seen_pairs[seen_pairs % NS == srel_slot] // NS
        cand_parts.append(gs[snap.node_type[gs] == stid])
    # self-identity: the resource itself can be the subject
    if snap.node_type[res_node] == stid:
        cand_parts.append(np.array([res_node], np.int64))
    if wildcard_found and srel_slot < 0:
        # a reachable wildcard grants every direct subject of the type
        # that appears anywhere in the graph (oracle's subjects_of_type)
        all_subj = np.unique(snap.e_subj).astype(np.int64)
        cand_parts.append(all_subj[snap.node_type[all_subj] == stid])

    if not cand_parts:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(cand_parts))


# ---------------------------------------------------------------------------
# dispatch: device frontier SpMV (engine/spmv.py) with walker fallback,
# cursor-paginated streaming
# ---------------------------------------------------------------------------


def _res_filter(engine, dsnap, resolved, names, now_us, oracle_factory):
    """(filter_fn, id_of) of one LookupResources query — exact device
    forward check over a candidate block, oracle re-checks for
    overflow/possible (shared by the frontier and walker streams)."""
    rtid, perm_slot, srel_slot, subj_node, wc_node = resolved
    resource_type, permission, subject_type, subject_id, subject_relation = names
    interner = dsnap.snapshot.interner
    oracle = [None]

    def oracle_check(node: int) -> bool:
        if oracle[0] is None:
            oracle[0] = oracle_factory()
        from .oracle import T

        _, rid = interner.key_of(node)
        # now_us pins the re-check to the stream's evaluation time — a
        # recompute-resume must not re-gate expirations at a later clock
        return oracle[0].check(
            resource_type, rid, permission,
            subject_type, subject_id, subject_relation,
            now_us=now_us,
        ) == T

    def filt(cand: np.ndarray) -> np.ndarray:
        B = cand.shape[0]
        return _exact_filter(
            engine, dsnap, cand,
            q_res=cand.astype(np.int32),
            q_perm=np.full(B, perm_slot, np.int32),
            q_subj=np.full(B, subj_node, np.int32),
            q_srel=np.full(B, srel_slot, np.int32),
            q_wc=np.full(B, wc_node, np.int32),
            now_us=now_us,
            oracle_check=oracle_check,
        )

    return filt, (lambda n: interner.key_of(n)[1])


def _subj_filter(engine, dsnap, resolved, names, now_us, oracle_factory):
    res_node, perm_slot, srel_slot, stid, wc_node = resolved
    resource_type, resource_id, permission, subject_type, subject_relation = names
    interner = dsnap.snapshot.interner
    oracle = [None]

    def oracle_check(node: int) -> bool:
        if oracle[0] is None:
            oracle[0] = oracle_factory()
        from .oracle import T

        _, sid = interner.key_of(node)
        return oracle[0].check(
            resource_type, resource_id, permission,
            subject_type, sid, subject_relation,
            now_us=now_us,
        ) == T

    def filt(cand: np.ndarray) -> np.ndarray:
        B = cand.shape[0]
        q_wc = np.full(B, -1, np.int32)
        if srel_slot < 0 and wc_node >= 0:
            # a candidate that IS the wildcard node checks as itself, not
            # against the wildcard (oracle: subject_id != WILDCARD guard)
            q_wc = np.where(cand == wc_node, -1, wc_node).astype(np.int32)
        return _exact_filter(
            engine, dsnap, cand,
            q_res=np.full(B, res_node, np.int32),
            q_perm=np.full(B, perm_slot, np.int32),
            q_subj=cand.astype(np.int32),
            q_srel=np.full(B, srel_slot, np.int32),
            q_wc=q_wc,
            now_us=now_us,
            oracle_check=oracle_check,
        )

    return filt, (lambda n: interner.key_of(n)[1])


def _one_block(cand: np.ndarray):
    if cand.size:
        yield cand


def _frontier_stream_bytes(meta, snap) -> int:
    """Estimated host bytes a live frontier stream holds (the seen-set
    bitmaps dominate) — the paginate cache's eviction weight."""
    ns = max(snap.num_slots, 1) + 1
    return (meta.N * meta.S1 + 2 * meta.N + meta.N * ns) >> 3


def lookup_resources_page(
    engine,
    dsnap,
    resource_type: str,
    permission: str,
    subject_type: str,
    subject_id: str,
    subject_relation: str = "",
    *,
    page_size: int = 1_000,
    cursor=None,
    now_us: Optional[int] = None,
    oracle_factory: Optional[Callable[[], object]] = None,
):
    """One cursor-paginated page of LookupResources: (ids, next_cursor).

    Results stream in deterministic discovery order — the first page of
    a 10M-resource answer returns after the first few frontier hops,
    before the fixpoint completes.  ``cursor`` (engine/spmv.py
    LookupCursor) is revision-pinned: resuming continues the cached
    live stream, or deterministically recomputes and skips.  The device
    frontier path (engine/spmv.py) serves snapshots carrying the
    reverse-CSR index; others, and LSM delta chains, keep the host
    walker."""
    from . import spmv

    names = (resource_type, permission, subject_type, subject_id,
             subject_relation)
    # evaluation time resolves ONCE and rides the cursor: a recompute-
    # resume must re-gate expirations at the same instant (spmv.py)
    now_us = spmv.resolve_now_us(cursor, now_us)
    token = spmv.query_token("res", dsnap.revision, now_us, *names)
    resolved = _resolve_resources(dsnap, *names)
    if resolved is None:
        return [], None
    rtid, perm_slot, srel_slot, subj_node, wc_node = resolved
    filt, id_of = _res_filter(
        engine, dsnap, resolved, names, now_us, oracle_factory
    )
    snap = dsnap.snapshot

    def make_stream():
        if spmv.frontier_ok(engine, dsnap):
            from ..utils import metrics as _m

            _m.default.inc("lookups.frontier")
            st = spmv.state_for(engine, dsnap)
            if st._spmm is not None:
                # served by the fused K-hop program (engine/spmm.py)
                _m.default.inc("lookups.fused")
            cands = st.resource_candidates(
                rtid, subj_node, srel_slot, wc_node, now_us
            )
            cost = _frontier_stream_bytes(dsnap.flat_meta, snap)
        else:
            from ..utils import metrics as _m

            _m.default.inc("lookups.walker")
            seen = _walk_resource_candidates(
                snap, subj_node, srel_slot, wc_node
            )
            cands = _one_block(seen[snap.node_type[seen] == rtid])
            cost = 1 << 20
        return spmv._ResultStream(cands, filt, id_of, cost_bytes=cost)

    return spmv.paginate(
        dsnap, token, make_stream, page_size, cursor, now_us
    )


def lookup_subjects_page(
    engine,
    dsnap,
    resource_type: str,
    resource_id: str,
    permission: str,
    subject_type: str,
    subject_relation: str = "",
    *,
    page_size: int = 1_000,
    cursor=None,
    now_us: Optional[int] = None,
    oracle_factory: Optional[Callable[[], object]] = None,
):
    """One cursor-paginated page of LookupSubjects: (ids, next_cursor) —
    the forward-frontier mirror of ``lookup_resources_page``."""
    from . import spmv

    names = (resource_type, resource_id, permission, subject_type,
             subject_relation)
    now_us = spmv.resolve_now_us(cursor, now_us)
    token = spmv.query_token("subj", dsnap.revision, now_us, *names)
    resolved = _resolve_subjects(dsnap, *names)
    if resolved is None:
        return [], None
    res_node, perm_slot, srel_slot, stid, wc_node = resolved
    filt, id_of = _subj_filter(
        engine, dsnap, resolved, names, now_us, oracle_factory
    )
    snap = dsnap.snapshot

    def make_stream():
        if spmv.frontier_ok(engine, dsnap) and dsnap.flat_meta.has_fw:
            from ..utils import metrics as _m

            _m.default.inc("lookups.frontier")
            st = spmv.state_for(engine, dsnap)
            if st._spmm is not None:
                _m.default.inc("lookups.fused")
            cands = st.subject_candidates(
                res_node, stid, srel_slot, wc_node, now_us
            )
            cost = _frontier_stream_bytes(dsnap.flat_meta, snap)
        else:
            from ..utils import metrics as _m

            _m.default.inc("lookups.walker")
            cands = _one_block(_walk_subject_candidates(
                snap, res_node, stid, srel_slot, wc_node
            ))
            cost = 1 << 20
        return spmv._ResultStream(cands, filt, id_of, cost_bytes=cost)

    return spmv.paginate(
        dsnap, token, make_stream, page_size, cursor, now_us
    )


def lookup_resources_device(
    engine,
    dsnap,
    resource_type: str,
    permission: str,
    subject_type: str,
    subject_id: str,
    subject_relation: str = "",
    *,
    now_us: Optional[int] = None,
    oracle_factory: Optional[Callable[[], object]] = None,
) -> List[str]:
    """Resource ids of ``resource_type`` the subject definitively holds
    ``permission`` on, sorted — the full-answer surface (drains the
    paginated stream).  Matches oracle.lookup_resources exactly on both
    serving paths (tests/test_lookup.py, tests/test_lookup_stream.py)."""
    out: List[str] = []
    cursor = None
    while True:
        ids, cursor = lookup_resources_page(
            engine, dsnap, resource_type, permission, subject_type,
            subject_id, subject_relation,
            page_size=65_536, cursor=cursor, now_us=now_us,
            oracle_factory=oracle_factory,
        )
        out.extend(ids)
        if cursor is None:
            return sorted(out)


def lookup_subjects_device(
    engine,
    dsnap,
    resource_type: str,
    resource_id: str,
    permission: str,
    subject_type: str,
    subject_relation: str = "",
    *,
    now_us: Optional[int] = None,
    oracle_factory: Optional[Callable[[], object]] = None,
) -> List[str]:
    """Subject ids of ``subject_type`` definitively holding ``permission``
    on the resource, sorted — the full-answer surface of the paginated
    stream.  Matches oracle.lookup_subjects exactly on both paths."""
    out: List[str] = []
    cursor = None
    while True:
        ids, cursor = lookup_subjects_page(
            engine, dsnap, resource_type, resource_id, permission,
            subject_type, subject_relation,
            page_size=65_536, cursor=cursor, now_us=now_us,
            oracle_factory=oracle_factory,
        )
        out.extend(ids)
        if cursor is None:
            return sorted(out)


# ---------------------------------------------------------------------------
# incremental index maintenance (Watch-driven re-index, BASELINE config 5)
# ---------------------------------------------------------------------------


def _view_keys(idx: "LookupIndex", ra_rel_src: Optional[Snapshot]):
    """Packed (k1, k2) int64 key arrays per transposed view, cached on
    the index — advancing then never re-packs or re-casts the O(E)
    columns, only merges them forward (the cache rides to the advanced
    index, so a Watch chain packs once per full build, not per
    revision)."""
    d = idx.__dict__
    if "_rs_k2" not in d:
        d["_rs_k2"] = (
            idx.rs_rel.astype(np.int64) * _B32 + idx.rs_res
        )
    if "_er_k1" not in d:
        d["_er_k1"] = idx.er_res.astype(np.int64)
    if "_er_k2" not in d:
        d["_er_k2"] = (
            (idx.er_rel.astype(np.int64) << np.int64(47))
            | (idx.er_subj.astype(np.int64) << np.int64(16))
            | idx.er_srel1.astype(np.int64)
        )
    if "_ra_k1" not in d:
        d["_ra_k1"] = idx.ra_child.astype(np.int64)
    if "_ra_k2" not in d:
        ra_rel = _ra_rel_of(ra_rel_src, idx)
        d["_ra_k2"] = ra_rel.astype(np.int64) * _B32 + idx.ra_res
    return d


def redeem_chain_stash(snap: Snapshot) -> bool:
    """Consume a deferred chain-advance stash on ``snap`` (written by
    store/delta.py _materialize_locked when the base's index was unused):
    one identity advance produces ``snap._lookup_index``.  Returns True
    when a stash was redeemed."""
    stash = snap.__dict__.pop("_lookup_chain_stash", None)
    if stash is None:
        return False
    (bidx, g_rel, g_res, g_subj, g_srel1,
     a_rel, a_res, a_subj, a_srel1) = stash
    advance_lookup_index(
        bidx, snap,
        num_slots=snap.num_slots,
        tupleset_slots=snap.compiled.tupleset_slots,
        g_rel=g_rel, g_res=g_res, g_subj=g_subj, g_srel1=g_srel1,
        a_rel=a_rel, a_res=a_res, a_subj=a_subj, a_srel1=a_srel1,
    )
    return True


def advance_lookup_index(
    idx: "LookupIndex",
    nxt: Snapshot,
    *,
    num_slots: int,
    tupleset_slots,
    ra_rel_src: Optional[Snapshot] = None,
    g_rel: np.ndarray,
    g_res: np.ndarray,
    g_subj: np.ndarray,
    g_srel1: np.ndarray,
    a_rel: np.ndarray,
    a_res: np.ndarray,
    a_subj: np.ndarray,
    a_srel1: np.ndarray,
) -> None:
    """Produce ``nxt._lookup_index`` from ``prev``'s by removing the
    ``g_*`` identities and merging the sorted ``a_*`` additions into each
    transposed view — O(E + D log E) instead of the full O(E log E)
    rebuild.  Removal is by IDENTITY (not row position), so the delta may
    span a whole LSM chain: apply_delta calls this per eager revision,
    and _materialize_locked calls it when a chained snapshot merges, with
    the base's accumulated tombstones + overlay (store/delta.py).  The
    packed per-view key arrays are cached on the index and merged
    forward (_view_keys), so repeated advances pay only array copies.

    ``idx`` is the index being advanced; ``ra_rel_src`` is the snapshot
    whose ar view recovers the index's ra-rel column on a cache miss —
    None is fine when ``idx`` already carries ``_ra_rel`` (the stash
    path pre-caches it)."""
    from ..store.delta import find_in_view, merge_positions

    keys = _view_keys(idx, ra_rel_src)
    NS1 = np.int64(num_slots + 1)
    g_rel = g_rel.astype(np.int64)
    g_res = g_res.astype(np.int64)
    g_subj = g_subj.astype(np.int64)
    g_srel1 = g_srel1.astype(np.int64)
    a_rel = a_rel.astype(np.int64)
    a_res = a_res.astype(np.int64)
    a_subj = a_subj.astype(np.int64)
    a_srel1 = a_srel1.astype(np.int64)

    def pack_rr(rel, res):
        return rel * _B32 + res

    def pack_rss(rel, subj, srel1):
        return (rel << np.int64(47)) | (subj << np.int64(16)) | srel1

    def advance_view(old_k1, old_k2, cols_old, rem_k1, rem_k2,
                     new_k1, new_k2, cols_new):
        """Merged (k1, k2, cols...) of one lexsorted view post-delta."""
        pos = find_in_view(old_k1, old_k2, rem_k1, rem_k2)
        keep = np.ones(old_k1.shape[0], dtype=bool)
        keep[pos[pos >= 0]] = False
        n_ord = np.lexsort((new_k2, new_k1))
        po, pn = merge_positions(
            old_k1[keep], old_k2[keep], new_k1[n_ord], new_k2[n_ord]
        )
        total = po.shape[0] + pn.shape[0]

        def m(co, cn):
            out = np.empty(total, co.dtype)
            out[po] = co[keep]
            out[pn] = cn[n_ord].astype(co.dtype)
            return out

        return (
            m(old_k1, new_k1), m(old_k2, new_k2),
            [m(co, cn) for co, cn in zip(cols_old, cols_new)],
        )

    # rs view: keyed (subj, srel1); residual order (rel, res)
    rs_key, rs_k2, (rs_res, rs_rel) = advance_view(
        idx.rs_key, keys["_rs_k2"],
        (idx.rs_res, idx.rs_rel),
        g_subj * NS1 + g_srel1, pack_rr(g_rel, g_res),
        a_subj * NS1 + a_srel1, pack_rr(a_rel, a_res),
        (a_res, a_rel),
    )

    # er view: keyed res; residual order (rel, subj, srel1)
    er_k1, er_k2, (er_rel, er_subj, er_srel1) = advance_view(
        keys["_er_k1"], keys["_er_k2"],
        (idx.er_rel, idx.er_subj, idx.er_srel1),
        g_res, pack_rss(g_rel, g_subj, g_srel1),
        a_res, pack_rss(a_rel, a_subj, a_srel1),
        (a_rel, a_subj, a_srel1),
    )

    # ra view: arrow rows only (tupleset relation, direct subject), keyed
    # child node; residual order (rel, res)
    ts = np.asarray(sorted(tupleset_slots), np.int64)
    g_ar = np.isin(g_rel, ts) & (g_srel1 == 0)
    a_ar = np.isin(a_rel, ts) & (a_srel1 == 0)
    prev_ra_rel = _ra_rel_of(ra_rel_src, idx)
    ra_k1, ra_k2, (ra_res, ra_rel) = advance_view(
        keys["_ra_k1"], keys["_ra_k2"],
        (idx.ra_res, prev_ra_rel),
        g_subj[g_ar], pack_rr(g_rel[g_ar], g_res[g_ar]),
        a_subj[a_ar], pack_rr(a_rel[a_ar], a_res[a_ar]),
        (a_res[a_ar], a_rel[a_ar]),
    )

    # the delta may have interned the FIRST node of a schema type, growing
    # the interner's type space — a carried perm_table would be undersized
    # and index out of bounds; the rebuild is O(types × permissions)
    if idx.perm_table.shape[0] >= max(nxt.interner.num_types, 1):
        perm_table, perm_slots = idx.perm_table, idx.perm_slots_of_tid
    else:
        perm_table, perm_slots = _perm_tables(nxt)
    new_idx = LookupIndex(
        rs_key=rs_key,
        rs_res=rs_res, rs_rel=rs_rel,
        ra_child=ra_k1.astype(np.int32), ra_res=ra_res,
        er_res=er_k1.astype(np.int32), er_rel=er_rel,
        er_subj=er_subj, er_srel1=er_srel1,
        e_relres=nxt.e_rel.astype(np.int64) * _B32 + nxt.e_res.astype(np.int64),
        ar_relres=nxt.ar_rel.astype(np.int64) * _B32 + nxt.ar_res.astype(np.int64),
        perm_table=perm_table,
        perm_slots_of_tid=perm_slots,
    )
    # carry the packed key caches: chained advances stay copy-only
    new_idx.__dict__["_rs_k2"] = rs_k2
    new_idx.__dict__["_er_k1"] = er_k1
    new_idx.__dict__["_er_k2"] = er_k2
    new_idx.__dict__["_ra_k1"] = ra_k1
    new_idx.__dict__["_ra_k2"] = ra_k2
    new_idx._ra_rel = ra_rel  # keep chained advances O(E + D log E)
    nxt._lookup_index = new_idx


def _ra_rel_of(snap: Optional[Snapshot], idx: LookupIndex) -> np.ndarray:
    """rel column of the ra view (child-sorted arrow rows), recovered from
    the snapshot's ar view once and cached on the index.  ``snap`` may be
    None only when the cache is already populated (the stash path
    pre-caches before the source snapshot's chain state is dropped)."""
    cached = getattr(idx, "_ra_rel", None)
    if cached is not None:
        return cached
    assert snap is not None, "ra-rel cache miss with no source snapshot"
    ra_order = argsort1(snap.ar_child)
    rel = snap.ar_rel[ra_order].astype(np.int64)
    idx._ra_rel = rel
    return rel
