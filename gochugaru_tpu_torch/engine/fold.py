"""Permission folding (P-index): whole union-of-{leaf, arrow-chain}
rewrites flattened into root-level probe tables at prepare time.

The flat kernel (engine/flat.py) removed per-query *loops*; this layer
removes per-query *levels*.  A `document#view = viewer + folder->view`
check still walks the doc→folder→…→root lattice at trace time, paying an
e-probe + T-probe + arrow-range per level — ~20 dependent gathers into
multi-GB tables for BASELINE config 3's 5-hop world.  Folding joins the
rewrite's arrow chains into the leaf rows once per revision, so the same
check is ONE direct-identity probe (pf_e) plus ONE bounded-fan userset
slice (pf_u) intersected with the member closure at probe time,
regardless of depth — the Leopard construction with the member
expansion FACTORED OUT: resource-side ancestor flattening ⋈ userset
edges stays precomputed, and the closure (store/closure.py) is probed
per candidate group instead of being joined in (the round-5 dense
T-join materialized resource × member and regressed config 3; see
fold_userset_rows).  Expiries fold along paths through the same max-min
two-plane semiring.

Eligibility is per (type, permission): the program must be a union tree
over relation leaves, same-type folded permissions, and arrows through
caveat-free tuplesets whose targets are relations or already-folded
permissions (self-recursive hierarchies go through the ancestor closure
of engine/flat.py:_arrow_closure; mutual cross-type recursion stays on
the walked path).  Direct rows keep their caveat/ctx columns (the CEL VM
gates them at the probe site); userset rows under the fold must be
caveat-free and not permission-valued — the same bar the T-index sets.

Watch-delta levels ride the fold INCREMENTALLY (fold_delta_update,
round 5): the base pf tables stay resident; each revision recomputes
folded rows for exactly the delta-affected resources and ships them as
small replicated overlays, with a dirty-key set voiding the stale base
hits — Leopard's incremental index maintenance as subset-recompute, so
deletions need no derivation counting.  Conditions the subset recompute
can't keep sound or cheap downgrade the chain to the walked program
(sticky pf_off) until compaction re-folds.

Replaces the server-side evaluation behind the reference's
CheckBulkPermissions (client/client.go:238-266) for the
deep-nesting worlds where the walked kernel was 20× off its target.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..native.sort import lexsort2
from ..schema.compiler import CompiledSchema
from ..store.closure import NO_EXP, _expand_join
from .plan import DevicePlan, EngineConfig, ExprIR


@dataclass
class _Rows:
    """Folded rows of one (type, permission): direct-identity rows (the
    pf_e side; caveats ride along) and userset rows (the pf_t side;
    caveat-free by eligibility).  ``until`` is epoch-relative seconds
    with NO_EXP = never expires — the min over the path's arrow/leaf
    expiries."""

    e_res: np.ndarray
    e_k2: np.ndarray
    e_cav: np.ndarray
    e_ctx: np.ndarray
    e_until: np.ndarray
    u_res: np.ndarray
    u_subj: np.ndarray
    u_srel: np.ndarray
    u_until: np.ndarray

    @property
    def total(self) -> int:
        return int(self.e_res.shape[0] + self.u_res.shape[0])


def _empty_rows() -> _Rows:
    z = np.zeros(0, np.int32)
    return _Rows(z, z, z, z, z, z, z, z, z)


def _concat_rows(parts: List[_Rows]) -> _Rows:
    if not parts:
        return _empty_rows()
    return _Rows(*(
        np.concatenate([getattr(p, f) for p in parts])
        for f in ("e_res", "e_k2", "e_cav", "e_ctx", "e_until",
                  "u_res", "u_subj", "u_srel", "u_until")
    ))


def _until_of(exp: np.ndarray) -> np.ndarray:
    # pure int32 (NO_EXP fits): no int64 round trip on the 30M-row pass
    return np.where(exp == 0, NO_EXP, exp).astype(np.int32)


def _strictly_inc2(a: np.ndarray, b: np.ndarray) -> bool:
    """Rows strictly increasing by (a, b) — sorted AND unique."""
    if a.shape[0] < 2:
        return True
    gt = a[1:] > a[:-1]
    eq = a[1:] == a[:-1]
    return bool((gt | (eq & (b[1:] > b[:-1]))).all())


def _strictly_inc3(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> bool:
    if a.shape[0] < 2:
        return True
    gt = a[1:] > a[:-1]
    eq = a[1:] == a[:-1]
    gtb = eq & (b[1:] > b[:-1])
    eqb = eq & (b[1:] == b[:-1])
    return bool((gt | gtb | (eqb & (c[1:] > c[:-1]))).all())


def _dedup_rows(r: _Rows) -> _Rows:
    """Max-until dedup per identity: folding through multiple paths keeps
    the most permissive admissibility, exactly like the closure's
    group_max.  Sort keys pack into uint64 words for the native parallel
    radix (all components non-negative except ctx, biased by +1 — an
    order-preserving transform, so the permutation is the np.lexsort
    one); gathers apply in parallel."""
    from ..native.sort import sortperm_words, take32, take64

    if r.e_res.shape[0] and _strictly_inc2(
        r.e_res, r.e_k2
    ):
        # identity rows arriving strictly (res, k2)-sorted (a single
        # leaf's rows out of the unique-identity primary view) dedup to
        # themselves: the stable sort is the identity permutation and
        # every run has length 1 — passthrough, bit-identical
        er, ek, ec, ex, eu = r.e_res, r.e_k2, r.e_cav, r.e_ctx, r.e_until
    elif r.e_res.shape[0]:
        w2 = (r.e_cav.astype(np.uint64) << np.uint64(32)) | (
            r.e_ctx.astype(np.int64) + 1
        ).astype(np.uint64)
        o = sortperm_words(
            [r.e_res.astype(np.int64), r.e_k2, w2],
            (r.e_ctx, r.e_cav, r.e_k2, r.e_res),
        )
        er, ek = take32(r.e_res, o), take64(r.e_k2, o)
        ec, ex, eu = take32(r.e_cav, o), take32(r.e_ctx, o), take32(r.e_until, o)
        first = np.ones(er.shape[0], bool)
        first[1:] = (
            (er[1:] != er[:-1]) | (ek[1:] != ek[:-1])
            | (ec[1:] != ec[:-1]) | (ex[1:] != ex[:-1])
        )
        st = np.nonzero(first)[0]
        er, ek, ec, ex = er[first], ek[first], ec[first], ex[first]
        eu = np.maximum.reduceat(eu, st)
    else:
        er, ek, ec, ex, eu = (r.e_res,) * 5
    if r.u_res.shape[0] and _strictly_inc3(r.u_res, r.u_subj, r.u_srel):
        ur, us, ul, uu = r.u_res, r.u_subj, r.u_srel, r.u_until
    elif r.u_res.shape[0]:
        w1 = (r.u_subj.astype(np.uint64) << np.uint64(32)) | r.u_srel.astype(
            np.uint64
        )
        o = sortperm_words(
            [r.u_res.astype(np.int64), w1], (r.u_srel, r.u_subj, r.u_res)
        )
        ur, us = take32(r.u_res, o), take32(r.u_subj, o)
        ul, uu = take32(r.u_srel, o), take32(r.u_until, o)
        first = np.ones(ur.shape[0], bool)
        first[1:] = (
            (ur[1:] != ur[:-1]) | (us[1:] != us[:-1]) | (ul[1:] != ul[:-1])
        )
        st = np.nonzero(first)[0]
        ur, us, ul = ur[first], us[first], ul[first]
        uu = np.maximum.reduceat(uu, st)
    else:
        ur, us, ul, uu = (r.u_res,) * 4
    return _Rows(er, ek, ec, ex, eu, ur, us, ul, uu)


def _lift(rows: _Rows, src: np.ndarray, dst: np.ndarray,
          p_until: np.ndarray) -> _Rows:
    """Re-key ``rows`` through join pairs (src → dst): every row at
    res == dst lifts to res = src with until min'd against the pair's
    path admissibility.  Both row sets must be sorted by res."""
    out_parts: List[_Rows] = []
    if rows.e_res.shape[0] and src.shape[0]:
        reps, ii = _expand_join(rows.e_res, dst)
        if reps.shape[0]:
            out_parts.append(_Rows(
                src[reps], rows.e_k2[ii], rows.e_cav[ii], rows.e_ctx[ii],
                np.minimum(rows.e_until[ii], p_until[reps]),
                *(np.zeros(0, np.int32),) * 4,
            ))
    if rows.u_res.shape[0] and src.shape[0]:
        reps, ii = _expand_join(rows.u_res, dst)
        if reps.shape[0]:
            out_parts.append(_Rows(
                *(np.zeros(0, np.int32),) * 5,
                src[reps], rows.u_subj[ii], rows.u_srel[ii],
                np.minimum(rows.u_until[ii], p_until[reps]),
            ))
    return _concat_rows(out_parts)


def _is_sorted(a: np.ndarray) -> bool:
    return a.shape[0] < 2 or bool((a[1:] >= a[:-1]).all())


def _sorted_by_res(r: _Rows) -> _Rows:
    from ..native.sort import argsort1, take32, take64

    # leaf rows masked out of the (rel, res, ...)-sorted primary/userset
    # views arrive already res-sorted: a stable sort is then the identity
    # permutation, so returning the rows untouched is bit-identical and
    # skips two 30M-row sorts on the trivial-union fold path
    e_sorted = _is_sorted(r.e_res)
    u_sorted = _is_sorted(r.u_res)
    if e_sorted and u_sorted:
        return r
    if e_sorted:
        er, ek, ec, ex, eu = r.e_res, r.e_k2, r.e_cav, r.e_ctx, r.e_until
    else:
        oe = argsort1(r.e_res)
        er, ek = take32(r.e_res, oe), take64(r.e_k2, oe)
        ec, ex = take32(r.e_cav, oe), take32(r.e_ctx, oe)
        eu = take32(r.e_until, oe)
    if u_sorted:
        ur, us, ul, uu = r.u_res, r.u_subj, r.u_srel, r.u_until
    else:
        ou = argsort1(r.u_res)
        ur, us = take32(r.u_res, ou), take32(r.u_subj, ou)
        ul, uu = take32(r.u_srel, ou), take32(r.u_until, ou)
    return _Rows(er, ek, ec, ex, eu, ur, us, ul, uu)


@dataclass
class _Recipe:
    """The structural recipe of one folded (type, permission) — enough to
    recompute its rows for a subset of resources during incremental
    maintenance (fold_delta_update)."""

    tname: str
    tid_i: int  # interner type id
    slot: int
    #: direct leaf contributions: (type_name, relation_slot) — same type
    leaves: List[Tuple[str, int]]
    #: same-type folded-permission refs
    fold_refs: List[Tuple[str, int]]
    #: arrow contributions: (ts_slot, [("leaf"|"fold", child_type, slot)])
    arrows: List[Tuple[int, List[Tuple[str, str, int]]]]
    self_ts: Optional[int] = None


@dataclass
class FoldState:
    """Host-side base-revision inputs for O(delta) fold maintenance
    across a Watch chain (engine/flat.py build_delta_arrays →
    fold_delta_update).  Everything here is immutable along the chain:
    overlays are recomputed from (this state, accumulated delta) each
    revision.  The Leopard-style incremental-maintenance answer to the
    reference's Watch-driven re-index contract
    (client/client.go:364-413)."""

    order: List[Tuple[str, int]]  # folded pairs, topo (build) order
    recipes: Dict[Tuple[str, int], _Recipe]
    #: base leaf rows per (type_name, rel_slot), sorted by res both sides
    leaf_cache: Dict[Tuple[str, int], _Rows]
    #: base arrow rows per (type_name, ts_slot): two sorted copies
    #: (src, dst, p_until) — by dst (lift joins) and by src (subsetting)
    arrow_by_dst: Dict[Tuple[str, int], Tuple[np.ndarray, ...]]
    arrow_by_src: Dict[Tuple[str, int], Tuple[np.ndarray, ...]]
    #: base POST rows (after self-closure lift) per pair, sorted by res
    post_rows: Dict[Tuple[str, int], _Rows]
    #: base PRE rows (before self-closure lift; == post for non-self
    #: pairs) per pair, sorted by res
    pre_rows: Dict[Tuple[str, int], _Rows]
    #: self-recursive ancestor closure per pair: (src, anc, d_until)
    #: sorted by anc
    self_closure: Dict[Tuple[str, int], Tuple[np.ndarray, ...]]
    #: tupleset slots whose arrow rows any fold traverses (incl. self):
    #: deltas touching these with a caveat — or self ones at all — bail
    fold_ts_slots: frozenset
    self_ts_slots: frozenset
    #: relation slots folded as direct leaves (delta us adds with a
    #: caveat landing on one of these flip eligibility → bail)
    folded_leaf_slots: frozenset
    #: sorted permission-userset subject keys (subj·S1_raw + srel1):
    #: a delta us add whose subject key is here extends groups through a
    #: permission chain — the fold's T side can't represent it → bail
    pus_keys: np.ndarray
    itid: Dict[str, int]
    S1_raw: int
    wc_nodes: np.ndarray
    # attached by build_flat_arrays* after packing succeeds:
    maps: object = None  # flat.SlotMaps
    N: int = 0


@dataclass
class FoldResult:
    """Folded rows keyed ready for table build: pf_e identity rows and
    pf_u userset rows, both carrying the owning permission slot."""

    e_slot: np.ndarray
    e_res: np.ndarray
    e_k2: np.ndarray
    e_cav: np.ndarray
    e_ctx: np.ndarray
    e_until: np.ndarray
    u_slot: np.ndarray
    u_res: np.ndarray
    u_subj: np.ndarray
    u_srel: np.ndarray
    u_until: np.ndarray
    #: the folded (type_name, perm_slot) pairs — the kernel skips these
    #: programs when no delta level is present
    pairs: Tuple[Tuple[str, int], ...]


def _union_leaves(expr: ExprIR) -> Optional[List[ExprIR]]:
    """Flatten a union tree to its leaves; None when the tree contains
    intersection/exclusion (ineligible for folding)."""
    tag = expr[0]
    if tag == "union":
        out: List[ExprIR] = []
        for c in expr[1]:
            got = _union_leaves(c)
            if got is None:
                return None
            out.extend(got)
        return out
    if tag in ("ref", "arrow", "nil"):
        return [expr]
    return None


def fold_permissions(
    snap, config: EngineConfig, plan: DevicePlan, cl
) -> Optional[Tuple[FoldResult, FoldState]]:
    """Fold every eligible (type, permission) of the snapshot's schema.
    Returns (rows, maintenance state) or None when folding is disabled,
    inapplicable, or over budget (the walked kernel answers those worlds
    exactly as before)."""
    if not config.flat_fold or not plan.topo_programs:
        return None
    if cl.ovf_src.shape[0]:
        # overflowed closure sources make the T-side incomplete; the
        # walked path flags affected queries per site — folding can't
        return None
    compiled: CompiledSchema = snap.compiled
    S1 = snap.num_slots + 1

    # slot-granular userset eligibility, the T-index's bar: caveated /
    # permission-valued rows and rows whose group may extend through a
    # permission chain (pus) can't fold into an until-only table
    bad_us = (snap.us_caveat != 0) | (snap.us_perm != 0)
    if snap.pus_n.shape[0]:
        pus_k = np.sort(snap.pus_n.astype(np.int64) * S1 + snap.pus_r + 1)
        uk = snap.us_subj.astype(np.int64) * S1 + snap.us_srel + 1
        pos = np.clip(np.searchsorted(pus_k, uk), 0, pus_k.shape[0] - 1)
        bad_us |= pus_k[pos] == uk
    bad_rel_slots = set(np.unique(snap.us_rel[bad_us]).tolist())
    cav_ts_slots = set(np.unique(snap.ar_rel[snap.ar_caveat != 0]).tolist())

    # interner type id per schema type (node_type holds interner ids)
    itid: Dict[str, int] = {
        t: snap.interner.type_lookup(t) for t in compiled.type_ids
    }
    ntype = snap.node_type
    e_type = ntype[np.clip(snap.e_res, 0, max(snap.num_nodes - 1, 0))]
    us_type = ntype[np.clip(snap.us_res, 0, max(snap.num_nodes - 1, 0))]
    ar_type = ntype[np.clip(snap.ar_res, 0, max(snap.num_nodes - 1, 0))]
    ar_ctype = ntype[np.clip(snap.ar_child, 0, max(snap.num_nodes - 1, 0))]

    rel_leaf = frozenset(plan.rel_leaf_slots)
    budget = config.flat_fold_factor * max(
        int(snap.e_rel.shape[0] + snap.us_rel.shape[0]), 4096
    )
    spent = 0

    leaf_memo: Dict[Tuple[str, int], Optional[_Rows]] = {}

    def leaf_rows(tname: str, rel_slot: int) -> Optional[_Rows]:
        """Base leaf rows of (type, relation), sorted by res (memoized —
        the sorted copies double as the maintenance state's leaf cache)."""
        key = (tname, rel_slot)
        if key in leaf_memo:
            return leaf_memo[key]
        if rel_slot in bad_rel_slots:
            leaf_memo[key] = None
            return None
        tid = itid[tname]
        m = (snap.e_rel == rel_slot) & (e_type == tid)
        # RAW int64 identity key (subj·(num_slots+1)+srel1): internal to
        # the fold, immune to the int32 packing cliff — build_flat_arrays
        # decomposes and repacks with the dense radices
        e_k2 = snap.e_subj[m].astype(np.int64) * S1 + snap.e_srel1[m]
        mu = (snap.us_rel == rel_slot) & (us_type == tid)
        got = _sorted_by_res(_Rows(
            snap.e_res[m], e_k2, snap.e_caveat[m], snap.e_ctx[m],
            _until_of(snap.e_exp[m]),
            snap.us_res[mu], snap.us_subj[mu], snap.us_srel[mu],
            _until_of(snap.us_exp[mu]),
        ))
        leaf_memo[key] = got
        return got

    arrow_by_dst: Dict[Tuple[str, int], Tuple[np.ndarray, ...]] = {}
    arrow_by_src: Dict[Tuple[str, int], Tuple[np.ndarray, ...]] = {}

    def arrow_pairs(tname: str, ts_slot: int):
        """(src, dst, p_until) arrow rows of ``tname`` under ``ts_slot``,
        sorted by dst for _lift (memoized; a by-src copy is kept for the
        maintenance state)."""
        key = (tname, ts_slot)
        if key in arrow_by_dst:
            return arrow_by_dst[key]
        m = (snap.ar_rel == ts_slot) & (ar_type == itid[tname]) & (
            snap.ar_child >= 0
        )
        src, dst = snap.ar_res[m], snap.ar_child[m]
        p_until = _until_of(snap.ar_exp[m])
        o = np.argsort(dst, kind="stable")
        arrow_by_dst[key] = (src[o], dst[o], p_until[o])
        o2 = np.argsort(src, kind="stable")
        arrow_by_src[key] = (src[o2], dst[o2], p_until[o2])
        return arrow_by_dst[key]

    folded: Dict[Tuple[str, int], _Rows] = {}
    folded_sorted: Dict[Tuple[str, int], _Rows] = {}
    pre_sorted: Dict[Tuple[str, int], _Rows] = {}
    recipes: Dict[Tuple[str, int], _Recipe] = {}
    order: List[Tuple[str, int]] = []
    self_closures: Dict[Tuple[str, int], Tuple[np.ndarray, ...]] = {}
    name_of_slot = compiled.name_of_slot

    for (tname, tid, slot, expr) in plan.topo_programs:
        leaves = _union_leaves(expr)
        if leaves is None:
            continue
        ct = compiled.types[compiled.type_ids[tname]]
        tid_i = itid[tname]
        parts: List[_Rows] = []
        self_ts: Optional[int] = None
        rec = _Recipe(
            tname=tname, tid_i=tid_i, slot=slot,
            leaves=[], fold_refs=[], arrows=[],
        )
        ok = True
        for child in leaves:
            tag = child[0]
            if tag == "nil":
                continue
            if tag == "ref":
                # slots are per-NAME: the same slot can be a relation on
                # one type and a permission on another — resolve against
                # THIS type's definition
                s = child[1]
                sname = name_of_slot.get(s, "")
                if sname in compiled.schema.definitions[tname].relations:
                    got = leaf_rows(tname, s)
                    rec.leaves.append((tname, s))
                elif (tname, s) in folded:
                    got = folded[(tname, s)]
                    rec.fold_refs.append((tname, s))
                else:
                    got = None
                if got is None:
                    ok = False
                    break
                parts.append(got)
                continue
            # arrow
            ts_slot = plan.ts_slots[child[1]]
            right = child[2]
            if ts_slot in cav_ts_slots:
                ok = False
                break
            relation = ct.relations.get(ts_slot)
            if relation is None:
                continue  # no such tupleset on this type: contributes ∅
            if any(a.relation_slot >= 0 or a.wildcard for a in relation.allowed):
                # arrows traverse direct subjects only; userset/wildcard
                # tupleset subjects keep the walked path
                ok = False
                break
            child_types = {ct2 for a in relation.allowed
                           for ct2 in (compiled.types[a.type_id].name,)}
            if right == slot and child_types == {tname}:
                if self_ts is not None and self_ts != ts_slot:
                    ok = False  # two distinct self-recursive tuplesets
                    break
                self_ts = ts_slot
                continue
            src, dst, p_until = arrow_pairs(tname, ts_slot)
            childs: List[Tuple[str, str, int]] = []
            for c_t in sorted(child_types):
                c_has_rel = (
                    right in rel_leaf
                    and name_of_slot.get(right)
                    in compiled.schema.definitions[c_t].relations
                )
                if c_has_rel:
                    got = leaf_rows(c_t, right)
                    childs.append(("leaf", c_t, right))
                elif (c_t, right) in folded:
                    got = folded_sorted[(c_t, right)]
                    childs.append(("fold", c_t, right))
                elif compiled.schema.definitions[c_t].item(
                    name_of_slot.get(right, "")
                ) is None:
                    continue  # child type lacks the item: contributes ∅
                else:
                    got = None
                if got is None:
                    ok = False
                    break
                parts.append(_lift(got, src, dst, p_until))
            if not ok:
                break
            rec.arrows.append((ts_slot, childs))
        if not ok:
            continue
        rows = _dedup_rows(_concat_rows(parts))
        pre = rows
        if self_ts is not None:
            from .flat import _arrow_closure  # deferred: flat imports us

            built = _arrow_closure(snap, self_ts)
            if built is None:
                continue  # data cycle / over cap: keep the walked path
            c_src, c_anc, c_d, _c_p = built  # cav-free ts ⇒ d == p
            # slots are per-NAME: the closure selects by slot only, so
            # another type sharing the tupleset name contributes pairs
            # whose SOURCE is not this type — drop them, or folded grants
            # would leak onto that type's resources under this perm slot
            tm = ntype[np.clip(c_src, 0, max(snap.num_nodes - 1, 0))] == tid_i
            c_src, c_anc, c_d = c_src[tm], c_anc[tm], c_d[tm]
            o = np.argsort(c_anc, kind="stable")
            c_src, c_anc, c_d = c_src[o], c_anc[o], c_d[o]
            rows = _dedup_rows(_concat_rows([
                rows, _lift(_sorted_by_res(rows), c_src, c_anc, c_d),
            ]))
        if spent + rows.total > budget:
            continue  # over budget: this pair stays on the walked path
        spent += rows.total
        rec.self_ts = self_ts
        pair = (tname, slot)
        folded[pair] = rows
        folded_sorted[pair] = _sorted_by_res(rows)
        pre_sorted[pair] = (
            _sorted_by_res(pre) if self_ts is not None else folded_sorted[pair]
        )
        if self_ts is not None:
            self_closures[pair] = (c_src, c_anc, c_d)
        recipes[pair] = rec
        order.append(pair)

    if not folded:
        return None
    if snap.pus_n.shape[0]:
        pus_keys = np.sort(snap.pus_n.astype(np.int64) * S1 + snap.pus_r + 1)
    else:
        pus_keys = np.zeros(0, np.int64)
    state = FoldState(
        order=order,
        recipes=recipes,
        leaf_cache={k: v for k, v in leaf_memo.items() if v is not None},
        arrow_by_dst=arrow_by_dst,
        arrow_by_src=arrow_by_src,
        post_rows=folded_sorted,
        pre_rows=pre_sorted,
        self_closure=self_closures,
        fold_ts_slots=frozenset(
            {ts for r in recipes.values() for ts, _ in r.arrows}
            | {r.self_ts for r in recipes.values() if r.self_ts is not None}
        ),
        self_ts_slots=frozenset(
            r.self_ts for r in recipes.values() if r.self_ts is not None
        ),
        folded_leaf_slots=frozenset(
            s for (_t, s), v in leaf_memo.items() if v is not None
        ),
        pus_keys=pus_keys,
        itid=itid,
        S1_raw=S1,
        wc_nodes=snap.wildcard_node_of_type[
            snap.wildcard_node_of_type >= 0
        ].astype(np.int32),
    )
    pairs = tuple(sorted(folded))
    result = FoldResult(
        e_slot=np.concatenate([
            np.full(folded[p].e_res.shape[0], p[1], np.int32) for p in pairs
        ]),
        e_res=np.concatenate([folded[p].e_res for p in pairs]),
        e_k2=np.concatenate([folded[p].e_k2 for p in pairs]),
        e_cav=np.concatenate([folded[p].e_cav for p in pairs]),
        e_ctx=np.concatenate([folded[p].e_ctx for p in pairs]),
        e_until=np.concatenate([folded[p].e_until for p in pairs]),
        u_slot=np.concatenate([
            np.full(folded[p].u_res.shape[0], p[1], np.int32) for p in pairs
        ]),
        u_res=np.concatenate([folded[p].u_res for p in pairs]),
        u_subj=np.concatenate([folded[p].u_subj for p in pairs]),
        u_srel=np.concatenate([folded[p].u_srel for p in pairs]),
        u_until=np.concatenate([folded[p].u_until for p in pairs]),
        pairs=pairs,
    )
    return result, state


# ---------------------------------------------------------------------------
# incremental maintenance: Watch-delta overlays over a folded base
# ---------------------------------------------------------------------------


def _rows_at(rows: _Rows, S: np.ndarray) -> _Rows:
    """``rows`` (res-sorted on both planes) restricted to res ∈ S
    (sorted unique).  Output stays res-sorted."""
    _, ie = _expand_join(rows.e_res, S)
    _, iu = _expand_join(rows.u_res, S)
    return _Rows(
        rows.e_res[ie], rows.e_k2[ie], rows.e_cav[ie], rows.e_ctx[ie],
        rows.e_until[ie],
        rows.u_res[iu], rows.u_subj[iu], rows.u_srel[iu], rows.u_until[iu],
    )


def _in_sorted(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    if sorted_keys.shape[0] == 0 or keys.shape[0] == 0:
        return np.zeros(keys.shape[0], bool)
    pos = np.clip(
        np.searchsorted(sorted_keys, keys), 0, sorted_keys.shape[0] - 1
    )
    return sorted_keys[pos] == keys


def _ident(state: FoldState, rel_slot: int, res, subj, srel1) -> np.ndarray:
    """Primary-row identity packed EXACTLY like the accumulated delta's
    tombstone keys (flat._acc_collapse.pack): dense (k1 << 31) | k2."""
    from .flat import _m_srel1  # deferred: flat imports us

    maps = state.maps
    k1 = np.int64(maps.k1[rel_slot]) * state.N + res.astype(np.int64)
    k2 = subj.astype(np.int64) * maps.S1 + _m_srel1(
        maps, np.asarray(srel1, np.int64).astype(np.int32)
    ).astype(np.int64)
    return (k1 << np.int64(31)) | k2


def _cur_leaf(
    state: FoldState, acc, node_type: np.ndarray, tname: str, rel_slot: int,
    S: np.ndarray,
) -> _Rows:
    """CURRENT (base − tombstones ∪ adds) leaf rows of (type, relation)
    at res ∈ S, res-sorted.  Upserted identities are sound because every
    touched identity is in the tombstone set (flat._acc_collapse)."""
    S1r = state.S1_raw
    g_sorted = acc["a_g_key_sorted"]
    parts: List[_Rows] = []
    base = state.leaf_cache.get((tname, rel_slot))
    if base is not None and base.total:
        sub = _rows_at(base, S)
        me = np.ones(sub.e_res.shape[0], bool)
        mu = np.ones(sub.u_res.shape[0], bool)
        if g_sorted.shape[0]:
            if sub.e_res.shape[0]:
                me = ~_in_sorted(g_sorted, _ident(
                    state, rel_slot, sub.e_res,
                    sub.e_k2 // S1r, sub.e_k2 % S1r,
                ))
            if sub.u_res.shape[0]:
                mu = ~_in_sorted(g_sorted, _ident(
                    state, rel_slot, sub.u_res, sub.u_subj, sub.u_srel + 1,
                ))
        parts.append(_Rows(
            sub.e_res[me], sub.e_k2[me], sub.e_cav[me], sub.e_ctx[me],
            sub.e_until[me],
            sub.u_res[mu], sub.u_subj[mu], sub.u_srel[mu], sub.u_until[mu],
        ))
    tid = state.itid[tname]
    rtypes = node_type[np.clip(acc["a_res"], 0, node_type.shape[0] - 1)]
    m = (
        (acc["a_rel"] == rel_slot) & (rtypes == tid)
        & np.isin(acc["a_res"], S)
    )
    if m.any():
        res = acc["a_res"][m]
        subj = acc["a_subj"][m]
        srel1 = acc["a_srel1"][m]
        until = _until_of(acc["a_exp"][m])
        mu = srel1 > 0
        parts.append(_Rows(
            res, subj.astype(np.int64) * S1r + srel1,
            acc["a_cav"][m], acc["a_ctx"][m], until,
            res[mu], subj[mu], (srel1[mu] - 1).astype(np.int32), until[mu],
        ))
    return _sorted_by_res(_concat_rows(parts))


def _cur_arrows(
    state: FoldState, acc, node_type: np.ndarray, tname: str, ts_slot: int,
    S: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CURRENT arrow rows (src, dst, p_until) of (type, ts) with
    src ∈ S, sorted by dst (the _lift join order)."""
    g_sorted = acc["a_g_key_sorted"]
    base = state.arrow_by_src.get((tname, ts_slot))
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    pus: List[np.ndarray] = []
    if base is not None and base[0].shape[0]:
        _, ii = _expand_join(base[0], S)
        src, dst, pu = base[0][ii], base[1][ii], base[2][ii]
        if g_sorted.shape[0] and src.shape[0]:
            keep = ~_in_sorted(g_sorted, _ident(
                state, ts_slot, src, dst, np.zeros(src.shape[0], np.int32)
            ))
            src, dst, pu = src[keep], dst[keep], pu[keep]
        srcs.append(src); dsts.append(dst); pus.append(pu)
    tid = state.itid[tname]
    rtypes = node_type[np.clip(acc["a_res"], 0, node_type.shape[0] - 1)]
    m = (
        (acc["a_rel"] == ts_slot) & (acc["a_srel1"] == 0) & (rtypes == tid)
        & np.isin(acc["a_res"], S) & (acc["a_subj"] >= 0)
    )
    if m.any():
        srcs.append(acc["a_res"][m])
        dsts.append(acc["a_subj"][m])
        pus.append(_until_of(acc["a_exp"][m]))
    if not srcs:
        z = np.zeros(0, np.int32)
        return z, z, z
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    pu = np.concatenate(pus)
    o = np.argsort(dst, kind="stable")
    return src[o], dst[o], pu[o]


def _cur_pair_rows(
    state: FoldState, pair: Tuple[str, int], new_rows: Dict, D: Dict,
    S: np.ndarray, *, pre: bool,
) -> _Rows:
    """CURRENT pre- or post-rows of an already-maintained folded pair at
    res ∈ S: base rows where unaffected, recomputed rows where dirty."""
    base = (state.pre_rows if pre else state.post_rows)[pair]
    Dp = D[pair]
    inD = np.isin(S, Dp)
    return _sorted_by_res(_concat_rows([
        _rows_at(base, S[~inD]),
        _rows_at(new_rows[pair], S[inD]),
    ]))


def fold_delta_update(
    state: FoldState, acc, node_type: np.ndarray, config: EngineConfig
) -> Optional[Tuple[np.ndarray, Optional[FoldResult]]]:
    """O(delta) incremental fold maintenance: from the base-revision
    FoldState and the chain's accumulated delta, compute (a) the DIRTY
    key set — packed (slot·N + res) whose base pf answers must be
    voided — and (b) replacement rows for exactly those resources,
    recomputed against current (base − tombstones ∪ adds) data in the
    same recipe/topo order the base fold ran.  Deletions are exact by
    construction (affected resources are recomputed wholesale, so no
    derivation counting is needed — the subset-recompute answer to
    Leopard's incremental index maintenance).

    Returns None on any condition the subset recompute cannot keep
    sound/cheap: structural edits to a self-recursive tupleset (the
    ancestor closure would shift), eligibility flips (caveated
    arrow/userset delta rows, pus-extending subjects), or a dirty set
    past the cap.  The caller (flat.build_delta_arrays) then DOWNGRADES
    the chain — sticky pf_off, folded pairs walk with the dl_* overlays
    until compaction re-folds the base — it does not force a rebuild."""
    a_rel, a_res = acc["a_rel"], acc["a_res"]
    a_subj, a_srel1 = acc["a_subj"], acc["a_srel1"]
    g_rel, g_res, g_srel1 = acc["g_rel"], acc["g_res"], acc["g_srel1"]
    all_rel = np.concatenate([a_rel, g_rel])
    all_res = np.concatenate([a_res, g_res])
    all_srel1 = np.concatenate([a_srel1, g_srel1])
    if all_rel.shape[0] == 0:
        return np.zeros(0, np.int32), None

    # -- eligibility bails -------------------------------------------------
    if state.self_ts_slots:
        st = np.asarray(sorted(state.self_ts_slots), np.int64)
        if np.isin(all_rel, st).any():
            return None  # ancestor closure would shift: rebuild
    if state.fold_ts_slots:
        ft = np.asarray(sorted(state.fold_ts_slots), np.int64)
        m = np.isin(a_rel, ft) & (a_srel1 == 0)
        if m.any() and acc["a_cav"][m].any():
            return None  # fold arrows must stay caveat-free
    if state.folded_leaf_slots:
        fl = np.asarray(sorted(state.folded_leaf_slots), np.int64)
        m = np.isin(a_rel, fl) & (a_srel1 > 0)
        if m.any():
            if acc["a_cav"][m].any():
                return None  # caveated userset row flips leaf eligibility
            if state.pus_keys.shape[0]:
                sk = (
                    a_subj[m].astype(np.int64) * state.S1_raw + a_srel1[m]
                )
                if _in_sorted(state.pus_keys, sk).any():
                    return None  # group extends through a permission chain

    # sorted tombstone keys for the current-row extractors
    acc = dict(acc)
    acc["a_g_key_sorted"] = acc["g_key"]  # maintained sorted by collapse

    rtypes = node_type[np.clip(all_res, 0, node_type.shape[0] - 1)]

    # -- affected resource sets, pair by pair in base fold order ----------
    D_pre: Dict[Tuple[str, int], np.ndarray] = {}
    D_post: Dict[Tuple[str, int], np.ndarray] = {}
    total_dirty = 0
    for pair in state.order:
        rec = state.recipes[pair]
        ds: List[np.ndarray] = []
        for (lt, lslot) in rec.leaves:
            ds.append(all_res[(all_rel == lslot) & (rtypes == rec.tid_i)])
        for ref_pair in rec.fold_refs:
            ds.append(D_post[ref_pair])
        for (ts_slot, childs) in rec.arrows:
            ds.append(all_res[
                (all_rel == ts_slot) & (all_srel1 == 0)
                & (rtypes == rec.tid_i)
            ])
            bd = state.arrow_by_dst.get((rec.tname, ts_slot))
            if bd is None or bd[0].shape[0] == 0:
                continue
            for (kind, c_t, c_slot) in childs:
                if kind == "leaf":
                    c_tid = state.itid[c_t]
                    touched = np.unique(all_res[
                        (all_rel == c_slot) & (rtypes == c_tid)
                    ])
                else:
                    touched = D_post[(c_t, c_slot)]
                if touched.shape[0]:
                    _, ii = _expand_join(bd[1], touched)
                    ds.append(bd[0][ii])
        Dp = (
            np.unique(np.concatenate(ds).astype(np.int32))
            if ds else np.zeros(0, np.int32)
        )
        D_pre[pair] = Dp
        if rec.self_ts is not None and Dp.shape[0]:
            c_src, c_anc, _c_d = state.self_closure[pair]
            _, ii = _expand_join(c_anc, Dp)
            Dp2 = np.unique(np.concatenate([Dp, c_src[ii]]))
        else:
            Dp2 = Dp
        D_post[pair] = Dp2
        total_dirty += int(Dp2.shape[0])
        if total_dirty > config.flat_fold_delta_dirty_cap:
            return None  # hot-ancestor touch: downgrade to the walk

    if total_dirty == 0:
        return np.zeros(0, np.int32), None

    # -- subset refold against current data -------------------------------
    new_pre: Dict[Tuple[str, int], _Rows] = {}
    new_post: Dict[Tuple[str, int], _Rows] = {}
    total_rows = 0
    row_cap = max(config.flat_delta_min_compact, 4 * total_dirty)
    for pair in state.order:
        rec = state.recipes[pair]
        S = D_post[pair]
        if S.shape[0] == 0:
            new_pre[pair] = new_post[pair] = _empty_rows()
            continue
        parts: List[_Rows] = []
        for (lt, lslot) in rec.leaves:
            parts.append(_cur_leaf(state, acc, node_type, lt, lslot, S))
        for ref_pair in rec.fold_refs:
            parts.append(_cur_pair_rows(
                state, ref_pair, new_post, D_post, S, pre=False
            ))
        for (ts_slot, childs) in rec.arrows:
            src, dst, pu = _cur_arrows(
                state, acc, node_type, rec.tname, ts_slot, S
            )
            if src.shape[0] == 0:
                continue
            dsts = np.unique(dst)
            for (kind, c_t, c_slot) in childs:
                if kind == "leaf":
                    got = _cur_leaf(state, acc, node_type, c_t, c_slot, dsts)
                else:
                    got = _cur_pair_rows(
                        state, (c_t, c_slot), new_post, D_post, dsts,
                        pre=False,
                    )
                parts.append(_lift(got, src, dst, pu))
        pre = _sorted_by_res(_dedup_rows(_concat_rows(parts)))
        new_pre[pair] = pre
        if rec.self_ts is not None:
            c_src, c_anc, c_d = state.self_closure[pair]
            keep = np.isin(c_src, S)
            cs, ca, cd = c_src[keep], c_anc[keep], c_d[keep]
            ancs = np.unique(ca)
            pre_at_anc = _cur_pair_rows(
                state, pair, new_pre, D_pre, ancs, pre=True
            )
            post = _sorted_by_res(_dedup_rows(_concat_rows([
                pre, _lift(pre_at_anc, cs, ca, cd),
            ])))
        else:
            post = pre
        new_post[pair] = post
        total_rows += post.total
        if total_rows > row_cap:
            return None  # overlay would rival the base: downgrade

    # -- outputs: dirty keys + replacement rows ---------------------------
    maps, N = state.maps, state.N
    dirty_k1 = np.concatenate([
        (np.int64(maps.k1[p[1]]) * N + D_post[p].astype(np.int64)).astype(
            np.int32
        )
        for p in state.order
    ])
    pairs = tuple(sorted(p for p in state.order if new_post[p].total))
    if not pairs:
        return dirty_k1, None
    ovl = FoldResult(
        e_slot=np.concatenate([
            np.full(new_post[p].e_res.shape[0], p[1], np.int32)
            for p in pairs
        ]),
        e_res=np.concatenate([new_post[p].e_res for p in pairs]),
        e_k2=np.concatenate([new_post[p].e_k2 for p in pairs]),
        e_cav=np.concatenate([new_post[p].e_cav for p in pairs]),
        e_ctx=np.concatenate([new_post[p].e_ctx for p in pairs]),
        e_until=np.concatenate([new_post[p].e_until for p in pairs]),
        u_slot=np.concatenate([
            np.full(new_post[p].u_res.shape[0], p[1], np.int32)
            for p in pairs
        ]),
        u_res=np.concatenate([new_post[p].u_res for p in pairs]),
        u_subj=np.concatenate([new_post[p].u_subj for p in pairs]),
        u_srel=np.concatenate([new_post[p].u_srel for p in pairs]),
        u_until=np.concatenate([new_post[p].u_until for p in pairs]),
        pairs=pairs,
    )
    return dirty_k1, ovl


def t_join_core(
    k1: np.ndarray, pe: np.ndarray, w: np.ndarray,
    cl_k1: np.ndarray, cl_k2: np.ndarray,
    c_d: np.ndarray, c_p: np.ndarray, cap_rows: int,
) -> Optional[Tuple[np.ndarray, ...]]:
    """The T-index join shared by the base table (flat.py _tindex_join)
    and (historically) the fold: userset entries (k1, group-key pe,
    until w) ⋈ closure-by-target, plus the direct group-identity entries,
    deduped max-per-plane.  Sizes the join BEFORE materializing it;
    returns None past ``cap_rows`` (a popular group with a huge closure
    in-degree must disable the index, not OOM).

    A prepare calls this join whatever ``EngineConfig.spmm`` says;
    engine/spmm.py's ``tjoin_spmm`` is the same join expressed on the
    generic (min, max) until-semiring product, held to this one byte for
    byte (tests/test_torch_spmm.py)."""
    t_order = np.argsort(cl_k2, kind="stable")
    tgt_sorted = cl_k2[t_order]
    join_rows = int(
        (
            np.searchsorted(tgt_sorted, pe, "right")
            - np.searchsorted(tgt_sorted, pe, "left")
        ).sum()
    )
    if join_rows + pe.shape[0] > cap_rows:
        return None
    reps, ii = _expand_join(tgt_sorted, pe)
    jj = t_order[ii]
    T_k1 = np.concatenate([k1, k1[reps]])
    T_k2 = np.concatenate([pe, cl_k1[jj]])
    T_d = np.concatenate([w, np.minimum(w[reps], c_d[jj])])
    T_p = np.concatenate([w, np.minimum(w[reps], c_p[jj])])
    # the native radix sort over the int32-packed keys (np.lexsort's
    # order): config 3's join holds ~10^8 rows, where np.lexsort was the
    # largest single step of a prepare
    o2 = lexsort2(T_k1, T_k2)
    T_k1, T_k2, T_d, T_p = T_k1[o2], T_k2[o2], T_d[o2], T_p[o2]
    first = np.ones(T_k1.shape[0], bool)
    first[1:] = (T_k1[1:] != T_k1[:-1]) | (T_k2[1:] != T_k2[:-1])
    st = np.nonzero(first)[0]
    return (
        T_k1[first], T_k2[first],
        np.maximum.reduceat(T_d, st), np.maximum.reduceat(T_p, st),
    )


def fold_userset_rows(fr: FoldResult, N: int, maps
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pf_u: the folded userset rows packed with the DENSE radices
    (``maps`` is flat.SlotMaps), sorted by their (slot·N + res) group key.

    This is the REACHABILITY-PRUNED replacement for the round-5 dense
    fold T-join (u rows ⋈ closure-by-target), which materialized the full
    (resource × member) product — 268M rows at BASELINE config 3, where
    every document repeats its ancestor chain's group closures.  The
    factored form stores only the reachable (resource, group) pairs
    (the Leapfrog-style key intersection: iterate the keys both sides
    share, never the cross product) and the kernel intersects with the
    member closure at probe time — one bounded-fan range slice plus one
    closure probe per candidate group, independent of nesting depth.
    Factoring through the closure also makes the fold's tables
    independent of the membership closure, which is what lets membership
    deltas advance the closure in place without re-folding anything
    (store/closure.py advance_closure)."""
    k1 = (
        maps.k1[fr.u_slot].astype(np.int64) * N + fr.u_res
    ).astype(np.int32)
    gk = (
        fr.u_subj.astype(np.int64) * maps.S1 + maps.k2[fr.u_srel] + 1
    ).astype(np.int32)
    order = np.argsort(k1, kind="stable")
    return k1[order], gk[order], fr.u_until[order]
