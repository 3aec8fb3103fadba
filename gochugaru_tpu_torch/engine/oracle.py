"""The host oracle: exact SpiceDB check semantics in plain Python.

Permissionship is three-valued, exactly as SpiceDB's
HAS_PERMISSION / NO_PERMISSION / CONDITIONAL (SURVEY.md §7 "hard parts"):
``T`` definite grant, ``F`` definite no, ``U`` conditional on caveat
context that wasn't provided.  Kleene logic combines them (OR = max,
AND = min, NOT = flip), and the engine collapses U → False only at the
client API boundary, mirroring where the reference collapses
Permissionship to bool (client/client.go:277).

Semantics implemented (spec: SURVEY.md §2.6):
- direct, wildcard (``user:*``), and userset (``group#member``) subjects,
  with self-identity (``X#r`` is always a member of itself);
- permissions as rewrite trees: union/intersection/exclusion, ``nil``,
  arrows (tupleset traversal over direct subjects);
- caveats: stored context merged over query context (stored wins),
  missing parameters → conditional;
- expiration: expired edges grant nothing (rel/relationship.go:43-45);
- recursion (nested groups, recursive folders) via in-progress cycle
  detection → least fixpoint;
- checks on nonexistent resources/relations return F, never an error
  (client/client_test.go:209-215).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Set, Tuple

from ..caveats import UNKNOWN, CelProgram
from ..rel.relationship import Relationship, WILDCARD_ID, expiration_micros
from ..schema.ast import (
    Arrow,
    Exclusion,
    Expr,
    Intersection,
    Nil,
    RelationRef,
    Union,
)
from ..schema.compiler import CompiledSchema

# Tri-state permissionship encoding.
F, U, T = 0, 1, 2


class PermTri:
    FALSE = F
    CONDITIONAL = U
    TRUE = T


@dataclass(frozen=True)
class _Edge:
    subject_type: str
    subject_id: str
    subject_relation: str
    caveat_name: str
    caveat_context: Mapping[str, Any]
    expires_us: int  # 0 = none


def _to_micros(r: Relationship) -> int:
    return expiration_micros(r.expiration) if r.has_expiration() else 0


class Oracle:
    """Reference evaluator over a fixed set of relationships."""

    def __init__(
        self,
        compiled: CompiledSchema,
        relationships: Iterable[Relationship],
        caveat_programs: Optional[Mapping[str, CelProgram]] = None,
        *,
        now_us: Optional[int] = None,
    ) -> None:
        self.compiled = compiled
        self.schema = compiled.schema
        self.caveat_programs = dict(caveat_programs or {})
        #: pinned evaluation time; None = wall clock at each call (an Oracle
        #: is cached per revision, so liveness must not freeze at build time)
        self.now_us = now_us
        # (rtype, rid, relation) → edges
        self._by_onr: Dict[Tuple[str, str, str], List[_Edge]] = {}
        # candidate object ids per type (resources with any tuple)
        self._objects_of_type: Dict[str, Set[str]] = {}
        self._subjects_of_type: Dict[str, Set[str]] = {}
        for r in relationships:
            self._by_onr.setdefault(
                (r.resource_type, r.resource_id, r.resource_relation), []
            ).append(
                _Edge(
                    r.subject_type,
                    r.subject_id,
                    r.subject_relation,
                    r.caveat_name,
                    r.caveat_context,
                    _to_micros(r),
                )
            )
            self._objects_of_type.setdefault(r.resource_type, set()).add(r.resource_id)
            self._subjects_of_type.setdefault(r.subject_type, set()).add(r.subject_id)

    # ------------------------------------------------------------------
    # data access — overridable so SnapshotOracle can lazily binary-search
    # sorted snapshot columns instead of prebuilding O(E) dicts
    def _edges_of(self, rtype: str, rid: str, relation: str) -> Iterable[_Edge]:
        return self._by_onr.get((rtype, rid, relation), ())

    def _object_ids(self, type_name: str) -> Iterable[str]:
        return sorted(self._objects_of_type.get(type_name, ()))

    def _subject_ids(self, type_name: str) -> Iterable[str]:
        return sorted(self._subjects_of_type.get(type_name, ()))

    # ------------------------------------------------------------------
    def _now_us(self) -> int:
        return self.now_us if self.now_us is not None else int(time.time() * 1_000_000)

    def _edge_gate(self, e: _Edge, query_ctx: Mapping[str, Any], now_us: int) -> int:
        """Tri-state admissibility of one edge: expiry mask and caveat."""
        if e.expires_us and e.expires_us <= now_us:
            return F
        if not e.caveat_name:
            return T
        prog = self.caveat_programs.get(e.caveat_name)
        if prog is None:
            # declared but uncompiled caveat — treat as conditional
            return U
        merged = dict(query_ctx)
        merged.update(e.caveat_context)  # stored context takes precedence
        result = prog.evaluate(merged)
        if result is UNKNOWN:
            return U
        return T if result else F

    def _edge_gate_explain(
        self, e: _Edge, query_ctx: Mapping[str, Any], now_us: int
    ):
        """``_edge_gate`` with the WHY: (gate, detail dict or None) — the
        expiry stamp that killed the edge, the caveat name, the merged
        context values that gated it, and the tri-state outcome.  Runs
        only under an explain recorder (engine/explain.py); the hot
        fallback path stays on ``_edge_gate``.  The two MUST agree —
        every return mirrors a ``_edge_gate`` return line-for-line."""
        detail: Dict[str, Any] = {}
        if e.expires_us:
            detail["expires_us"] = e.expires_us
            if e.expires_us <= now_us:
                detail["expired"] = True
                return F, detail
        if not e.caveat_name:
            return T, (detail or None)
        detail["caveat"] = e.caveat_name
        prog = self.caveat_programs.get(e.caveat_name)
        if prog is None:
            detail["caveat_result"] = "uncompiled"
            return U, detail
        merged = dict(query_ctx)
        merged.update(e.caveat_context)
        detail["context"] = dict(merged)
        result = prog.evaluate(merged)
        if result is UNKNOWN:
            detail["caveat_result"] = "missing_context"
            return U, detail
        detail["caveat_result"] = bool(result)
        return (T if result else F), detail

    # ------------------------------------------------------------------
    def check(
        self,
        resource_type: str,
        resource_id: str,
        permission: str,
        subject_type: str,
        subject_id: str,
        subject_relation: str = "",
        context: Optional[Mapping[str, Any]] = None,
        now_us: Optional[int] = None,
        *,
        recorder=None,
        seed_branch: Optional[str] = None,
    ) -> int:
        """Tri-state check of one (resource, permission, subject).
        ``now_us`` pins the evaluation time for this call (cursor-pinned
        lookup re-checks); None keeps the oracle's own clock.

        ``recorder`` (engine/explain.py Recorder, duck-typed: push/pop/
        leaf) instruments THIS walker into a typed resolution tree —
        membership/userset/arrow steps, caveat evaluations with the
        merged context that gated them, expiry gates, wildcard grants,
        cycle cuts, and (for denials) every explored-and-exhausted edge.
        With ``recorder=None`` every hook is one ``is not None`` branch:
        the hot fallback path is unchanged.

        ``seed_branch`` ("direct" | "wildcard" | "userset") reorders the
        ROOT relation's edge iteration to try the named class first —
        the device witness seeds the walk toward the branch the kernel
        already proved won.  Sound by construction: relation evaluation
        is a short-circuited max over edges, and max is commutative, so
        reordering can only change WHICH winning path the tree shows,
        never the verdict."""
        memo: Dict[Tuple[str, str, str], int] = {}
        in_progress: Set[Tuple[str, str, str]] = set()
        # Keys that were returned as F because they were in progress (cycle
        # cuts).  A value computed while its subtree hit a cut on a node
        # still being evaluated is provisional and must NOT be memoized —
        # caching it would freeze the cycle's least-fixpoint seed as the
        # final answer for siblings outside the cycle.
        cut_hits: Set[Tuple[str, str, str]] = set()
        ctx = context or {}
        if now_us is None:
            now_us = self._now_us()
        subject = (subject_type, subject_id, subject_relation)
        rec = recorder
        root_key = (resource_type, resource_id, permission)

        def gate_of(e: _Edge):
            """(gate, detail) — detail only under a recorder."""
            if rec is None:
                return self._edge_gate(e, ctx, now_us), None
            return self._edge_gate_explain(e, ctx, now_us)

        def subj_str(t: str, i: str, r: str) -> str:
            return f"{t}:{i}#{r}" if r else f"{t}:{i}"

        def eval_item(rtype: str, rid: str, item: str) -> int:
            if (rtype, rid, item) == subject:
                if rec is not None:
                    rec.leaf("self", T, resource=f"{rtype}:{rid}", item=item)
                return T  # a userset is always a member of itself
            d = self.schema.definitions.get(rtype)
            if d is None:
                if rec is not None:
                    rec.leaf("missing_type", F, resource=f"{rtype}:{rid}",
                             item=item)
                return F
            key = (rtype, rid, item)
            if key in memo:
                if rec is not None:
                    rec.leaf("memoized", memo[key],
                             resource=f"{rtype}:{rid}", item=item)
                return memo[key]
            if key in in_progress:
                cut_hits.add(key)
                if rec is not None:
                    rec.leaf("cycle_cut", F, resource=f"{rtype}:{rid}",
                             item=item)
                return F  # least fixpoint on recursion
            in_progress.add(key)
            if rec is not None:
                rec.push(
                    "relation" if item in d.relations else (
                        "permission" if item in d.permissions else "missing"
                    ),
                    resource=f"{rtype}:{rid}", item=item,
                )
            out = F
            try:
                if item in d.relations:
                    out = eval_relation(rtype, rid, item)
                elif item in d.permissions:
                    out = eval_expr(rtype, rid, d.permissions[item].expr)
                else:
                    out = F
            finally:
                in_progress.discard(key)
                if rec is not None:
                    rec.pop(out)
            cut_hits.discard(key)  # cuts to this node are resolved by `out`
            if not (cut_hits & in_progress):
                memo[key] = out
            return out

        def eval_relation(rtype: str, rid: str, relation: str) -> int:
            out = F
            edges = self._edges_of(rtype, rid, relation)
            if seed_branch is not None and (rtype, rid) == root_key[:2]:
                # witness-seeded walk: stable-sort the ROOT RESOURCE's
                # relation edges (the checked relation itself, or the
                # leaf relations its permission program references) so
                # the class the device kernel proved winning is explored
                # first (short-circuit lands on it)
                def _cls(e: _Edge) -> int:
                    if e.subject_relation:
                        mine = seed_branch == "userset"
                    elif e.subject_id == WILDCARD_ID:
                        mine = seed_branch == "wildcard"
                    else:
                        mine = seed_branch == "direct"
                    return 0 if mine else 1

                edges = sorted(edges, key=_cls)
            skipped = 0
            for e in edges:
                if rec is None and e.subject_relation == "" \
                        and e.subject_id != WILDCARD_ID \
                        and (e.subject_type, e.subject_id, "") != subject:
                    continue  # cheap pre-skip of non-matching direct edges
                gate, gd = gate_of(e)
                if e.subject_relation == "":
                    if e.subject_id == WILDCARD_ID:
                        # wildcard grants any direct subject of the type
                        if gate != F and subject_relation == "" \
                                and e.subject_type == subject_type \
                                and subject_id != WILDCARD_ID:
                            if rec is not None:
                                rec.leaf(
                                    "wildcard", gate,
                                    subject=f"{e.subject_type}:*",
                                    gate=gd,
                                )
                            out = max(out, gate)
                        elif gate != F and (
                            e.subject_type, e.subject_id, ""
                        ) == subject:
                            if rec is not None:
                                rec.leaf(
                                    "direct", gate,
                                    subject=f"{e.subject_type}:*",
                                    gate=gd,
                                )
                            out = max(out, gate)  # checking the wildcard itself
                        elif rec is not None and gate == F:
                            rec.leaf("wildcard", F,
                                     subject=f"{e.subject_type}:*", gate=gd)
                    elif (e.subject_type, e.subject_id, "") == subject:
                        if rec is not None:
                            rec.leaf(
                                "direct", gate,
                                subject=subj_str(e.subject_type,
                                                 e.subject_id, ""),
                                gate=gd,
                            )
                        out = max(out, gate)
                    else:
                        skipped += 1  # direct edge for another subject
                else:
                    if gate == F:
                        if rec is not None:
                            rec.leaf(
                                "userset", F,
                                subject=subj_str(
                                    e.subject_type, e.subject_id,
                                    e.subject_relation,
                                ),
                                gate=gd,
                            )
                        continue
                    if rec is not None:
                        rec.push(
                            "userset",
                            subject=subj_str(e.subject_type, e.subject_id,
                                             e.subject_relation),
                            gate=gd,
                        )
                    sub = eval_item(e.subject_type, e.subject_id,
                                    e.subject_relation)
                    if rec is not None:
                        rec.pop(min(gate, sub))
                    out = max(out, min(gate, sub))
                if out == T:
                    if rec is not None and skipped:
                        rec.set("edges_skipped", skipped)
                    return T
            if rec is not None and skipped:
                rec.set("edges_skipped", skipped)
            return out

        def eval_expr(rtype: str, rid: str, expr: Expr) -> int:
            if isinstance(expr, RelationRef):
                return eval_item(rtype, rid, expr.name)
            if isinstance(expr, Nil):
                if rec is not None:
                    rec.leaf("nil", F)
                return F
            if isinstance(expr, Arrow):
                if rec is not None:
                    rec.push("arrow", left=expr.left, right=expr.right,
                             resource=f"{rtype}:{rid}")
                out = F
                try:
                    for e in self._edges_of(rtype, rid, expr.left):
                        if e.subject_relation != "" or e.subject_id == WILDCARD_ID:
                            continue  # arrows traverse direct (ellipsis) subjects
                        gate, gd = gate_of(e)
                        if gate == F:
                            if rec is not None:
                                rec.leaf(
                                    "arrow_edge", F,
                                    via=subj_str(e.subject_type,
                                                 e.subject_id, ""),
                                    gate=gd,
                                )
                            continue
                        sub_def = self.schema.definitions.get(e.subject_type)
                        if sub_def is None or sub_def.item(expr.right) is None:
                            continue
                        if rec is not None:
                            rec.push(
                                "arrow_edge",
                                via=subj_str(e.subject_type, e.subject_id, ""),
                                gate=gd,
                            )
                        sub = eval_item(e.subject_type, e.subject_id, expr.right)
                        if rec is not None:
                            rec.pop(min(gate, sub))
                        out = max(out, min(gate, sub))
                        if out == T:
                            return T
                    return out
                finally:
                    if rec is not None:
                        rec.pop(out)
            if isinstance(expr, Union):
                if rec is not None:
                    rec.push("union")
                out = F
                try:
                    for c in expr.children:
                        out = max(out, eval_expr(rtype, rid, c))
                        if out == T:
                            return T
                    return out
                finally:
                    if rec is not None:
                        rec.pop(out)
            if isinstance(expr, Intersection):
                if rec is not None:
                    rec.push("intersection")
                out = T
                try:
                    for c in expr.children:
                        out = min(out, eval_expr(rtype, rid, c))
                        if out == F:
                            return F
                    return out
                finally:
                    if rec is not None:
                        rec.pop(out)
            if isinstance(expr, Exclusion):
                if rec is not None:
                    rec.push("exclusion")
                out = F
                try:
                    base = eval_expr(rtype, rid, expr.base)
                    if base == F:
                        return F
                    sub = eval_expr(rtype, rid, expr.subtracted)
                    out = min(base, 2 - sub)
                    return out
                finally:
                    if rec is not None:
                        rec.pop(out)
            raise TypeError(f"unknown expression node {expr!r}")

        return eval_item(resource_type, resource_id, permission)

    def check_relationship(
        self, r: Relationship, context: Optional[Mapping[str, Any]] = None,
        *, now_us: Optional[int] = None, recorder=None,
        seed_branch: Optional[str] = None,
    ) -> int:
        """Check where the query is phrased as a relationship, as the whole
        Check family does (client/client.go:238-259): resource_relation is
        the permission, caveat_context is the request context.
        ``recorder``/``seed_branch`` thread through to the instrumented
        walk (engine/explain.py)."""
        ctx = dict(context or {})
        if r.caveat_context:
            ctx.update(r.caveat_context)
        return self.check(
            r.resource_type,
            r.resource_id,
            r.resource_relation,
            r.subject_type,
            r.subject_id,
            r.subject_relation,
            ctx,
            now_us=now_us,
            recorder=recorder,
            seed_branch=seed_branch,
        )

    # ------------------------------------------------------------------
    def lookup_resources(
        self,
        resource_type: str,
        permission: str,
        subject_type: str,
        subject_id: str,
        subject_relation: str = "",
        context: Optional[Mapping[str, Any]] = None,
    ) -> Iterator[str]:
        """Stream ids of resources of ``resource_type`` on which the subject
        has the permission definitively (client/client.go:501-552).
        Conditional results are omitted, matching the bool collapse at the
        client layer."""
        for rid in self._object_ids(resource_type):
            if (
                self.check(
                    resource_type, rid, permission,
                    subject_type, subject_id, subject_relation, context,
                )
                == T
            ):
                yield rid

    def lookup_subjects(
        self,
        resource_type: str,
        resource_id: str,
        permission: str,
        subject_type: str,
        subject_relation: str = "",
        context: Optional[Mapping[str, Any]] = None,
    ) -> Iterator[str]:
        """Stream ids of subjects of ``subject_type`` holding the permission
        on the resource (client/client.go:554-599)."""
        for sid in self._subject_ids(subject_type):
            if (
                self.check(
                    resource_type, resource_id, permission,
                    subject_type, sid, subject_relation, context,
                )
                == T
            ):
                yield sid


class SnapshotOracle(Oracle):
    """An Oracle backed directly by a Snapshot's sorted int32 columns.

    Construction is O(1) — no edge iteration, no prebuilt dicts (round-1
    Weak #3: building the fallback oracle was O(E) Python per revision,
    which stalls the first conditional check for minutes at 100M edges).
    ``_edges_of`` binary-searches the primary (rel, res, subj, srel1)
    view per (resource, relation) and memoizes the decoded group, so a
    fallback check costs O(log E + touched edges), matching SURVEY §7's
    "host-fallback split keeps p99 < 2 ms".
    """

    def __init__(
        self,
        snapshot,
        caveat_programs: Optional[Mapping[str, CelProgram]] = None,
        *,
        now_us: Optional[int] = None,
    ) -> None:
        self.compiled = snapshot.compiled
        self.schema = snapshot.compiled.schema
        self.caveat_programs = dict(caveat_programs or {})
        self.now_us = now_us
        self.snapshot = snapshot
        self._edge_memo: Dict[Tuple[str, str, str], Tuple[_Edge, ...]] = {}
        # base-class dicts stay empty; all access is overridden
        self._by_onr = {}
        self._objects_of_type = {}
        self._subjects_of_type = {}
        import numpy as np

        self._np = np
        # packed (rel, res) over the primary sort order — monotone because
        # the primary order is lex (rel, res, subj, srel1)
        self._relres = (
            snapshot.e_rel.astype(np.int64) * (2**32)
            + snapshot.e_res.astype(np.int64)
        )
        self._slot_names = snapshot._slot_names()
        self._caveat_names = snapshot._caveat_names()

    def _edges_of(self, rtype: str, rid: str, relation: str) -> Tuple[_Edge, ...]:
        key = (rtype, rid, relation)
        got = self._edge_memo.get(key)
        if got is not None:
            return got
        snap = self.snapshot
        node = snap.interner.lookup(rtype, rid)
        slot = self.compiled.slot_of_name.get(relation, -1)
        if node < 0 or slot < 0:
            self._edge_memo[key] = ()
            return ()
        np = self._np
        packed = np.int64(slot) * (2**32) + node
        lo = int(np.searchsorted(self._relres, packed, "left"))
        hi = int(np.searchsorted(self._relres, packed, "right"))
        out = []
        for i in range(lo, hi):
            stype, sid = snap.interner.key_of(int(snap.e_subj[i]))
            srel1 = int(snap.e_srel1[i])
            cav_id = int(snap.e_caveat[i])
            ctx_i = int(snap.e_ctx[i])
            out.append(
                _Edge(
                    subject_type=stype,
                    subject_id=sid,
                    subject_relation=(
                        self._slot_names[srel1 - 1] if srel1 > 0 else ""
                    ),
                    caveat_name=self._caveat_names[cav_id] if cav_id else "",
                    caveat_context=(
                        snap.contexts[ctx_i] if ctx_i >= 0 else {}
                    ),
                    expires_us=int(snap.e_exp_us[i]),
                )
            )
        got = tuple(out)
        self._edge_memo[key] = got
        return got

    def _object_ids(self, type_name: str):
        snap = self.snapshot
        np = self._np
        tid = snap.interner.type_lookup(type_name)
        if tid < 0:
            return []
        nodes = np.unique(snap.e_res)
        nodes = nodes[snap.node_type[nodes] == tid]
        return sorted(snap.interner.key_of(int(n))[1] for n in nodes)

    def _subject_ids(self, type_name: str):
        snap = self.snapshot
        np = self._np
        tid = snap.interner.type_lookup(type_name)
        if tid < 0:
            return []
        nodes = np.unique(snap.e_subj)
        nodes = nodes[snap.node_type[nodes] == tid]
        return sorted(snap.interner.key_of(int(n))[1] for n in nodes)
