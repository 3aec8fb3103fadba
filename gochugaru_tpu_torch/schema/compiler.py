"""Schema AST → numeric IR.

The compiler assigns every distinct relation/permission *name* a global
integer slot (shared across types — programs are keyed by (type, slot), so
name collisions across types are fine and tuples can store just the slot id
for their relation column).  It validates cross-references, classifies
tupleset (arrow-LHS) relations, and bounds evaluation depth — the host-side
cycle analysis SURVEY.md §7 calls out as a hard part (hop caps must be
provably sufficient for non-recursive schemas).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..rel.relationship import Relationship, WILDCARD_ID
from .ast import (
    Arrow,
    Definition,
    Exclusion,
    Expr,
    Intersection,
    Nil,
    Permission,
    Relation,
    RelationRef,
    Schema,
    Union,
)


class SchemaValidationError(ValueError):
    pass


@dataclass(frozen=True)
class CompiledAllowed:
    """Numeric form of an AllowedSubject."""

    type_id: int
    relation_slot: int  # -1 = direct object subject
    wildcard: bool
    caveat_id: int  # 0 = none
    expiration: bool


@dataclass
class CompiledRelation:
    slot: int
    allowed: List[CompiledAllowed]


@dataclass
class CompiledPermission:
    slot: int
    expr: Expr  # AST expr; names resolved/validated, slots via slot_of_name


@dataclass
class CompiledType:
    type_id: int
    name: str
    relations: Dict[int, CompiledRelation] = field(default_factory=dict)  # slot →
    permissions: Dict[int, CompiledPermission] = field(default_factory=dict)  # slot →
    #: slots of relations on THIS type used as arrow LHS somewhere on this type
    tupleset_slots: FrozenSet[int] = frozenset()


@dataclass
class CompiledSchema:
    schema: Schema
    type_ids: Dict[str, int]
    slot_of_name: Dict[str, int]
    caveat_ids: Dict[str, int]  # 1-based; 0 = no caveat
    types: Dict[int, CompiledType]
    num_slots: int
    #: all (type_id, slot) pairs where slot is an arrow-LHS relation —
    #: the edges the Phase-B subgraph BFS must traverse
    tupleset_pairs: FrozenSet[Tuple[int, int]]
    #: union of tupleset relation slots across types (device-side filter)
    tupleset_slots: FrozenSet[int]
    #: longest acyclic dependency chain through the rewrite system
    depth: int
    #: True if the dependency graph has a cycle (nested recursive groups,
    #: recursive folder hierarchies, ...) — evaluation needs iteration caps
    is_recursive: bool
    #: True if any relation admits a userset subject whose relation is a
    #: permission — the device closure phase cannot expand those; the client
    #: routes affected checks to the host oracle
    has_permission_usersets: bool = False
    #: acyclic dependency depth per (type_name, item_name) — cycle members
    #: get their acyclic-part depth; used to topologically order permission
    #: updates in the device fixpoint so each iteration propagates a full
    #: dependency level
    item_depths: Dict[Tuple[str, str], int] = field(default_factory=dict)

    # -- name helpers ------------------------------------------------------
    @property
    def name_of_slot(self) -> Dict[int, str]:
        """slot → name inverse of ``slot_of_name`` (well-defined: slots
        are per-name), cached — the single shared inversion for decode
        paths and the fold."""
        cache = getattr(self, "_name_of_slot", None)
        if cache is None:
            cache = {v: k for k, v in self.slot_of_name.items()}
            self._name_of_slot = cache
        return cache

    def slot(self, name: str) -> int:
        s = self.slot_of_name.get(name)
        if s is None:
            raise SchemaValidationError(f"unknown relation/permission {name!r}")
        return s

    def type_id(self, name: str) -> int:
        t = self.type_ids.get(name)
        if t is None:
            raise SchemaValidationError(f"unknown object type {name!r}")
        return t

    def item_kind(self, type_name: str, item_name: str) -> str:
        """'relation' | 'permission' | 'absent' for a (type, name) pair."""
        d = self.schema.definitions.get(type_name)
        if d is None:
            return "absent"
        if item_name in d.relations:
            return "relation"
        if item_name in d.permissions:
            return "permission"
        return "absent"

    # -- write-path validation --------------------------------------------
    def validate_relationship(self, r: Relationship) -> None:
        """Validate a relationship against the schema the way SpiceDB
        validates writes: the resource type must be defined, the resource
        relation must be a plain relation (not a permission), and the
        subject must match one of the relation's allowed subject types
        (including wildcard/userset/caveat forms)."""
        d = self.schema.definitions.get(r.resource_type)
        if d is None:
            raise SchemaValidationError(f"object definition `{r.resource_type}` not found")
        if r.resource_relation in d.permissions:
            raise SchemaValidationError(
                f"cannot write to permission `{r.resource_type}#{r.resource_relation}`;"
                " writes must target relations"
            )
        relation = d.relations.get(r.resource_relation)
        if relation is None:
            raise SchemaValidationError(
                f"relation `{r.resource_relation}` not found on `{r.resource_type}`"
            )
        if r.subject_type not in self.schema.definitions:
            raise SchemaValidationError(f"object definition `{r.subject_type}` not found")
        wildcard = r.subject_id == WILDCARD_ID
        matches = relation.allows_all(r.subject_type, r.subject_relation, wildcard)
        if not matches:
            raise SchemaValidationError(
                f"subject `{r.subject_type}"
                + (":*" if wildcard else (f"#{r.subject_relation}" if r.subject_relation else ""))
                + f"` is not allowed on relation `{r.resource_type}#{r.resource_relation}`"
            )
        if r.subject_relation and self.item_kind(r.subject_type, r.subject_relation) == "absent":
            raise SchemaValidationError(
                f"relation `{r.subject_relation}` not found on `{r.subject_type}`"
            )
        if r.caveat_name and r.caveat_name not in self.schema.caveats:
            raise SchemaValidationError(f"caveat `{r.caveat_name}` not found")
        # Multiple alternatives may differ only in caveat/expiration traits
        # (``user | user with office_hours``); the relationship must satisfy
        # at least one alternative exactly.
        if not any(
            a.caveat == r.caveat_name and (not a.expiration or r.has_expiration())
            for a in matches
        ):
            if r.caveat_name:
                raise SchemaValidationError(
                    f"caveat `{r.caveat_name}` is not allowed for this subject on"
                    f" relation `{r.resource_type}#{r.resource_relation}`"
                )
            wants_caveats = sorted({a.caveat for a in matches if a.caveat})
            if wants_caveats:
                raise SchemaValidationError(
                    f"relation `{r.resource_type}#{r.resource_relation}` requires"
                    f" caveat `{wants_caveats[0]}` for this subject"
                )
            raise SchemaValidationError(
                f"relation `{r.resource_type}#{r.resource_relation}` requires an"
                " expiration for this subject"
            )


def _expr_refs(e: Expr) -> List[Expr]:
    if isinstance(e, (RelationRef, Arrow, Nil)):
        return [e]
    if isinstance(e, (Union, Intersection)):
        out: List[Expr] = []
        for c in e.children:
            out.extend(_expr_refs(c))
        return out
    if isinstance(e, Exclusion):
        return _expr_refs(e.base) + _expr_refs(e.subtracted)
    raise SchemaValidationError(f"unknown expression node {e!r}")


def compile_schema(schema: Schema) -> CompiledSchema:
    # Stable, deterministic numbering: sorted names.
    type_names = sorted(schema.definitions)
    type_ids = {n: i for i, n in enumerate(type_names)}

    names: Set[str] = set()
    for d in schema.definitions.values():
        names.update(d.relations)
        names.update(d.permissions)
    slot_of_name = {n: i for i, n in enumerate(sorted(names))}
    caveat_ids = {n: i + 1 for i, n in enumerate(sorted(schema.caveats))}

    has_permission_usersets = False

    # -- validate + lower each type ---------------------------------------
    types: Dict[int, CompiledType] = {}
    tupleset_pairs: Set[Tuple[int, int]] = set()
    for tname, d in schema.definitions.items():
        tid = type_ids[tname]
        ct = CompiledType(type_id=tid, name=tname)

        for rname, relation in d.relations.items():
            compiled_allowed = []
            for a in relation.allowed:
                if a.type not in schema.definitions:
                    raise SchemaValidationError(
                        f"relation `{tname}#{rname}`: unknown subject type `{a.type}`"
                    )
                rel_slot = -1
                if a.relation:
                    kind = None
                    sub_def = schema.definitions[a.type]
                    if a.relation in sub_def.relations:
                        kind = "relation"
                    elif a.relation in sub_def.permissions:
                        kind = "permission"
                        has_permission_usersets = True
                    if kind is None:
                        raise SchemaValidationError(
                            f"relation `{tname}#{rname}`: subject `{a.type}#{a.relation}`"
                            " references an unknown relation"
                        )
                    rel_slot = slot_of_name[a.relation]
                if a.caveat and a.caveat not in schema.caveats:
                    raise SchemaValidationError(
                        f"relation `{tname}#{rname}`: unknown caveat `{a.caveat}`"
                    )
                compiled_allowed.append(
                    CompiledAllowed(
                        type_id=type_ids[a.type],
                        relation_slot=rel_slot,
                        wildcard=a.wildcard,
                        caveat_id=caveat_ids.get(a.caveat, 0),
                        expiration=a.expiration,
                    )
                )
            ct.relations[slot_of_name[rname]] = CompiledRelation(
                slot=slot_of_name[rname], allowed=compiled_allowed
            )

        for pname, perm in d.permissions.items():
            for ref in _expr_refs(perm.expr):
                if isinstance(ref, RelationRef):
                    if d.item(ref.name) is None:
                        raise SchemaValidationError(
                            f"permission `{tname}#{pname}` references unknown item"
                            f" `{ref.name}`"
                        )
                elif isinstance(ref, Arrow):
                    lhs = d.relations.get(ref.left)
                    if lhs is None:
                        if ref.left in d.permissions:
                            raise SchemaValidationError(
                                f"permission `{tname}#{pname}`: arrow LHS `{ref.left}`"
                                " must be a relation, not a permission"
                            )
                        raise SchemaValidationError(
                            f"permission `{tname}#{pname}`: arrow LHS `{ref.left}`"
                            " is not a relation on this type"
                        )
                    # RHS must exist on at least one possible target type;
                    # types where it's absent simply contribute nothing.
                    target_types = {a.type for a in lhs.allowed if not a.wildcard}
                    if not any(
                        schema.definitions[t2].item(ref.right) is not None
                        for t2 in target_types
                    ):
                        raise SchemaValidationError(
                            f"permission `{tname}#{pname}`: arrow target `{ref.right}`"
                            f" not found on any subject type of `{ref.left}`"
                        )
                    tupleset_pairs.add((tid, slot_of_name[ref.left]))
            ct.permissions[slot_of_name[pname]] = CompiledPermission(
                slot=slot_of_name[pname], expr=perm.expr
            )

        types[tid] = ct

    for tid, ct in types.items():
        ct.tupleset_slots = frozenset(s for (t, s) in tupleset_pairs if t == tid)

    # -- dependency-depth analysis ----------------------------------------
    # Node = (type_name, item_name).  Edges follow evaluation: permissions
    # depend on referenced items; arrows depend on (target_type, rhs) and on
    # their LHS relation; relations depend on the userset items of their
    # allowed subjects.
    depth_memo: Dict[Tuple[str, str], int] = {}
    in_stack: Set[Tuple[str, str]] = set()
    recursive = False

    def deps(node: Tuple[str, str]) -> List[Tuple[str, str]]:
        tname, iname = node
        d = schema.definitions[tname]
        out: List[Tuple[str, str]] = []
        if iname in d.permissions:
            for ref in _expr_refs(d.permissions[iname].expr):
                if isinstance(ref, RelationRef):
                    out.append((tname, ref.name))
                elif isinstance(ref, Arrow):
                    out.append((tname, ref.left))
                    for a in d.relations[ref.left].allowed:
                        if not a.wildcard and schema.definitions[a.type].item(ref.right):
                            out.append((a.type, ref.right))
        elif iname in d.relations:
            for a in d.relations[iname].allowed:
                if a.relation:
                    out.append((a.type, a.relation))
        return out

    def depth_of(node: Tuple[str, str]) -> int:
        nonlocal recursive
        if node in depth_memo:
            return depth_memo[node]
        if node in in_stack:
            recursive = True
            return 0
        in_stack.add(node)
        d = 0
        for dep in deps(node):
            d = max(d, 1 + depth_of(dep))
        in_stack.discard(node)
        depth_memo[node] = d
        return d

    max_depth = 0
    for tname, d in schema.definitions.items():
        for iname in list(d.relations) + list(d.permissions):
            max_depth = max(max_depth, depth_of((tname, iname)))

    return CompiledSchema(
        schema=schema,
        type_ids=type_ids,
        slot_of_name=slot_of_name,
        caveat_ids=caveat_ids,
        types=types,
        num_slots=len(slot_of_name),
        tupleset_pairs=frozenset(tupleset_pairs),
        tupleset_slots=frozenset(s for (_, s) in tupleset_pairs),
        depth=max_depth,
        is_recursive=recursive,
        has_permission_usersets=has_permission_usersets,
        item_depths=dict(depth_memo),
    )
