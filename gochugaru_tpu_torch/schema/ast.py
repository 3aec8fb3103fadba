"""AST for the SpiceDB schema language subset this framework evaluates.

Spec sources: the example schema in the reference's integration tests
(client/client_test.go:23-32) plus the public SpiceDB schema language —
``definition`` types holding typed ``relation`` edges and ``permission``
userset-rewrite expressions over ``+`` (union), ``&`` (intersection),
``-`` (exclusion), ``->`` (arrow / tupleset traversal), ``nil``, wildcard
subjects (``user:*``), userset subjects (``group#member``), and ``caveat``
declarations with CEL-subset bodies.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


# --------------------------------------------------------------------------
# Permission expressions
# --------------------------------------------------------------------------


class Expr:
    """Base class for permission userset-rewrite expressions."""

    __slots__ = ()


@dataclass(frozen=True)
class RelationRef(Expr):
    """A bare reference to a relation or permission on the same type,
    e.g. ``edit`` in ``permission view = reader + edit``."""

    name: str

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Arrow(Expr):
    """Tupleset traversal ``left->right``: walk tuples of relation ``left``
    on the resource, then evaluate ``right`` on each subject reached.
    The left side must name a plain relation on the same type (SpiceDB
    rejects arrows over permissions and chained arrows)."""

    left: str
    right: str

    def __str__(self) -> str:
        return f"{self.left}->{self.right}"


@dataclass(frozen=True)
class Union(Expr):
    children: tuple

    def __str__(self) -> str:
        return "(" + " + ".join(str(c) for c in self.children) + ")"


@dataclass(frozen=True)
class Intersection(Expr):
    children: tuple

    def __str__(self) -> str:
        return "(" + " & ".join(str(c) for c in self.children) + ")"


@dataclass(frozen=True)
class Exclusion(Expr):
    """``base - subtracted`` — grants base minus subtracted."""

    base: Expr
    subtracted: Expr

    def __str__(self) -> str:
        return f"({self.base} - {self.subtracted})"


@dataclass(frozen=True)
class Nil(Expr):
    """``permission p = nil`` — grants nobody."""

    def __str__(self) -> str:
        return "nil"


# --------------------------------------------------------------------------
# Declarations
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AllowedSubject:
    """One alternative in a relation's type annotation:
    ``user`` (direct), ``user:*`` (wildcard), ``group#member`` (userset),
    optionally ``with caveat_name`` and/or ``with expiration``."""

    type: str
    relation: str = ""  # userset subject relation; "" = direct object
    wildcard: bool = False
    caveat: str = ""  # required caveat name, "" = none
    expiration: bool = False  # subject must carry an expiration trait

    def __str__(self) -> str:
        s = self.type
        if self.wildcard:
            s += ":*"
        elif self.relation:
            s += f"#{self.relation}"
        traits = ([self.caveat] if self.caveat else []) + (
            ["expiration"] if self.expiration else []
        )
        if traits:
            s += " with " + " and ".join(traits)
        return s


@dataclass
class Relation:
    """``relation name: allowed | allowed | ...`` — a typed edge label."""

    name: str
    allowed: List[AllowedSubject] = field(default_factory=list)

    def allows_all(self, subject_type: str, subject_relation: str, wildcard: bool) -> List[AllowedSubject]:
        """All alternatives matching (type, relation, wildcard) — there can
        be several differing only in caveat/expiration traits
        (``user | user with office_hours``)."""
        out = []
        for a in self.allowed:
            if a.type != subject_type:
                continue
            if wildcard != a.wildcard:
                continue
            if not wildcard and a.relation != subject_relation:
                continue
            out.append(a)
        return out

    def allows(self, subject_type: str, subject_relation: str, wildcard: bool) -> Optional[AllowedSubject]:
        matches = self.allows_all(subject_type, subject_relation, wildcard)
        return matches[0] if matches else None


@dataclass
class Permission:
    """``permission name = expr`` — a userset-rewrite expression."""

    name: str
    expr: Expr


@dataclass
class Definition:
    """``definition name { ... }`` — an object type."""

    name: str
    relations: Dict[str, Relation] = field(default_factory=dict)
    permissions: Dict[str, Permission] = field(default_factory=dict)

    def item(self, name: str):
        return self.relations.get(name) or self.permissions.get(name)


@dataclass
class CaveatDecl:
    """``caveat name(param type, ...) { cel_expression }``."""

    name: str
    params: Dict[str, str] = field(default_factory=dict)  # name -> CEL type
    expression: str = ""  # raw CEL text; compiled by gochugaru_tpu.caveats


@dataclass
class Schema:
    """A parsed schema document."""

    definitions: Dict[str, Definition] = field(default_factory=dict)
    caveats: Dict[str, CaveatDecl] = field(default_factory=dict)
    text: str = ""  # original source, round-tripped by ReadSchema
