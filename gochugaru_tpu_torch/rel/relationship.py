"""Relationship: the flattened 9-field tuple at the heart of the data model.

Reference: ``rel/relationship.go:28-38`` (struct), ``:51-90`` (canonical
string format), ``:93-120`` (copy-with builders), ``:220-265`` (parsers with
sentinel errors).  The reference keeps ``Relationship`` as a flattened native
struct with lazy proto lowering; here the analogous lazy lowering is string →
interned int32 columns, owned by ``store.Interner`` — this type stays pure
Python and hashable so user code can put relationships in sets/dicts.
"""

from __future__ import annotations

import datetime as _dt
import json
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Mapping, Optional

#: The "ellipsis" subject relation — a subject with no relation (direct).
ELLIPSIS = ""

#: The wildcard object id (``user:*`` grants every subject of the type).
WILDCARD_ID = "*"


class InvalidResourceError(ValueError):
    """Catch-all error when a resource is invalid (rel/relationship.go:17)."""


class InvalidRelationError(ValueError):
    """Catch-all error when a relation is invalid (rel/relationship.go:20)."""


class InvalidSubjectError(ValueError):
    """Catch-all error when a subject is invalid (rel/relationship.go:23)."""


def _canonical_caveat_json(context: Mapping[str, Any]) -> str:
    """Serialize caveat context the way protobuf Struct JSON does: compact
    separators, map keys sorted, integral floats printed as integers
    (rel/relationship.go:66-83)."""

    def norm(v: Any) -> Any:
        if isinstance(v, bool) or v is None or isinstance(v, str):
            return v
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, (int, float)):
            return v
        if isinstance(v, Mapping):
            return {str(k): norm(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        raise TypeError(f"caveat context value not representable: {v!r}")

    return json.dumps(norm(dict(context)), separators=(",", ":"), sort_keys=True)


def expiration_micros(t: Optional[_dt.datetime]) -> int:
    """Expiration as epoch microseconds; 0 = none.  Naive datetimes are
    interpreted as UTC — the single definition every evaluator and the
    store share, so liveness never diverges between paths."""
    if t is None:
        return 0
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return int(t.timestamp() * 1_000_000)


def format_rfc3339_nano(t: _dt.datetime) -> str:
    """Format a datetime like Go's ``time.RFC3339Nano``: fractional seconds
    with trailing zeros (and a bare dot) trimmed, ``Z`` for UTC
    (rel/relationship.go:13,84-88)."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    base = t.strftime("%Y-%m-%dT%H:%M:%S")
    frac = f"{t.microsecond:06d}".rstrip("0")
    if frac:
        base += "." + frac
    off = t.utcoffset() or _dt.timedelta(0)
    if off == _dt.timedelta(0):
        return base + "Z"
    total = int(off.total_seconds())
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    return f"{base}{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"


@dataclass(frozen=True, eq=False)
class Relationship:
    """A relationship tuple ``resource#relation@subject`` with optional
    caveat and expiration (rel/relationship.go:28-38).

    Any object exposing a ``relationship() -> Relationship`` method is
    accepted wherever a relationship is expected — the structural analogue of
    the reference's ``rel.Interface`` (rel/relationship.go:26,40).
    """

    resource_type: str = ""
    resource_id: str = ""
    resource_relation: str = ""
    subject_type: str = ""
    subject_id: str = ""
    subject_relation: str = ""
    caveat_name: str = ""
    caveat_context: Mapping[str, Any] = field(default_factory=dict)
    expiration: Optional[_dt.datetime] = None

    def __post_init__(self) -> None:
        # Defensive copy: the value is frozen and hashable, so it must not
        # alias a caller-owned dict that could mutate under it.
        object.__setattr__(self, "caveat_context", dict(self.caveat_context))

    # -- rel.Interface ----------------------------------------------------
    def relationship(self) -> "Relationship":
        return self

    # -- accessors (rel/relationship.go:41-49) ----------------------------
    @property
    def permission(self) -> str:
        return self.resource_relation

    def has_caveat(self) -> bool:
        return self.caveat_name != ""

    def has_expiration(self) -> bool:
        # nil and the zero time both mean "no expiration"
        # (rel/relationship.go:43-45; zero-time case tested in
        # rel/relationship_test.go:69-74).
        return self.expiration is not None and self.expiration != _dt.datetime(
            1, 1, 1, tzinfo=self.expiration.tzinfo
        )

    def caveat(self) -> tuple[str, Mapping[str, Any], bool]:
        return self.caveat_name, self.caveat_context, self.has_caveat()

    # -- canonical tuple format (rel/relationship.go:51-90) ----------------
    def __str__(self) -> str:
        parts = [
            self.resource_type,
            ":",
            self.resource_id,
            "#",
            self.resource_relation,
            "@",
            self.subject_type,
            ":",
            self.subject_id,
        ]
        if self.subject_relation != "":
            parts += ["#", self.subject_relation]
        if self.has_caveat():
            parts += ["[", self.caveat_name]
            if self.caveat_context:
                parts += [":", _canonical_caveat_json(self.caveat_context)]
            parts.append("]")
        if self.has_expiration():
            parts += ["[expiration:", format_rfc3339_nano(self.expiration), "]"]
        return "".join(parts)

    # -- copy-with builders (rel/relationship.go:93-120) -------------------
    def with_caveat(self, name: str, context: Mapping[str, Any]) -> "Relationship":
        return replace(self, caveat_name=name, caveat_context=dict(context))

    def with_expiration(self, expiration: _dt.datetime) -> "Relationship":
        return replace(self, expiration=expiration)

    # -- filter conversion (rel/relationship.go:122-126) -------------------
    def filter(self) -> "Filter":
        from .filter import new_filter

        f = new_filter(self.resource_type, self.resource_id, self.resource_relation)
        f.with_subject_filter(self.subject_type, self.subject_id, self.subject_relation)
        return f

    # -- equality/hashing: caveat context is a dict, so both use the same
    # canonical JSON form (keeps the hash/eq contract exact even for values
    # Python considers equal but JSON distinguishes, like 1 vs True) --------
    def _identity(self) -> tuple:
        return (
            self.resource_type, self.resource_id, self.resource_relation,
            self.subject_type, self.subject_id, self.subject_relation,
            self.caveat_name,
            _canonical_caveat_json(self.caveat_context) if self.caveat_context else "",
            self.expiration,
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Relationship):
            return NotImplemented
        return self._identity() == other._identity()

    def __hash__(self) -> int:
        return hash(self._identity())

    def key(self) -> tuple[str, str, str, str, str, str]:
        """The identity key of a relationship: everything except caveat and
        expiration.  Two writes to the same key TOUCH/replace one another,
        matching SpiceDB tuple-uniqueness semantics."""
        return (
            self.resource_type, self.resource_id, self.resource_relation,
            self.subject_type, self.subject_id, self.subject_relation,
        )


#: Anything usable as a relationship: a Relationship or an object with a
#: ``relationship()`` method (rel.Interface, rel/relationship.go:26).
RelationshipLike = Any


def decoded_relationship(
    resource_type: str,
    resource_id: str,
    resource_relation: str,
    subject_type: str,
    subject_id: str,
    subject_relation: str,
    caveat_name: str,
    caveat_context: Mapping[str, Any],
    expiration: Optional[_dt.datetime],
) -> Relationship:
    """Bulk-decode fast constructor: bypasses the frozen-dataclass
    ``__init__`` (nine ``object.__setattr__`` calls, the measured ~220k
    objects/s ceiling of the export path) by populating ``__dict__``
    directly.  Semantics match ``Relationship(...)`` exactly, including
    the defensive caveat-context copy — fields arrive pre-validated from
    the snapshot's interned columns, so no parsing re-runs."""
    r = _obj_new(Relationship)
    _obj_setattr(r, "__dict__", {
        "resource_type": resource_type,
        "resource_id": resource_id,
        "resource_relation": resource_relation,
        "subject_type": subject_type,
        "subject_id": subject_id,
        "subject_relation": subject_relation,
        "caveat_name": caveat_name,
        "caveat_context": dict(caveat_context) if caveat_context else {},
        "expiration": expiration,
    })
    return r


#: bound once: the per-row constructor above runs millions of times per
#: export, and global lookups of object.__new__/__setattr__ are ~8% of it
_obj_new = object.__new__
_obj_setattr = object.__setattr__


def as_relationship(r: RelationshipLike) -> Relationship:
    if isinstance(r, Relationship):
        return r
    meth = getattr(r, "relationship", None)
    if callable(meth):
        got = meth()
        if isinstance(got, Relationship):
            return got
    raise TypeError(f"not a relationship or rel.Interface: {r!r}")


@dataclass(frozen=True)
class Object:
    """A typed object reference, optionally with a relation
    (rel/relationship.go:198-206)."""

    typ: str = ""
    id: str = ""
    relation: str = ""

    def object(self) -> "Object":
        return self


def _as_object(o: Any) -> Object:
    if isinstance(o, Object):
        return o
    meth = getattr(o, "object", None)
    if callable(meth):
        got = meth()
        if isinstance(got, Object):
            return got
    raise TypeError(f"not an Object or rel.Objecter: {o!r}")


def from_objects(resource: Any, subject: Any) -> Relationship:
    """Build a relationship from two object references
    (rel/relationship.go:208-218)."""
    r, s = _as_object(resource), _as_object(subject)
    return Relationship(
        resource_type=r.typ, resource_id=r.id, resource_relation=r.relation,
        subject_type=s.typ, subject_id=s.id, subject_relation=s.relation,
    )


def from_triple(resource: str, relation: str, subject: str) -> Relationship:
    """Parse ``("document:example", "viewer", "user:jzelinskie")``
    (rel/relationship.go:228-230)."""
    return from_tuple(resource + "#" + relation, subject)


def must_from_triple(resource: str, relation: str, subject: str) -> Relationship:
    return from_triple(resource, relation, subject)


def from_tuple(resource: str, subject: str) -> Relationship:
    """Parse ``("document:example#viewer", "user:jzelinskie[#rel]")`` with the
    reference's exact error taxonomy (rel/relationship.go:240-265): missing
    ``#relation`` → InvalidRelationError; missing resource ``type:id`` →
    InvalidResourceError; missing subject ``type:id`` → InvalidSubjectError.
    The subject relation is optional."""
    resource, sep, resource_relation = resource.partition("#")
    if sep == "" or resource_relation == "":
        raise InvalidRelationError("invalid relation")
    resource_type, sep, resource_id = resource.partition(":")
    if sep == "":
        raise InvalidResourceError("invalid resource")

    subject, _, subject_relation = subject.partition("#")
    subject_type, sep, subject_id = subject.partition(":")
    if sep == "":
        raise InvalidSubjectError("invalid subject")

    return Relationship(
        resource_type=resource_type,
        resource_id=resource_id,
        resource_relation=resource_relation,
        subject_type=subject_type,
        subject_id=subject_id,
        subject_relation=subject_relation,
    )


def must_from_tuple(resource: str, subject: str) -> Relationship:
    return from_tuple(resource, subject)


def as_relationships(rs: Iterable[RelationshipLike]) -> list[Relationship]:
    return [as_relationship(r) for r in rs]
