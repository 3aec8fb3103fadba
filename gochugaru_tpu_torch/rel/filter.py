"""Filters for matching relationships (reference: ``rel/filter.go``).

The reference wraps ``*v1.RelationshipFilter`` protos; here a filter is a
plain dataclass the store matches against directly.  Empty string means
"match anything" for every field except ``resource_type``, which is required
(rel/filter.go:12-15).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from .relationship import Relationship


@dataclass
class SubjectFilter:
    subject_type: str = ""
    optional_subject_id: str = ""
    #: None = any subject relation; "" = must have NO subject relation;
    #: non-empty = must equal.  Mirrors v1.SubjectFilter.RelationFilter
    #: semantics (rel/filter.go:27-37).
    optional_relation: Optional[str] = None


@dataclass
class Filter:
    """A filter matched against the Resource (and optionally Subject) of
    relationships (rel/filter.go:6-23)."""

    resource_type: str = ""
    optional_resource_id: str = ""
    optional_relation: str = ""
    optional_subject_filter: Optional[SubjectFilter] = None

    def with_subject_filter(
        self, subject_type: str, optional_id: str = "", optional_relation: str = ""
    ) -> "Filter":
        """Also match against the Subject (rel/filter.go:27-37).  As in the
        reference, an empty ``optional_relation`` here means "any relation"
        (the RelationFilter is only attached when non-empty)."""
        self.optional_subject_filter = SubjectFilter(
            subject_type=subject_type,
            optional_subject_id=optional_id,
            optional_relation=optional_relation if optional_relation != "" else None,
        )
        return self

    def matches(self, r: Relationship) -> bool:
        if self.resource_type != "" and r.resource_type != self.resource_type:
            return False
        if self.optional_resource_id != "" and r.resource_id != self.optional_resource_id:
            return False
        if self.optional_relation != "" and r.resource_relation != self.optional_relation:
            return False
        sf = self.optional_subject_filter
        if sf is not None:
            if sf.subject_type != "" and r.subject_type != sf.subject_type:
                return False
            if sf.optional_subject_id != "" and r.subject_id != sf.optional_subject_id:
                return False
            if sf.optional_relation is not None and r.subject_relation != sf.optional_relation:
                return False
        return True


def new_filter(resource_type: str, optional_id: str = "", optional_relation: str = "") -> Filter:
    """Create a Filter; a resource type is required, empty string foregoes
    filtering on the resource id / relation (rel/filter.go:15-23)."""
    return Filter(
        resource_type=resource_type,
        optional_resource_id=optional_id,
        optional_relation=optional_relation,
    )


@dataclass
class Precondition:
    must_match: bool = True
    filter: Filter = dc_field(default_factory=Filter)


@dataclass
class PreconditionedFilter:
    """A filter plus preconditions gating another action
    (rel/filter.go:41-70)."""

    filter: Filter = dc_field(default_factory=Filter)
    preconditions: List[Precondition] = dc_field(default_factory=list)

    def must_match(self, f: Filter) -> "PreconditionedFilter":
        self.preconditions.append(Precondition(must_match=True, filter=f))
        return self

    def must_not_match(self, f: Filter) -> "PreconditionedFilter":
        self.preconditions.append(Precondition(must_match=False, filter=f))
        return self


def new_preconditioned_filter(f: Filter) -> PreconditionedFilter:
    return PreconditionedFilter(filter=f)
