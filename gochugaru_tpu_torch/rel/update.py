"""Watch-event types (reference: ``rel/relationship.go:267-306``)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List

from .filter import Filter
from .relationship import Relationship


class UpdateType(enum.IntEnum):
    """Mirrors the reference enum (rel/relationship.go:267-274)."""

    UNKNOWN = 0
    CREATE = 1
    DELETE = 2
    TOUCH = 3


@dataclass(frozen=True)
class Update:
    """A single watch event: an operation applied to a relationship
    (rel/relationship.go:291-294)."""

    update_type: UpdateType
    relationship: Relationship


@dataclass
class UpdateFilter:
    """Filters a watch stream by object types and/or relationship filters
    (rel/relationship.go:303-306)."""

    object_types: List[str] = field(default_factory=list)
    relationship_filters: List[Filter] = field(default_factory=list)

    def admits(self, u: Update) -> bool:
        # SpiceDB's WatchRequest treats these fields as mutually exclusive;
        # specifying both is rejected at subscribe time (see Client.updates),
        # so here whichever is set decides.
        if self.object_types:
            return u.relationship.resource_type in self.object_types
        if self.relationship_filters:
            return any(f.matches(u.relationship) for f in self.relationship_filters)
        return True
