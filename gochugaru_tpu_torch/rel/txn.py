"""Write-transaction builder (reference: ``rel/txn.go``).

A ``Txn`` accumulates updates (CREATE / TOUCH / DELETE) and preconditions;
the zero value is usable, exactly like the reference's plain struct
(rel/txn.go:8-11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .filter import Filter, Precondition
from .relationship import Relationship, RelationshipLike, as_relationship
from .update import Update, UpdateType


@dataclass
class Txn:
    """An atomic modification with optional preconditions (rel/txn.go:7-11)."""

    updates: List[Update] = field(default_factory=list)
    preconditions: List[Precondition] = field(default_factory=list)

    def must_match(self, f: Filter) -> "Txn":
        """Only apply if the filter matches something (rel/txn.go:15-20)."""
        self.preconditions.append(Precondition(must_match=True, filter=f))
        return self

    def must_not_match(self, f: Filter) -> "Txn":
        """Only apply if the filter matches nothing (rel/txn.go:24-29)."""
        self.preconditions.append(Precondition(must_match=False, filter=f))
        return self

    def touch(self, r: RelationshipLike) -> "Txn":
        """Idempotently create or update a relationship (rel/txn.go:34-39)."""
        self.updates.append(Update(UpdateType.TOUCH, as_relationship(r)))
        return self

    def create(self, r: RelationshipLike) -> "Txn":
        """Insert a new relationship; the write fails if it already exists
        (rel/txn.go:43-48)."""
        self.updates.append(Update(UpdateType.CREATE, as_relationship(r)))
        return self

    def delete(self, r: RelationshipLike) -> "Txn":
        """Remove a relationship (rel/txn.go:51-56)."""
        self.updates.append(Update(UpdateType.DELETE, as_relationship(r)))
        return self
