"""The relationship data model (reference: ``rel/`` package).

Everything the client surface round-trips through: ``Relationship`` and its
constructors/parsers, ``Filter``/``PreconditionedFilter``, the ``Txn``
write-transaction builder, watch ``Update`` types, and the object-set /
typed-relation string parsers.
"""

from .relationship import (
    ELLIPSIS,
    WILDCARD_ID,
    InvalidRelationError,
    InvalidResourceError,
    InvalidSubjectError,
    Object,
    Relationship,
    from_objects,
    from_triple,
    from_tuple,
    must_from_triple,
    must_from_tuple,
)
from .filter import Filter, PreconditionedFilter, new_filter, new_preconditioned_filter
from .txn import Txn
from .update import (
    Update,
    UpdateFilter,
    UpdateType,
)
from .strings import (
    InvalidObjectStringError,
    InvalidTypedRelationStringError,
    parse_object_set,
    parse_typed_relation,
)

# Go-parity aliases (reference rel/relationship.go, rel/strings.go) so a
# gochugaru user finds the names they know.
FromTriple = from_triple
FromTuple = from_tuple
FromObjects = from_objects
MustFromTriple = must_from_triple
MustFromTuple = must_from_tuple
NewFilter = new_filter
NewPreconditionedFilter = new_preconditioned_filter
ParseObjectSet = parse_object_set
ParseTypedRelation = parse_typed_relation

ErrInvalidResource = InvalidResourceError
ErrInvalidRelation = InvalidRelationError
ErrInvalidSubject = InvalidSubjectError
ErrInvalidObjectString = InvalidObjectStringError
ErrInvalidTypedRelationString = InvalidTypedRelationStringError

__all__ = [
    "ELLIPSIS",
    "WILDCARD_ID",
    "Relationship",
    "Object",
    "Filter",
    "PreconditionedFilter",
    "Txn",
    "Update",
    "UpdateFilter",
    "UpdateType",
    "from_triple",
    "from_tuple",
    "from_objects",
    "must_from_triple",
    "must_from_tuple",
    "new_filter",
    "new_preconditioned_filter",
    "parse_object_set",
    "parse_typed_relation",
    "InvalidResourceError",
    "InvalidRelationError",
    "InvalidSubjectError",
    "InvalidObjectStringError",
    "InvalidTypedRelationStringError",
]
