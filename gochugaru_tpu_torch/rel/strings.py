"""Object-set and typed-relation string parsers (reference: ``rel/strings.go``)."""

from __future__ import annotations


class InvalidObjectStringError(ValueError):
    """rel/strings.go:9"""

    def __init__(self) -> None:
        super().__init__(
            "invalid object string: must be in form `objectType:objectID#optionalRelation`"
        )


class InvalidTypedRelationStringError(ValueError):
    """rel/strings.go:10"""

    def __init__(self) -> None:
        super().__init__(
            "invalid typed permission string: must be in form `objectType#relation`"
        )


def parse_object_set(obj: str) -> tuple[str, str, str]:
    """``"document:README#reader"`` → ``("document", "README", "reader")``;
    the relation is optional (rel/strings.go:19-28)."""
    object_type, sep, object_id = obj.partition(":")
    if sep == "":
        raise InvalidObjectStringError()
    object_id, _, relation = object_id.partition("#")
    return object_type, object_id, relation


def parse_typed_relation(perm: str) -> tuple[str, str]:
    """``"document#reader"`` → ``("document", "reader")``
    (rel/strings.go:31-38)."""
    object_type, sep, relation = perm.partition("#")
    if sep == "":
        raise InvalidTypedRelationStringError()
    return object_type, relation
