"""SpiceDB schema-language front-end: parser, AST, and IR compiler.

The reference delegates schema handling to the server (WriteSchema /
ReadSchema round-trip raw text, client/client.go:416-434); the schema
language itself is the evaluator spec implied by the client's API surface
(SURVEY.md §2.6).  This package parses that language and compiles it into
the numeric IR the evaluation engines execute.
"""

from .ast import (
    AllowedSubject,
    Arrow,
    CaveatDecl,
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
from .parser import SchemaParseError, parse_schema
from .compiler import CompiledSchema, SchemaValidationError, compile_schema

__all__ = [
    "parse_schema",
    "compile_schema",
    "Schema",
    "Definition",
    "Relation",
    "Permission",
    "CaveatDecl",
    "AllowedSubject",
    "Expr",
    "RelationRef",
    "Arrow",
    "Union",
    "Intersection",
    "Exclusion",
    "Nil",
    "SchemaParseError",
    "SchemaValidationError",
    "CompiledSchema",
]
