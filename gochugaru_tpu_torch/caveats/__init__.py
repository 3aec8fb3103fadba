"""CEL-subset caveat expressions.

SpiceDB caveats are CEL programs evaluated against a context assembled from
the relationship's stored context merged with the request's context (stored
values take precedence).  The reference treats caveats as first-class in its
data model (rel/relationship.go:35-37,174-188); evaluation happens
server-side.  Here ``compile_cel`` parses a supported CEL subset once at
schema-write time; the host evaluator backs the oracle, and the same program
lowers to the device caveat VM (``device.py``) for on-device predicate
evaluation.
"""

from .cel import (
    CelCompileError,
    CelProgram,
    CelType,
    UNKNOWN,
    compile_cel,
)
from .device import (
    CaveatDevicePlan,
    ContextTable,
    build_caveat_plan,
    encode_contexts,
    make_tri_fn,
)

__all__ = [
    "compile_cel", "CelProgram", "CelCompileError", "CelType", "UNKNOWN",
    "CaveatDevicePlan", "ContextTable", "build_caveat_plan",
    "encode_contexts", "make_tri_fn",
]
