"""Host-side tuple storage: interners, the MVCC tuple log, and columnar
snapshot materialization.

This subsystem plays the role SpiceDB's datastore plays behind the
reference client: writes are validated against the schema and applied
atomically with preconditions (rel/txn.go semantics), every write mints a
revision token (ZedToken analogue, client/client.go:125), and reads/checks
evaluate against a materialized snapshot generation selected by a
consistency Strategy (SURVEY.md §5 "Checkpoint / resume").

The S2-compression lesson from the reference ("compress the boundary",
README.md:22) becomes: intern strings host-side once, ship only int32/int64
columns across the host↔device boundary.
"""

from .interner import Interner
from .store import RevisionToken, Store, parse_revision
from .snapshot import Snapshot

__all__ = ["Interner", "Store", "Snapshot", "RevisionToken", "parse_revision"]
