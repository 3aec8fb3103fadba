"""Permission evaluators.

Two implementations of the same semantics:

- ``oracle`` — a pure-Python recursive userset-rewrite walker with exact
  SpiceDB check semantics (tri-state permissionship, caveats, expiration,
  wildcards, userset subjects, arrows).  It is the differential-testing
  reference (SURVEY.md §4's replacement for the dockerized
  `spicedb serve-testing`), the LookupResources/LookupSubjects engine, and
  the fallback for queries that overflow the device engine's static caps.

- ``device`` — the PyTorch engine: the flat check program (``flat``)
  over hash-indexed, bit-packed tables on a torch device, its bucket
  probes in the hand-written CUDA kernel of ``kernels``; the lookups
  (``lookup``) expand candidates over the reverse-CSR tables (``rev``)
  with the device frontier (``spmv``) and filter them with the check.
"""

from .oracle import Oracle, PermTri

__all__ = ["Oracle", "PermTri"]
