"""Multi-device scaling: mesh construction and the sharded bulk-check
engine.

A ``Mesh`` is a (data × model) grid of torch devices:

- ``data`` — the query batch splits across rows (throughput);
- ``model`` — the bucket-sharded tables split across shards (capacity),
  with OR-reduce / broadcast / all-gather collectives at the program's
  merge points (parallel/collectives.py).

One process drives every position, each on a thread of its own; a mesh
may also span processes (``parallel.multihost``: ``torch.distributed``,
each process driving its own positions).
"""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, default_mesh, make_mesh
from .sharded import ShardedEngine

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "default_mesh",
           "ShardedEngine"]
