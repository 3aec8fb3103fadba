"""Fleet serving: replicated processes around the shared watch stream.

One process is one failure domain.  This package splits the engine into
an authoritative **router** (owns the store, mints revisions and
zookies, serves the replication stream, routes checks over a
consistent-hash ring with freshness overrides and failover) and N
**replicas** (bootstrap a world export, tail the stream exactly-once,
serve checks through a full local Client with verdict cache and
admission control, on the card unless told ``device="cpu"``).  See
fleet/router.py and fleet/replica.py for the protocol details, and
``python -m gochugaru_tpu_torch.fleet.replica`` for the replica process.
"""

from .config import FleetConfig
from .replica import Replica
from .router import FleetRouter, HashRing
from .zookie import InvalidZookieError

__all__ = [
    "FleetConfig",
    "FleetRouter",
    "HashRing",
    "Replica",
    "InvalidZookieError",
]
