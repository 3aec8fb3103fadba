"""The model axis's collectives, and the runner that drives one program
across a mesh.

``run_mesh(mesh, body)`` runs ``body(r, j, comm)`` once per mesh
position, each on a worker thread of its own, and returns the results
as ``[r][j]``.  ``comm`` is the position's ``Collectives`` handle for
its model row: the four operations the reference's shard-mapped
programs use over the ``model`` axis —

- ``axis_index()`` / ``axis_size()`` (``lax.axis_index`` / ``axis_size``);
- ``psum(x)``, the integer sum behind the flat program's ``por`` /
  ``vbcast`` and the legacy program's ``_pany`` (``por(x)`` is its
  boolean OR);
- ``all_gather(x)``, the legacy program's ``_agather`` ([M, ...]).

Each is the identity off a mesh (``OFF``).  The shards of a row meet at
one ``threading.Barrier`` per collective; the last to arrive combines
their inputs once, on the row's first device, and each shard then
copies the result to its own device (no copy at all when the devices
are one).  Every shard makes the same collectives in the same order, so
the combine checks that they agree.

A shard that raises aborts every row's barrier, and a barrier that times
out (``BARRIER_TIMEOUT_S``) breaks: the other shards stop at their next
collective, every thread is joined, and ``run_mesh`` raises the first
shard's own error — nothing hangs and nothing carries on with fewer
shards.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

import torch

#: seconds a shard waits at a collective for the rest of its row
BARRIER_TIMEOUT_S = 600.0


class ShardGroup:
    """The rendezvous of one model row's ``size`` shards."""

    def __init__(self, size: int, timeout: Optional[float] = None) -> None:
        self.size = size
        self._slots: List[Any] = [None] * size
        self._out: Optional[torch.Tensor] = None
        self._barrier = threading.Barrier(
            size, action=self._combine,
            timeout=BARRIER_TIMEOUT_S if timeout is None else timeout)

    def _combine(self) -> None:
        ops = {(op, tuple(x.shape), x.dtype) for op, x in self._slots}
        if len(ops) != 1:
            raise RuntimeError(
                f"the shards of a row disagree on a collective: {sorted(map(str, ops))}")
        op = self._slots[0][0]
        xs = [x for _op, x in self._slots]
        dev = xs[0].device
        if op == "psum":
            out = xs[0]
            for x in xs[1:]:
                out = out + x.to(dev)
        else:
            out = torch.stack([x.to(dev) for x in xs])
        self._out = out
        self._slots = [None] * self.size

    def run(self, index: int, op: str, x: torch.Tensor) -> torch.Tensor:
        self._slots[index] = (op, x)
        self._barrier.wait()
        return self._out

    def abort(self) -> None:
        self._barrier.abort()


class Collectives:
    """One shard's handle on its model row (``group`` None: off a mesh,
    every operation the identity).  ``calls`` / ``seconds`` count this
    shard's collectives and the host time it spent in them, waits for
    the rest of the row included."""

    def __init__(self, group: Optional[ShardGroup], index: int,
                 device: Optional[torch.device]) -> None:
        self.group = group
        self.index = index
        self.device = device
        self.calls = 0
        self.seconds = 0.0

    def axis_index(self) -> int:
        return self.index

    def axis_size(self) -> int:
        return 1 if self.group is None else self.group.size

    def _run(self, op: str, x: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out = self.group.run(self.index, op, x)
        out = out.to(self.device)
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Integer sum over the row, in ``x``'s dtype (the flat program
        sums int32 blocks of which one shard's are nonzero, and 0/1
        flags)."""
        if self.group is None:
            return x
        return self._run("psum", x)

    def por(self, x: torch.Tensor) -> torch.Tensor:
        """Boolean OR over the row."""
        if self.group is None:
            return x
        return self._run("psum", x.to(torch.int32)) > 0

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` stacked in shard order: [M, ...]."""
        if self.group is None:
            return x.unsqueeze(0)
        return self._run("all_gather", x)


#: the off-mesh handle
OFF = Collectives(None, 0, None)


def run_mesh(mesh, body: Callable[[int, int, Collectives], Any],
             timeout: Optional[float] = None):
    """``body(r, j, comm)`` at every position of ``mesh``, each on its
    own thread (under ``torch.no_grad``, which is per thread): the
    results as ``[r][j]`` and the handles as ``[r][j]``.  A one-position
    mesh runs inline with the off-mesh handle.  Raises the first shard's
    own error once every thread has stopped."""
    D, M = len(mesh.devices), len(mesh.devices[0])
    if D * M == 1:
        with torch.no_grad():
            return [[body(0, 0, OFF)]], [[OFF]]
    groups = [ShardGroup(M, timeout) if M > 1 else None for _ in range(D)]
    comms = [[Collectives(groups[r], j, mesh.devices[r][j]) if M > 1
              else Collectives(None, 0, mesh.devices[r][j])
              for j in range(M)] for r in range(D)]
    results: List[List[Any]] = [[None] * M for _ in range(D)]
    errors: List[BaseException] = []
    lock = threading.Lock()

    def work(r: int, j: int) -> None:
        try:
            with torch.no_grad():
                results[r][j] = body(r, j, comms[r][j])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            with lock:
                errors.append(e)
            for g in groups:
                if g is not None:
                    g.abort()

    threads = [
        threading.Thread(target=work, args=(r, j), daemon=True,
                         name=f"gochugaru-shard-{r}.{j}")
        for r in range(D) for j in range(M)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        own = [e for e in errors
               if not isinstance(e, threading.BrokenBarrierError)]
        raise (own or errors)[0]
    return results, comms
