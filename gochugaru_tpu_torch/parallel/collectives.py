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

On a mesh that spans processes (parallel/mesh.py ``Mesh.procs``) each
process runs threads for its own positions only.  Where a model row
spans processes, its local shards meet at the barrier as above, and the
last to arrive combines their inputs and then makes ONE
``torch.distributed`` call over the row's group: ``all_reduce`` of the
local sum for ``psum``, and for ``all_gather`` an ``all_reduce`` of an
[M, ...] stack that holds this process's shards and zeros elsewhere
(each shard lives in exactly one process, so the sum is the gather).
The group's backend is gloo, which reduces host tensors: the combine
stages through host memory and copies the result back.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

#: seconds a shard waits at a collective for the rest of its row
BARRIER_TIMEOUT_S = 600.0


class ShardGroup:
    """The rendezvous of one model row's ``size`` shards: the ``members``
    this process drives (every shard by default) meet at a barrier, and
    ``pg`` (a ``torch.distributed`` group, or None) joins the row's
    other processes."""

    def __init__(self, size: int, timeout: Optional[float] = None,
                 members: Optional[Sequence[int]] = None, pg=None) -> None:
        self.size = size
        self.members = tuple(range(size)) if members is None else tuple(members)
        self.pg = pg
        #: the all-reduces across processes: calls, host bytes, seconds
        #: (the staging through host memory included)
        self.cross_calls = 0
        self.cross_bytes = 0
        self.cross_s = 0.0
        self._slots: Dict[int, Any] = {}
        self._out: Optional[torch.Tensor] = None
        self._barrier = threading.Barrier(
            len(self.members), action=self._combine,
            timeout=BARRIER_TIMEOUT_S if timeout is None else timeout)

    def _combine(self) -> None:
        slots = [self._slots[j] for j in self.members]
        ops = {(op, tuple(x.shape), x.dtype) for op, x in slots}
        if len(ops) != 1:
            raise RuntimeError(
                f"the shards of a row disagree on a collective: {sorted(map(str, ops))}")
        op = slots[0][0]
        xs = [x for _op, x in slots]
        dev = xs[0].device
        if op == "psum":
            out = xs[0]
            for x in xs[1:]:
                out = out + x.to(dev)
            if self.pg is not None:
                out = self._all_reduce(out)
        elif self.pg is None:
            out = torch.stack([x.to(dev) for x in xs])
        else:
            full = torch.zeros((self.size,) + tuple(xs[0].shape),
                               dtype=xs[0].dtype, device=dev)
            for j, x in zip(self.members, xs):
                full[j] = x.to(dev)
            out = self._all_reduce(full)
        self._out = out
        self._slots = {}

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the row's processes, staged through host memory (a
        boolean tensor sums as int32: gloo has no boolean reduce)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        flag = x.dtype == torch.bool
        host = x.to("cpu", torch.int32) if flag else x.cpu()
        dist.all_reduce(host, group=self.pg)
        out = (host != 0 if flag else host).to(x.device)
        self.cross_calls += 1
        self.cross_bytes += host.numel() * host.element_size()
        self.cross_s += time.perf_counter() - t0
        return out

    def run(self, index: int, op: str, x: torch.Tensor) -> torch.Tensor:
        self._slots[index] = (op, x)
        self._barrier.wait()
        return self._out

    def abort(self) -> None:
        self._barrier.abort()


class Collectives:
    """One shard's handle on its model row (``group`` None: off a mesh,
    every operation the identity).  ``calls`` / ``seconds`` / ``bytes``
    count this shard's collectives, the host time it spent in them (waits
    for the rest of the row included) and the bytes it put in."""

    def __init__(self, group: Optional[ShardGroup], index: int,
                 device: Optional[torch.device]) -> None:
        self.group = group
        self.index = index
        self.device = device
        self.calls = 0
        self.seconds = 0.0
        self.bytes = 0

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
        self.bytes += x.numel() * x.element_size()
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
    """``body(r, j, comm)`` at every position of ``mesh`` this process
    drives, each on its own thread (under ``torch.no_grad``, which is per
    thread): the results as ``[r][j]`` and the handles as ``[r][j]``
    (None at another process's positions).  A one-position mesh runs
    inline with the off-mesh handle.  Raises the first shard's own error
    once every thread has stopped."""
    D, M = len(mesh.devices), len(mesh.devices[0])
    if D * M == 1:
        with torch.no_grad():
            return [[body(0, 0, OFF)]], [[OFF]]
    local = [[mesh.is_local(r, j) for j in range(M)] for r in range(D)]
    groups = [ShardGroup(M, timeout,
                         members=[j for j in range(M) if local[r][j]],
                         pg=mesh.group(r))
              if M > 1 and any(local[r]) else None for r in range(D)]
    comms = [[(Collectives(groups[r], j, mesh.devices[r][j]) if M > 1
               else Collectives(None, 0, mesh.devices[r][j]))
              if local[r][j] else None
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
        for r in range(D) for j in range(M) if local[r][j]
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
