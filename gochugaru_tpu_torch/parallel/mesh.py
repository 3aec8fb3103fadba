"""Mesh construction: a (data × model) grid of torch devices.

``data`` splits a query batch, ``model`` the bucket-sharded tables
(parallel/sharded.py).  One process drives every position of the grid
(the client, its store and the oracle live in it), as the reference's
single-controller ``jax.sharding.Mesh`` does.  A device may stand at
more than one position: ``[torch.device("cpu")] * 8`` is an 8-position
CPU mesh, ``[cuda:0] * 4`` four shards on one card.

A mesh may also span processes (parallel/multihost.py ``global_mesh``):
``procs[r][j]`` names the process of each position, and this process
drives only its own (``is_local``); a model row whose positions lie in
more than one process reduces across them over ``groups[r]``, a
``torch.distributed`` group of exactly those processes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """``devices[r][j]`` is the device of data row ``r``, model shard
    ``j``.  ``procs`` (None: one process drives every position) is the
    process rank of each position and ``rank`` this process's;
    ``groups[r]`` is data row r's ``torch.distributed`` group where the
    row spans processes (None where it does not)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    procs: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0
    groups: Tuple[Any, ...] = field(default=(), compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    def is_local(self, r: int, j: int) -> bool:
        """Whether this process drives position (r, j)."""
        return self.procs is None or self.procs[r][j] == self.rank

    @property
    def all_local(self) -> bool:
        return self.procs is None or all(
            p == self.rank for row in self.procs for p in row)

    def local_positions(self):
        """This process's positions, row-major."""
        return [(r, j) for r in range(len(self.devices))
                for j in range(len(self.devices[0])) if self.is_local(r, j)]

    def group(self, r: int):
        """Data row r's cross-process group (None: the row is local)."""
        return self.groups[r] if self.groups else None


def make_mesh(
    data: int = 1,
    model: int = 1,
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data × model) mesh.  ``devices=None`` takes the distinct
    CUDA cards (``torch.cuda.device_count()``) and raises when there are
    fewer than ``data * model`` — never a silent CPU mesh.  An explicit
    list may name a device more than once."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model}: both axes need at least 1")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    need = data * model
    if len(devs) < need:
        raise ValueError(
            f"mesh {data}x{model} needs {need} devices, have {len(devs)}")
    return Mesh(tuple(
        tuple(devs[r * model + j] for j in range(model)) for r in range(data)
    ))


def default_mesh(model: int = 1) -> Mesh:
    """Every CUDA card, ``model`` of them to a model row and the rest
    along the data axis."""
    n = torch.cuda.device_count()
    if n == 0 or n % model != 0:
        raise ValueError(f"{n} CUDA devices not divisible by model={model}")
    return make_mesh(n // model, model)
