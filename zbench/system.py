"""The system under test: a ``gochugaru_tpu_torch`` client on the card,
filled with a generated world through its pre-interned column import.

This is the only module of the harness, with the traffic kinds, that
imports the program.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np


class System:
    def __init__(self, world, check: dict, device: str = "cuda") -> None:
        from gochugaru_tpu_torch import consistency, new_evaluator
        from gochugaru_tpu_torch.utils.context import background

        t0 = time.perf_counter()
        self.world = world
        self.check = check
        self.device = device
        self.client = c = new_evaluator(device=device)
        c.write_schema(background(), world.schema)
        it = c.store.interner
        #: type -> int64 node ids of the program's interner, by object index
        self.ids: Dict[str, np.ndarray] = {
            t: np.asarray(it.node_batch(t, [f"{p}{i}" for i in range(n)]), np.int64)
            for t, (p, n) in world.types.items()
        }
        groups: Dict[tuple, list] = {}
        for r in world.rels:
            groups.setdefault((r.relation, r.subj_rel), []).append(r)
        for (rl, sr), parts in groups.items():
            c.store.import_interned_columns(
                resource_ids=np.concatenate([self.ids[p.res_type][p.res] for p in parts]),
                resource_relation=rl,
                subject_ids=np.concatenate([self.ids[p.subj_type][p.subj] for p in parts]),
                subject_relation=sr,
                touch=True,  # the generators draw repeated pairs
            )
        self.snap = c.store.snapshot_for(consistency.full())
        self.slots = np.asarray(
            [self.snap.compiled.slot_of_name[p] for p in check["permissions"]], np.int32)
        self.dsnap = None
        #: seconds of the client, the interning and the store import
        self.import_s = time.perf_counter() - t0

    def prepare(self) -> float:
        """The first full prepare of the head snapshot on the card, through
        the client's own cache of prepared snapshots; its seconds."""
        c = self.client
        t0 = time.perf_counter()
        engine = c._engine_for(self.snap)
        self.dsnap = c._dsnap_for(engine, self.snap)
        self.sync()
        return time.perf_counter() - t0

    def sync(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def columns(self, res, perm, subj):
        """Interned int32 query columns of index columns."""
        return (self.ids[self.check["resource"]][res].astype(np.int32),
                self.slots[perm],
                self.ids[self.check["subject"]][subj].astype(np.int32))

    def evaluate(self, q_res, q_perm, q_subj) -> np.ndarray:
        """Final verdicts of one bulk batch: the flat program and the probe
        kernels on the card, the flagged rows settled on the host oracle."""
        return self.client._evaluate_columns_direct(
            self.snap, q_res, q_perm, q_subj, latency=False)
