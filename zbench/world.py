"""A generated deployment as plain columns: the input both the program and
the plain reference are given.

Objects are (type, index) pairs; index ``i`` of type ``t`` is the object id
``<prefix of t><i>``.  Relationships come in groups of one (resource type,
relation, subject type, subject relation), as two int64 index columns.
Imports nothing of the program.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Rel:
    res_type: str
    relation: str
    subj_type: str
    subj_rel: str  # "" for a direct subject
    res: np.ndarray
    subj: np.ndarray


@dataclass
class World:
    schema: str
    #: type -> (id prefix, object count), in the order objects are interned
    types: Dict[str, Tuple[str, int]]
    rels: List[Rel] = field(default_factory=list)
    #: type -> the generator's object index -> this world's (``relabel``)
    perm: Dict[str, np.ndarray] = field(default_factory=dict)

    def add(self, res_type, relation, subj_type, subj_rel, res, subj) -> None:
        res = np.asarray(res, np.int64).reshape(-1)
        subj = np.asarray(subj, np.int64).reshape(-1)
        if res.shape != subj.shape:
            raise ValueError("resource and subject columns differ in length")
        self.rels.append(Rel(res_type, relation, subj_type, subj_rel, res, subj))

    def n(self, t: str) -> int:
        return self.types[t][1]

    def name(self, t: str, i: int) -> str:
        return f"{self.types[t][0]}{int(i)}"

    def edges(self, res_type, relation, subj_type, subj_rel=""):
        """(res, subj) of every relationship of that group, concatenated
        over the groups the generator wrote."""
        parts = [r for r in self.rels
                 if (r.res_type, r.relation, r.subj_type, r.subj_rel)
                 == (res_type, relation, subj_type, subj_rel)]
        if not parts:
            z = np.zeros(0, np.int64)
            return z, z
        return (np.concatenate([p.res for p in parts]),
                np.concatenate([p.subj for p in parts]))

    def count(self) -> int:
        return int(sum(r.res.shape[0] for r in self.rels))


def generate(config: dict, seed: int) -> World:
    """The world of ``config`` for ``seed``: the generator it names draws the
    deployment from the configuration's ``world_seed``, and ``seed`` relabels
    every object.  Every seed so gets the same graph, and so the same work,
    under other object ids: other interned ids, other hash buckets, other
    table rows."""
    mod = importlib.import_module(f"zbench.generators.{config['generator']}")
    return relabel(mod.generate(config["schema"], config["world_seed"], **config["sizes"]), seed)


def relabel(w: World, seed: int) -> World:
    """``w`` with the objects of each type permuted, from ``seed``."""
    r = np.random.default_rng([int(seed) % (1 << 63), 0])
    perm = {t: r.permutation(n) for t, (_, n) in w.types.items()}
    out = World(w.schema, dict(w.types), perm=perm)
    for g in w.rels:
        out.add(g.res_type, g.relation, g.subj_type, g.subj_rel,
                perm[g.res_type][g.res], perm[g.subj_type][g.subj])
    return out
