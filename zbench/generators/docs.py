"""Google-Docs nested groups (BASELINE config 3): a frozen copy of the draw
of ``chip_smoke.py::build_docs`` (after ``benchmarks/bench3_docs.py:51-137``),
by object index.

Groups form chains of five (``g[i]`` has the member set ``g[i+1]#member``
unless ``i % 5 == 4``), six users each; folders an arity-16 forest, half
viewed by a group and half by a user; every document sits in one folder,
a fifth have a user viewer, and group viewers of documents fill the world
up to ``edges`` relationships.
"""

from __future__ import annotations

import numpy as np

from ..world import World


def generate(schema, seed, *, n_users, n_groups, n_folders, n_docs, edges):
    w = World(schema, {"user": ("u", n_users), "group": ("g", n_groups),
                       "folder": ("f", n_folders), "document": ("d", n_docs)})
    rng = np.random.default_rng(seed)
    chain = np.arange(n_groups - 1)
    deep = chain[(chain % 5) != 4]
    w.add("group", "member", "group", "member", deep, deep + 1)
    gm_res = np.repeat(np.arange(n_groups), 6)
    w.add("group", "member", "user", "", gm_res, rng.choice(n_users, gm_res.shape[0]))
    f_idx = np.arange(1, n_folders)
    w.add("folder", "parent", "folder", "", f_idx, (f_idx - 1) // 16)
    fv = rng.random(n_folders) < 0.5
    folders = np.arange(n_folders)
    w.add("folder", "viewer", "group", "member", folders[fv],
          rng.choice(n_groups, int(fv.sum())))
    w.add("folder", "viewer", "user", "", folders[~fv],
          rng.choice(n_users, int((~fv).sum())))
    docs = np.arange(n_docs)
    w.add("document", "folder", "folder", "", docs, rng.choice(n_folders, n_docs))
    extra = rng.random(n_docs) < 0.2
    w.add("document", "viewer", "user", "", docs[extra],
          rng.choice(n_users, int(extra.sum())))
    cur = w.count()
    if cur < edges:
        k = edges - cur
        per_doc = k // n_docs
        dd = np.repeat(docs, per_doc)
        w.add("document", "viewer", "group", "member", dd,
              rng.choice(n_groups, dd.shape[0]))
        rem = k - dd.shape[0]
        if rem:
            w.add("document", "viewer", "user", "", docs[:rem], rng.choice(n_users, rem))
    return w
