"""GitHub-style RBAC (BASELINE config 2): a frozen copy of the draw of
``chip_smoke.py::build_rbac`` (after ``bench.py:57-126``), by object index.

``rng.choice`` over an array picks by index, so drawing over ``arange(n)``
gives the same objects as the original's draw over interned ids.
"""

from __future__ import annotations

import numpy as np

from ..world import World


def generate(schema, seed, *, n_repos, n_users, n_teams, n_orgs):
    w = World(schema, {"user": ("u", n_users), "team": ("t", n_teams),
                       "org": ("o", n_orgs), "repo": ("r", n_repos)})
    rng = np.random.default_rng(seed)
    users, teams = np.arange(n_users), np.arange(n_teams)
    orgs, repos = np.arange(n_orgs), np.arange(n_repos)
    per_team = max(2, n_users // 10)
    tm_res, tm_subj = [], []
    for t in teams:
        u = rng.choice(users, per_team, replace=False)
        tm_res.append(np.full(per_team, t))
        tm_subj.append(u)
    w.add("team", "member", "user", "", np.concatenate(tm_res), np.concatenate(tm_subj))
    adm, om_t, om_u = [], [], []
    for o in orgs:
        adm.append((o, rng.choice(users)))
        om_t += [(o, t) for t in rng.choice(teams, 2, replace=False)]
        om_u += [(o, u) for u in rng.choice(users, 5, replace=False)]
    for rel, st, sr, pairs in (("admin", "user", "", adm), ("member", "team", "member", om_t),
                               ("member", "user", "", om_u)):
        a = np.asarray(pairs, np.int64).reshape(-1, 2)
        w.add("org", rel, st, sr, a[:, 0], a[:, 1])
    w.add("repo", "org", "org", "", repos, rng.choice(orgs, n_repos))
    w.add("repo", "maintainer", "team", "member", repos, rng.choice(teams, n_repos))
    for _ in range(2):
        w.add("repo", "reader", "user", "", repos, rng.choice(users, n_repos))
    return w
