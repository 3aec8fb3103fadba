"""The plain reference of the GitHub-style RBAC schema:

    team.member: user
    org.admin: user;   org.member: user | team#member
    repo.org: org;     repo.maintainer: user | team#member;   repo.reader: user
    repo.admin = org->admin + maintainer
    repo.read  = reader + admin + org->member

``control=True`` is the benchmark's control: it drops every ``team#member``
subject set, so answers that only a team grants come out wrong.
"""

from __future__ import annotations

import numpy as np

from .graph import Edges, any_by


class Reference:
    def __init__(self, world, control: bool = False) -> None:
        n = world.n
        self.control = control

        def rel(rt, r, st, sr=""):
            a, b = world.edges(rt, r, st, sr)
            return Edges(a, b, n(rt), n(st))

        self.team_member = rel("team", "member", "user")
        self.org_admin = rel("org", "admin", "user")
        self.org_member_user = rel("org", "member", "user")
        self.org_member_team = rel("org", "member", "team", "member")
        self.repo_org = rel("repo", "org", "org")
        self.maint_user = rel("repo", "maintainer", "user")
        self.maint_team = rel("repo", "maintainer", "team", "member")
        self.reader = rel("repo", "reader", "user")

    def _via(self, first: Edges, a, u, second) -> np.ndarray:
        """any x: (a, x) in first and second(x, u)."""
        row, x = first.expand(a)
        return any_by(row, second(x, u[row]), a.shape[0])

    def _team_member(self, t, u):
        return self.team_member.has(t, u)

    def _userset(self, user_edges: Edges, team_edges: Edges, a, u):
        hit = user_edges.has(a, u)
        if not self.control:
            hit |= self._via(team_edges, a, u, self._team_member)
        return hit

    def _admin(self, r, u):
        return (self._via(self.repo_org, r, u, self.org_admin.has)
                | self._userset(self.maint_user, self.maint_team, r, u))

    def _org_member(self, o, u):
        return self._userset(self.org_member_user, self.org_member_team, o, u)

    def check(self, perm: str, res, subj) -> np.ndarray:
        r = np.asarray(res, np.int64)
        u = np.asarray(subj, np.int64)
        if perm == "admin":
            return self._admin(r, u)
        if perm == "read":
            return (self.reader.has(r, u) | self._admin(r, u)
                    | self._via(self.repo_org, r, u, self._org_member))
        raise ValueError(f"rbac reference: no permission {perm!r}")
