"""The plain reference of the Google-Docs nested-groups schema:

    group.member: user | group#member
    folder.parent: folder;   folder.viewer: user | group#member
    folder.view   = viewer + parent->view
    document.folder: folder; document.viewer: user | group#member
    document.view = viewer + folder->view

Checks of ``view`` and both lookups.  ``control=True`` is the benchmark's
control: group membership stops at a user's own groups (no ``group#member``
nesting), so answers that only a nested group grants come out wrong.
"""

from __future__ import annotations

import numpy as np

from .graph import Edges, any_by, closure


class Reference:
    def __init__(self, world, control: bool = False) -> None:
        n = world.n
        self.world = world
        self.control = control
        self.n_groups = n("group")
        self.n_folders = n("folder")

        def rel(rt, r, st, sr=""):
            a, b = world.edges(rt, r, st, sr)
            return Edges(a, b, n(rt), n(st))

        self.gm_user = rel("group", "member", "user")
        self.gm_group = rel("group", "member", "group", "member")
        self.parent = rel("folder", "parent", "folder")
        self.fv_user = rel("folder", "viewer", "user")
        self.fv_group = rel("folder", "viewer", "group", "member")
        self.dfolder = rel("document", "folder", "folder")
        self.dv_user = rel("document", "viewer", "user")
        self.dv_group = rel("document", "viewer", "group", "member")
        # the reverse relations, for the lookups and for a user's groups
        self.user_groups = self.gm_user.reverse(n("group"))
        self.group_parents = self.gm_group.reverse(n("group"))
        self.children = self.parent.reverse(n("folder"))
        self.user_fv = self.fv_user.reverse(n("folder"))
        self.group_fv = self.fv_group.reverse(n("folder"))
        self.user_dv = self.dv_user.reverse(n("document"))
        self.group_dv = self.dv_group.reverse(n("document"))
        self.folder_docs = self.dfolder.reverse(n("document"))

    # -- a user's groups ---------------------------------------------------
    def _groups(self, u):
        """(row, group): every group whose members include user u[row]."""
        row, g = self.user_groups.expand(u)
        if self.control:
            return row, g
        return closure(row, g, self.group_parents, self.n_groups)

    def check(self, perm: str, res, subj) -> np.ndarray:
        if perm != "view":
            raise ValueError(f"docs reference: no permission {perm!r}")
        d = np.asarray(res, np.int64)
        u = np.asarray(subj, np.int64)
        B = d.shape[0]
        grow, gg = self._groups(u)
        groups_of = Edges(grow, gg, B, self.n_groups)
        # document.viewer
        out = self.dv_user.has(d, u)
        out |= any_by(grow, self.dv_group.has(d[grow], gg), B)
        # folder->view: each query's folder and its ancestors
        row, f = self.dfolder.expand(d)
        row, f = closure(row, f, self.parent, self.n_folders)
        out |= any_by(row, self.fv_user.has(f, u[row]), B)
        pr, g = groups_of.expand(row)
        out |= any_by(row[pr], self.fv_group.has(f[pr], g), B)
        return out

    # -- lookups -----------------------------------------------------------
    def lookup_resources(self, user: int) -> np.ndarray:
        """Sorted document indices the user can ``view``."""
        u = np.asarray([user], np.int64)
        _, gs = self._groups(u)
        docs = [self.user_dv.expand(u)[1], self.group_dv.expand(gs)[1]]
        f0 = np.concatenate([self.user_fv.expand(u)[1], self.group_fv.expand(gs)[1]])
        _, fs = closure(np.zeros(f0.shape[0], np.int64), f0, self.children, self.n_folders)
        docs.append(self.folder_docs.expand(fs)[1])
        return np.unique(np.concatenate(docs))

    def lookup_subjects(self, doc: int) -> np.ndarray:
        """Sorted user indices that can ``view`` the document."""
        d = np.asarray([doc], np.int64)
        _, f = self.dfolder.expand(d)
        _, fs = closure(np.zeros(f.shape[0], np.int64), f, self.parent, self.n_folders)
        users = [self.dv_user.expand(d)[1], self.fv_user.expand(fs)[1]]
        g0 = np.concatenate([self.dv_group.expand(d)[1], self.fv_group.expand(fs)[1]])
        if self.control:
            gs = np.unique(g0)
        else:
            _, gs = closure(np.zeros(g0.shape[0], np.int64), g0, self.gm_group, self.n_groups)
        users.append(self.gm_user.expand(gs)[1])
        return np.unique(np.concatenate(users))
