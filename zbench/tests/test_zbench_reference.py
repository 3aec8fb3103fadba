"""The plain references on tiny hand-built worlds whose answers are worked
out by hand, and their controls."""

import numpy as np
import pytest

from zbench.reference import docs, rbac
from zbench.world import World


def rbac_world():
    """u0 in team t0; org o0: admin u1, member team t0#member and user u2;
    r0 in o0; r1 maintained by t0#member, read by u3; r2 in no org, read
    by u2."""
    w = World("", {"user": ("u", 5), "team": ("t", 1), "org": ("o", 1), "repo": ("r", 3)})
    w.add("team", "member", "user", "", [0], [0])
    w.add("org", "admin", "user", "", [0], [1])
    w.add("org", "member", "team", "member", [0], [0])
    w.add("org", "member", "user", "", [0], [2])
    w.add("repo", "org", "org", "", [0], [0])
    w.add("repo", "maintainer", "team", "member", [1], [0])
    w.add("repo", "reader", "user", "", [1, 2], [3, 2])
    return w


# (repo, user) -> (read, admin), by hand
RBAC_ANSWERS = {
    (0, 0): (True, False),   # org member through team t0
    (0, 1): (True, True),    # org admin
    (0, 2): (True, False),   # org member directly
    (0, 3): (False, False),
    (0, 4): (False, False),
    (1, 0): (True, True),    # maintainer through team t0
    (1, 1): (False, False),  # r1 is in no org
    (1, 3): (True, False),   # reader
    (2, 2): (True, False),   # reader
    (2, 0): (False, False),
}


@pytest.mark.parametrize("control", [False, True])
def test_rbac_by_hand(control):
    ref = rbac.Reference(rbac_world(), control=control)
    pairs = sorted(RBAC_ANSWERS)
    r = np.array([p[0] for p in pairs])
    u = np.array([p[1] for p in pairs])
    read = ref.check("read", r, u)
    admin = ref.check("admin", r, u)
    for i, p in enumerate(pairs):
        want_read, want_admin = RBAC_ANSWERS[p]
        if control and p[1] == 0:  # u0 holds everything through team t0
            want_read = want_admin = False
        assert (bool(read[i]), bool(admin[i])) == (want_read, want_admin), p


def test_rbac_unknown_permission():
    with pytest.raises(ValueError):
        rbac.Reference(rbac_world()).check("write", [0], [0])


def docs_world():
    """Groups: g0 has members g1#member; g1 has member u0; g2 has u1.
    Folders: f0 root, f1 under f0, f2 under f1; f0 viewed by g0#member, f2
    by u2.  Docs: d0 in f2; d1 in f1, viewed by u3; d2 in no viewed chain
    (folder f3, a root nobody views), viewed by g2#member; d3 in f3."""
    w = World("", {"user": ("u", 5), "group": ("g", 3), "folder": ("f", 4),
                   "document": ("d", 4)})
    w.add("group", "member", "group", "member", [0], [1])
    w.add("group", "member", "user", "", [1, 2], [0, 1])
    w.add("folder", "parent", "folder", "", [1, 2], [0, 1])
    w.add("folder", "viewer", "group", "member", [0], [0])
    w.add("folder", "viewer", "user", "", [2], [2])
    w.add("document", "folder", "folder", "", [0, 1, 2, 3], [2, 1, 3, 3])
    w.add("document", "viewer", "user", "", [1], [3])
    w.add("document", "viewer", "group", "member", [2], [2])
    return w


# the users who can view each document, by hand
DOCS_VIEWERS = {
    0: {0, 2},  # u0 through g1 -> g0 -> f0 -> f1 -> f2; u2 on f2
    1: {0, 3},  # u0 through f0; u3 directly
    2: {1},     # g2#member
    3: set(),
}


@pytest.mark.parametrize("control", [False, True])
def test_docs_checks_by_hand(control):
    ref = docs.Reference(docs_world(), control=control)
    d, u = np.meshgrid(np.arange(4), np.arange(5), indexing="ij")
    got = ref.check("view", d.ravel(), u.ravel()).reshape(4, 5)
    for doc, viewers in DOCS_VIEWERS.items():
        want = viewers - ({0} if control else set())  # u0 only through nesting
        assert set(np.nonzero(got[doc])[0].tolist()) == want, doc


@pytest.mark.parametrize("control", [False, True])
def test_docs_lookups_by_hand(control):
    ref = docs.Reference(docs_world(), control=control)
    for doc, viewers in DOCS_VIEWERS.items():
        want = sorted(viewers - ({0} if control else set()))
        assert ref.lookup_subjects(doc).tolist() == want, doc
    for user in range(5):
        want = sorted(d for d, v in DOCS_VIEWERS.items() if user in v
                      and not (control and user == 0))
        assert ref.lookup_resources(user).tolist() == want, user


def test_docs_deep_folder_chain():
    """A viewer of the root folder reaches a document ten folders down."""
    w = World("", {"user": ("u", 1), "group": ("g", 1), "folder": ("f", 11),
                   "document": ("d", 1)})
    w.add("folder", "parent", "folder", "", np.arange(1, 11), np.arange(10))
    w.add("folder", "viewer", "user", "", [0], [0])
    w.add("document", "folder", "folder", "", [0], [10])
    ref = docs.Reference(w)
    assert ref.check("view", [0], [0]).tolist() == [True]
    assert ref.lookup_resources(0).tolist() == [0]
    assert ref.lookup_subjects(0).tolist() == [0]
