"""The port's latency path on the card: a replayed CUDA graph gives the
eager planes, a capture that fails raises, every time, without leaving a
pin behind, and the revisions of a delta chain share one graph, each
answering its own revision.

The module imports only the port (no JAX), so it runs on a machine with an
NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_latency_cuda.py`` from the repository root.  Its world
generators serve tests/test_torch_latency.py too, which holds the port
against the reference on the CPU.  All outputs are int or bool: the
tolerance is exact equality.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.store.delta import apply_delta as p_apply
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot as p_build_rels
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build

# the reference's rbac_world (tests/test_latency_path.py:27-95)
RBAC_SCHEMA = """
definition user {}
definition team { relation member: user }
definition org {
    relation admin: user
    relation member: user | team#member
}
definition repo {
    relation org: org
    relation maintainer: user | team#member
    relation reader: user
    permission admin = org->admin + maintainer
    permission read = reader + admin + org->member
}
"""

EPOCH = 1_700_000_000_000_000


def _rbac(compile_, parse, interner, build, n_users=40, n_teams=4, n_orgs=3,
          n_repos=25, seed=7):
    """The reference's build_rbac_world, in either package's terms."""
    cs = compile_(parse(RBAC_SCHEMA))
    rng = np.random.default_rng(seed)
    users = np.array([interner.node("user", f"u{i}") for i in range(n_users)], np.int64)
    teams = np.array([interner.node("team", f"t{i}") for i in range(n_teams)], np.int64)
    orgs = np.array([interner.node("org", f"o{i}") for i in range(n_orgs)], np.int64)
    repos = np.array([interner.node("repo", f"r{i}") for i in range(n_repos)], np.int64)
    slot = cs.slot_of_name
    res, rel_s, subj, srel = [], [], [], []

    def add(r, rl, s, sr):
        res.append(r); rel_s.append(rl); subj.append(s); srel.append(sr)

    for t in teams:
        for u in rng.choice(users, 6, replace=False):
            add(t, slot["member"], u, -1)
    for o in orgs:
        add(o, slot["admin"], rng.choice(users), -1)
        add(o, slot["member"], rng.choice(teams), slot["member"])
        for u in rng.choice(users, 3, replace=False):
            add(o, slot["member"], u, -1)
    for r in repos:
        add(r, slot["org"], rng.choice(orgs), -1)
        add(r, slot["maintainer"], rng.choice(teams), slot["member"])
        add(r, slot["reader"], rng.choice(users), -1)
    snap = build(
        1, cs, interner,
        res=np.asarray(res, np.int64), rel=np.asarray(rel_s, np.int64),
        subj=np.asarray(subj, np.int64), srel=np.asarray(srel, np.int64),
        epoch_us=EPOCH,
    )
    return cs, snap, users, repos, slot


def _queries(users, repos, slot, B, seed):
    rng = np.random.default_rng(seed)
    q_res = rng.choice(repos, B).astype(np.int32)
    q_perm = rng.choice(np.array([slot["read"], slot["admin"]], np.int32), B)
    q_subj = rng.choice(users, B).astype(np.int32)
    return q_res, q_perm, q_subj


def _same(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# a delta chain (shared with tests/test_torch_latency.py)
# ---------------------------------------------------------------------------

CHAIN_SCHEMA = """
definition user {}
definition team { relation member: user }
definition doc {
    relation reader: user | team#member
    relation banned: user
    permission view = reader - banned
}
"""


def _chain_world(seed=5, n_users=30, n_teams=5, n_docs=40):
    """Relationship triples of a small doc world, and per revision one
    write: a reader added, and a fresh user ``w<k>`` made the reader of
    a doc (so each revision grants what no earlier one did, and grows the
    node column); at the first also a ban added and a base reader
    removed (so every revision of the chain carries adds and tombstones,
    and its DeltaMeta stays in one band)."""
    rng = np.random.default_rng(seed)
    base = []
    for t in range(n_teams):
        for u in rng.choice(n_users, 4, replace=False):
            base.append((f"team:t{t}", "member", f"user:u{u}"))
    for d in range(n_docs):
        base.append((f"doc:d{d}", "reader", f"user:u{rng.integers(n_users)}"))
        base.append((f"doc:d{d}", "reader", f"team:t{rng.integers(n_teams)}#member"))
        if d % 4 == 0:
            base.append((f"doc:d{d}", "banned", f"user:u{rng.integers(n_users)}"))
    base = sorted(set(base))
    readers = [t for t in base if t[1] == "reader" and t[2].startswith("user:")]
    writes = []
    for k in range(8):
        adds = [(f"doc:d{rng.integers(n_docs)}", "reader", f"user:u{rng.integers(n_users)}"),
                (f"doc:d{rng.integers(n_docs)}", "reader", f"user:w{k}")]
        dels = []
        if k == 0:
            adds.append((f"doc:d{rng.integers(n_docs)}", "banned",
                         f"user:u{rng.integers(n_users)}"))
            dels.append(readers[0])
        writes.append((adds, dels))
    return base, writes, (n_users, n_docs)


def _chain_queries(interner, writes, n_users, n_docs, slot, B=300, seed=9):
    """``view`` over random (doc, user) pairs and every pair a write
    touched, as interned columns."""
    rng = np.random.default_rng(seed)
    pairs = [(f"d{rng.integers(n_docs)}", f"u{rng.integers(n_users)}")
             for _ in range(B)]
    for adds, dels in writes:
        for r, _rel, s in adds + dels:
            pairs.append((r.split(":")[1], s.split(":")[1]))
    q_res = np.array([interner.lookup("doc", d) for d, _u in pairs], np.int32)
    q_subj = np.array([interner.lookup("user", u) for _d, u in pairs], np.int32)
    assert (q_res >= 0).all() and (q_subj >= 0).all()
    return q_res, np.full(len(pairs), slot, np.int32), q_subj


# ---------------------------------------------------------------------------
# the card: graph replay == eager, and a capture failure raises
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return "cuda"


@pytest.mark.cuda
def test_graph_replay_equals_eager_and_capture_failure_raises(cuda_device):
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    pe = PEngine(cs, PConfig(kernels=True), device=cuda_device)
    ds = pe.prepare(snap)
    lp = pe.latency_path(ds)
    for B in (1, 200, 900):
        q = _queries(users, repos, slot, B, seed=B)
        assert _same(lp.dispatch_columns(*q, now_us=EPOCH),
                     pe.check_columns(ds, *q, now_us=EPOCH))
    assert all(pin.graph is not None for pin in lp.pins().values())

    def syncing(*args):
        d, p, o = fn(*args)
        if bool(d.any()):  # a host sync: no graph can hold it
            pass
        return d, p, o

    fn = pe._flat_fn_for((slot["read"],), ds.flat_meta)
    pe._flat_fns[((slot["read"],), ds.flat_meta)] = syncing
    q = _queries(users, repos, slot, 100, seed=5)
    q = (q[0], np.full_like(q[1], slot["read"]), q[2])
    # a path over the same tensors would share the pins above: start the
    # engine's cache empty so this path captures with the syncing program
    pe._latency_pins.clear()
    bad = pe.latency_path(dataclasses.replace(ds, latency_path=None))
    for _ in range(2):  # the failed pin is dropped: no broken graph replays
        with pytest.raises(RuntimeError):
            bad.dispatch_columns(*q, now_us=EPOCH)
        assert bad.pins() == {} and bad.dispatch_count == 0
        assert not torch.cuda.is_current_stream_capturing()
    assert bad.compile_count == 2
    pe._flat_fns[((slot["read"],), ds.flat_meta)] = fn
    assert _same(bad.dispatch_columns(*q, now_us=EPOCH),
                 pe.check_columns(ds, *q, now_us=EPOCH))
    assert bad.compile_count == 3 and bad.dispatch_count == 1


@pytest.mark.cuda
def test_delta_chain_graph_switches_revisions(cuda_device):
    """Six revisions of one shape band on one captured graph, dispatched
    A -> B -> A -> C ...: every replay equals its own revision's eager
    kernel planes (the revisions' answers differ), the chain captures
    once, and a revision's first dispatch copies its overlays."""
    base, writes, (n_users, n_docs) = _chain_world()
    cs = p_compile(p_parse(CHAIN_SCHEMA))
    interner = PInterner()
    for i in range(n_users):
        interner.node("user", f"u{i}")
    snap = p_build_rels(1, cs, interner, [prel.must_from_triple(*t) for t in base],
                        epoch_us=EPOCH)
    pe = PEngine(cs, PConfig(kernels=True), device=cuda_device)
    revs = [pe.prepare(snap)]
    for rev, (adds, dels) in enumerate(writes[:6], start=2):
        snap = p_apply(snap, rev, [prel.must_from_triple(*t) for t in adds],
                       [prel.must_from_triple(*t) for t in dels], interner=interner)
        revs.append(pe.prepare(snap, prev=revs[-1]))
    deltas = revs[1:]
    assert all(d.flat_meta.delta is not None for d in deltas)
    q = _chain_queries(interner, writes[:6], n_users, n_docs, cs.slot_of_name["view"])
    planes = {}
    for i in (0, 1, 0, 2, 3, 1, 4, 5, 5, 0):
        lp = pe.latency_path(deltas[i])
        got = lp.dispatch_columns(*q, now_us=EPOCH)
        assert _same(got, pe.check_columns(deltas[i], *q, now_us=EPOCH)), i
        assert lp.last_budget.rebind_bytes > 0 or i in planes
        planes.setdefault(i, got[0].copy())
    assert len({p.tobytes() for p in planes.values()}) == len(planes)
    paths = [pe.latency_path(d) for d in deltas]
    assert [lp.compile_count for lp in paths] == [1, 0, 0, 0, 0, 0]
    pins = {id(p): p for lp in paths for p in lp.pins().values()}
    assert len(pins) == 1 and all(p.graph is not None for p in pins.values())
    # a second tier is a second graph over the band's one set of buffers
    small = tuple(c[:200] for c in q)
    for i in (0, 1, 0):
        lp = pe.latency_path(deltas[i])
        assert _same(lp.dispatch_columns(*small, now_us=EPOCH),
                     pe.check_columns(deltas[i], *small, now_us=EPOCH)), i
    pins = list(paths[0].pins().values())
    assert len(pins) == 2 and pins[0].band is pins[1].band
    assert all(p.graph is not None for p in pins)
    assert sum(lp.compile_count for lp in paths) == 2
    # once no revision of the chain is left, its pins go with the graph
    # pool they shared, and a new snapshot captures into a pool of its own
    del lp, paths, pins, revs, deltas
    gc.collect()
    assert not pe._latency_pins and not pe._latency_bands
    ds = pe.prepare(snap)
    lp = pe.latency_path(ds)
    assert _same(lp.dispatch_columns(*q, now_us=EPOCH),
                 pe.check_columns(ds, *q, now_us=EPOCH))
    assert lp.compile_count == 1
