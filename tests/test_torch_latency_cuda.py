"""The port's latency path on the card: a replayed CUDA graph gives the
eager planes, and a capture that fails raises, every time, without
leaving a pin behind.

The module imports only the port (no JAX), so it runs on a machine with an
NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_latency_cuda.py`` from the repository root.  Its world
generators serve tests/test_torch_latency.py too, which holds the port
against the reference on the CPU.  All outputs are int or bool: the
tolerance is exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
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
