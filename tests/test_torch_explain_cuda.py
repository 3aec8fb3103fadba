"""Decision provenance of the port on the card: the armed flat program
(``make_flat_fn(witness=True)``) with the hand-written kernels gives the
same witness codes and check planes as with their plain PyTorch twins,
under both layouts; an armed latency pin's codes equal the eager ones; and
``Client.explain`` on ``cuda`` gives the trees of a ``cpu`` client.

The module imports only the port (no JAX), so it runs on a machine with an
NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_explain_cuda.py`` from the repository root.  Its world
generator serves tests/test_torch_explain.py and
tests/test_torch_client_options.py too, which hold the port against the
reference on the CPU.  Codes are int32 and verdicts bool: the tolerance is
exact equality.
"""

import datetime as dt

import numpy as np
import pytest
import torch

#: the reference's decision-provenance world (tests/test_explain.py:29-45)
SCHEMA = """
caveat tier_at_least(tier int, minimum int) { tier >= minimum }
definition user {}
definition team { relation member: user | team#member }
definition folder {
    relation parent: folder
    relation viewer: user | team#member
    permission view = viewer + parent->view
}
definition doc {
    relation folder: folder
    relation reader: user | user:* | team#member | user with tier_at_least
    relation banned: user
    permission read = (reader - banned) + folder->view
}
"""

NOW_S = 1_700_000_000
NOW_US = NOW_S * 1_000_000


def _world_txn(rel, seed, *, n_users=24, n_teams=5, n_folders=6, n_docs=18,
               wildcard_docs=2):
    """The reference's randomized explain world (tests/test_explain.py
    ``_build_world``) as one transaction of ``rel``'s package: nested
    teams, a folder parent chain, direct / wildcard / userset / caveated /
    expiring readers and bans; expirations an hour either side of
    ``NOW_S``.  Returns (txn, rng): the rng continues into the checks."""
    rng = np.random.default_rng(seed)
    txn = rel.Txn()
    for t in range(n_teams):
        for u in rng.choice(n_users, 3, replace=False):
            txn.touch(rel.must_from_tuple(f"team:t{t}#member", f"user:u{u}"))
        if t + 1 < n_teams:
            txn.touch(rel.must_from_tuple(f"team:t{t}#member",
                                          f"team:t{t + 1}#member"))
    for f in range(n_folders):
        if f + 1 < n_folders:
            txn.touch(rel.must_from_triple(f"folder:f{f + 1}", "parent",
                                           f"folder:f{f}"))
        if rng.random() < 0.7:
            txn.touch(rel.must_from_triple(
                f"folder:f{f}", "viewer", f"user:u{rng.integers(n_users)}"))
        if rng.random() < 0.3:
            txn.touch(rel.must_from_tuple(
                f"folder:f{f}#viewer", f"team:t{rng.integers(n_teams)}#member"))
    for d in range(n_docs):
        txn.touch(rel.must_from_triple(f"doc:d{d}", "folder",
                                       f"folder:f{d % n_folders}"))
        for u in rng.choice(n_users, 2, replace=False):
            r = rel.must_from_triple(f"doc:d{d}", "reader", f"user:u{u}")
            roll = rng.random()
            if roll < 0.2:  # stored-context caveat
                r = r.with_caveat("tier_at_least", {"minimum": 5})
            elif roll < 0.35:  # expiring edge: half already expired
                r = r.with_expiration(dt.datetime.fromtimestamp(
                    NOW_S + (3600 if rng.random() < 0.5 else -3600),
                    tz=dt.timezone.utc))
            txn.touch(r)
        if rng.random() < 0.5:
            txn.touch(rel.must_from_tuple(
                f"doc:d{d}#reader", f"team:t{rng.integers(n_teams)}#member"))
        if d < wildcard_docs:
            txn.touch(rel.must_from_triple(f"doc:d{d}", "reader", "user:*"))
        if rng.random() < 0.25:
            txn.touch(rel.must_from_triple(
                f"doc:d{d}", "banned", f"user:u{rng.integers(n_users)}"))
    return txn, rng


def _world_checks(rel, rng, n, *, n_users=24, n_docs=18, n_folders=6):
    """The reference's random checks (doc read/reader, a fifth with a
    request context), plus folder ``view`` checks: the permission fold's
    root site."""
    out = []
    for _ in range(n):
        if rng.random() < 0.2:
            out.append(rel.must_from_triple(
                f"folder:f{rng.integers(n_folders)}", "view",
                f"user:u{rng.integers(n_users)}"))
            continue
        r = rel.must_from_triple(
            f"doc:d{rng.integers(n_docs)}",
            str(rng.choice(["read", "reader"])),
            f"user:u{rng.integers(n_users)}")
        if rng.random() < 0.2:
            r = r.with_caveat("", {"tier": int(rng.integers(0, 10))})
        out.append(r)
    return out


def _tree(t):
    """An explain result without its timing field."""
    return {k: v for k, v in t.items() if k != "duration_ms"}


# ---------------------------------------------------------------------------
# the card: the armed program with kernels == with plain twins
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return "cuda"


def _port_world(seed, n_checks, *opts, device="cpu"):
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import new_evaluator
    from gochugaru_tpu_torch.utils.context import background

    c = new_evaluator(*opts, device=device)
    ctx = background()
    c.write_schema(ctx, SCHEMA)
    txn, rng = _world_txn(rel, seed)
    c.write(ctx, txn)
    return c, ctx, consistency, _world_checks(rel, rng, n_checks)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True], ids=["off", "aligned"])
def test_armed_program_kernels_equal_plain(cuda_device, aligned):
    """Codes and planes of the armed program with the kernels equal those
    with the plain twins on the same card and snapshot; the armed planes
    equal the disarmed ones; the armed run launched a kernel."""
    from gochugaru_tpu_torch.client import with_host_only_evaluation
    from gochugaru_tpu_torch.engine import kernels as K
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig

    c, _ctx, cons, checks = _port_world(5, 200, with_host_only_evaluation())
    snap = c.store.snapshot_for(cons.full())
    cfg = {"flat_aligned": True} if aligned else {}
    ek = DeviceEngine(snap.compiled, EngineConfig(kernels=True, **cfg),
                      device=cuda_device)
    ep = DeviceEngine(snap.compiled, EngineConfig(kernels=False, **cfg),
                      device=cuda_device)
    ds = ek.prepare(snap)
    queries, _qctx = ek._lower_queries(snap, checks, ds.strings)
    cols = {k: queries[k] for k in ("q_srel", "q_wc", "q_ctx")}
    rows = [r.caveat_context for r in checks if r.caveat_context] or None
    K.reset_launches()
    got_k, planes_k = ek.witness_codes_columns(
        ds, queries["q_res"], queries["q_perm"], queries["q_subj"],
        qctx_rows=rows, now_us=NOW_US, planes=True, **cols)
    assert sum(K.LAUNCHES.values()) > 0
    got_p, planes_p = ep.witness_codes_columns(
        ds, queries["q_res"], queries["q_perm"], queries["q_subj"],
        qctx_rows=rows, now_us=NOW_US, planes=True, **cols)
    assert got_k.dtype == np.int32
    assert np.array_equal(got_k, got_p)
    for a, b in zip(planes_k, planes_p):
        assert np.array_equal(a, b)
    disarmed = ek.check_columns(
        ds, queries["q_res"], queries["q_perm"], queries["q_subj"],
        qctx_rows=rows, now_us=NOW_US, **cols)
    for a, b in zip(planes_k, disarmed):
        assert np.array_equal(a, b)
    assert (got_k != 0).any()


@pytest.mark.cuda
def test_armed_latency_pin_and_explain_on_cuda(cuda_device):
    """An armed pin replays the eager codes (host-settled rows aside) on
    pins of its own; ``Client.explain`` and ``check(explain=True)`` on
    ``cuda`` give a ``cpu`` client's trees."""
    from gochugaru_tpu_torch.client import with_latency_mode

    c, ctx, cons, checks = _port_world(11, 120, with_latency_mode(),
                                       device=cuda_device)
    cpu, cctx, _cons, _checks = _port_world(11, 120)
    snap = c.store.snapshot_for(cons.full())
    engine = c._engine_for(snap)
    ds = c._dsnap_for(engine, snap)
    lp = engine.latency_path(ds)
    d, p, ovf = engine.check_batch(ds, checks, now_us=NOW_US, latency=True)
    disarmed = set(lp.pins())
    lp.arm_witness()
    want = engine.witness_codes(ds, checks, now_us=NOW_US)
    for _ in range(3):
        engine.check_batch(ds, checks, now_us=NOW_US, latency=True)
        wit = lp.last_witness.copy()
        wit[(p & ~d) | ovf] = 0
        assert np.array_equal(wit, want)
    armed = set(lp.pins()) - disarmed
    assert armed and all(k[-1] == "wit" for k in armed)
    assert all(p_.graph is not None for p_ in lp.pins().values())
    assert lp.compile_count == 2
    lp.arm_witness(False)
    engine.check_batch(ds, checks, now_us=NOW_US, latency=True)
    assert lp.compile_count == 2
    trees = [_tree(c.explain(ctx, cons.full(), r)) for r in checks[:40]]
    assert trees == [_tree(cpu.explain(cctx, cons.full(), r))
                     for r in checks[:40]]
    got = c.check(ctx, cons.full(), *checks, explain=True)
    assert [e.allowed for e in got] == c.check(ctx, cons.full(), *checks)
