"""The port's group commit (store/group.py, copied from the reference
package) against the reference's: the same scripted writes go through
``Store.write_group``, the ``GroupCommitter`` and the ``ChainCompactor``
of both packages, which must give the same revision sequence, tokens,
store contents and check answers at each revision.  Covered: consecutive
zookies in one log entry, the last-writer-wins collapse, ejections
(CREATE conflict, failed precondition), preconditions at the group's
base, fault atomicity with an idempotent retry, mid-group revision
reads, close and drain, the ``write_path`` section of ``/perf``, the
compactor, and ``EngineConfig.lsm_compact_min`` reaching the store.

Writes are drawn from numpy seeds.  The committer's groups are formed
deterministically: ``max_group`` transactions submitted at once under a
long hold flush as one "full" group.  Check answers of the port (its
engine on ``cpu``, through the delta chain) are held to the reference's
host oracle; the tolerance is exact equality."""

import types

import numpy as np
import pytest

from gochugaru_tpu import consistency as jcons
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import (
    new_tpu_evaluator as j_new, with_engine_config as j_with_cfg,
    with_group_commit as j_with_gc, with_host_only_evaluation as j_host_only,
    with_store as j_with_store,
)
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.store import group as jgroup
from gochugaru_tpu.store.store import Store as JStore
from gochugaru_tpu.store.store import parse_revision as j_parse_rev
from gochugaru_tpu.utils import faults as jfaults
from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils import perf as jperf
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import (
    WithGroupCommit, new_evaluator, with_engine_config as p_with_cfg,
    with_group_commit as p_with_gc, with_store as p_with_store,
)
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.store import group as pgroup
from gochugaru_tpu_torch.store.store import Store as PStore
from gochugaru_tpu_torch.store.store import parse_revision as p_parse_rev
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils import perf as pperf
from gochugaru_tpu_torch.utils.context import background as p_background

SIDES = {
    "reference": types.SimpleNamespace(
        rel=jrel, cons=jcons, Store=JStore, parse=j_parse_rev, faults=jfaults,
        group=jgroup, metrics=jmetrics, perf=jperf, Config=JConfig,
        background=j_background,
        client=lambda store, *o: j_new(j_with_store(store), j_host_only(), *o),
        with_gc=j_with_gc, with_cfg=j_with_cfg),
    "port": types.SimpleNamespace(
        rel=prel, cons=pcons, Store=PStore, parse=p_parse_rev, faults=pfaults,
        group=pgroup, metrics=pmetrics, perf=pperf, Config=PConfig,
        background=p_background,
        client=lambda store, *o: new_evaluator(p_with_store(store), *o,
                                               device="cpu"),
        with_gc=p_with_gc, with_cfg=p_with_cfg),
}

SCHEMA = """
definition user {}
definition document {
    relation writer: user
    relation reader: user

    permission edit = writer
    permission view = reader + edit
}
"""


@pytest.fixture(autouse=True)
def _hygiene():
    pfaults.reset()
    yield
    pfaults.reset()


def _both(script, *args):
    """``script(ns, *args)`` on each package: (port, reference)."""
    out = {side: script(ns, *args) for side, ns in SIDES.items()}
    return out["port"], out["reference"]


def _store(ns):
    s = ns.Store()
    s.write_schema(SCHEMA)
    return s


def _touch(ns, doc, relation="reader", user="user:jim"):
    t = ns.rel.Txn()
    t.touch(ns.rel.must_from_triple(f"document:{doc}", relation, user))
    return t


def _outcome(o):
    return type(o).__name__ if isinstance(o, BaseException) else str(o)


def _contents(s):
    return sorted(map(str, s.live_relationships()))


def _rand_txns(ns, rng, n):
    """``n`` seeded transactions over a small id space: touches and
    deletes of readers and writers, some CREATEs that collide."""
    out = []
    for _ in range(n):
        t = ns.rel.Txn()
        for _ in range(int(rng.integers(1, 4))):
            r = ns.rel.must_from_triple(
                f"document:d{rng.integers(6)}",
                str(rng.choice(["reader", "writer"])), f"user:u{rng.integers(5)}")
            op = rng.choice(["touch", "touch", "delete", "create"])
            getattr(t, str(op))(r)
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# Store.write_group
# ---------------------------------------------------------------------------

def _groups(ns, seed):
    """Seeded groups of random transactions: each group's outcomes, the
    head, the log length and the contents after it, and the sequential
    replay of the survivors."""
    s = _store(ns)
    rng = np.random.default_rng(seed)
    seen = []
    for _ in range(6):
        outs = s.write_group(_rand_txns(ns, rng, int(rng.integers(1, 7))))
        seen.append(([_outcome(o) for o in outs], s.head_revision, len(s._log),
                     _contents(s)))
    return seen


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_groups_equal_the_reference(seed):
    got, want = _both(_groups, seed)
    assert got == want
    outs = [o for g in got for o in g[0]]
    assert any(o.startswith("gtz1.") for o in outs)


def _scenarios(ns):
    out = {}
    s = _store(ns)
    base, log0 = s.head_revision, len(s._log)
    outs = s.write_group([_touch(ns, f"g{i}") for i in range(5)])
    out["consecutive"] = ([_outcome(o) for o in outs], s.head_revision - base,
                          len(s._log) - log0)
    # collapse: a later writer of the same tuple wins, delete-then-recreate
    mk = [_touch(ns, "a", user="user:one"), _touch(ns, "a", user="user:two"),
          _touch(ns, "b")]
    d = ns.rel.Txn()
    d.delete(ns.rel.must_from_triple("document:b", "reader", "user:jim"))
    d.touch(ns.rel.must_from_triple("document:c", "reader", "user:jim"))
    mk.append(d)
    grouped, seq = _store(ns), _store(ns)
    grouped.write_group(mk)
    for t in mk:
        seq.write(t)
    out["collapse"] = (_contents(grouped), _contents(seq), grouped.head_revision,
                       seq.head_revision)
    # ejections: a CREATE colliding with an earlier member, a failed
    # precondition, a must_not_match that sees the BASE revision only
    s = _store(ns)
    a, b = ns.rel.Txn(), ns.rel.Txn()
    a.create(ns.rel.must_from_triple("document:x", "reader", "user:jim"))
    b.create(ns.rel.must_from_triple("document:x", "reader", "user:jim"))
    bad = ns.rel.Txn()
    bad.must_match(ns.rel.must_from_triple("document:z", "writer", "user:amy").filter())
    bad.touch(ns.rel.must_from_triple("document:z", "reader", "user:jim"))
    neg = ns.rel.Txn()
    neg.must_not_match(
        ns.rel.must_from_triple("document:pre", "reader", "user:amy").filter())
    neg.touch(ns.rel.must_from_triple("document:other", "reader", "user:jim"))
    outs = s.write_group([a, b, bad, _touch(ns, "pre", user="user:amy"), neg])
    out["ejections"] = ([_outcome(o) for o in outs], _contents(s))
    # mid-group tokens: AT_LEAST resolves, a SNAPSHOT pin raises
    s = _store(ns)
    outs = s.write_group([_touch(ns, f"m{i}") for i in range(3)])
    s.snapshot_for(ns.cons.at_least(str(outs[1])))
    try:
        s.snapshot_for(ns.cons.snapshot(str(outs[1])))
        mid = "resolved"
    except Exception as e:
        mid = type(e).__name__
    out["mid"] = (mid, s.snapshot_for(ns.cons.snapshot(str(outs[-1]))).revision)
    # empty and all-ejected groups leave the head alone
    s = _store(ns)
    empty = s.write_group([])
    dup = ns.rel.Txn()
    dup.create(ns.rel.must_from_triple("document:d", "reader", "user:jim"))
    s.write(dup)
    again = ns.rel.Txn()
    again.create(ns.rel.must_from_triple("document:d", "reader", "user:jim"))
    out["ejected_all"] = (empty, [_outcome(o) for o in s.write_group([again])],
                          s.head_revision)
    return out


def test_write_group_scenarios_equal_the_reference():
    got, want = _both(_scenarios)
    assert got == want
    assert got["consecutive"][1:] == (5, 1)
    assert got["collapse"][0] == got["collapse"][1]
    assert got["ejections"][0][1] == "AlreadyExistsError"
    assert got["ejections"][0][2] == "PreconditionFailedError"
    assert got["mid"][0] == "RevisionUnavailableError"


def _fault_atomicity(ns):
    s = _store(ns)
    s.write(_touch(ns, "seed"))
    base, log0 = s.head_revision, len(s._log)
    txns = [_touch(ns, f"f{i}") for i in range(4)]
    with ns.faults.armed("closure.delta", times=1):
        try:
            s.write_group(txns)
            first = "committed"
        except Exception as e:
            first = type(e).__name__
        after_fault = (s.head_revision - base, len(s._log) - log0, len(s))
        outs = s.write_group(txns)
    return (first, after_fault, [_outcome(o) for o in outs],
            s.head_revision - base, _contents(s))


def test_fault_atomicity_and_retry_equal_the_reference():
    got, want = _both(_fault_atomicity)
    assert got == want
    assert got[0] == "UnavailableError" and got[1] == (0, 0, 1)
    assert got[3] == 4


# ---------------------------------------------------------------------------
# the committer
# ---------------------------------------------------------------------------

def _committer(ns, seed):
    """Rounds of ``max_group`` seeded transactions submitted at once (one
    full group each), one round under an armed fault and resubmitted;
    then a partial group drained by close()."""
    s = _store(ns)
    m = ns.metrics.Metrics()
    k = 6
    gc = ns.group.GroupCommitter(
        s, ns.group.GroupCommitConfig(max_group=k, hold_max_s=5.0), registry=m)
    rng = np.random.default_rng(seed)
    rounds = []
    for r in range(4):
        txns = _rand_txns(ns, rng, k)
        if r == 2:
            with ns.faults.armed("closure.delta", times=1):
                futs = [gc.submit(t) for t in txns]
                failed = []
                for f in futs:
                    try:
                        f.result(timeout=10.0)
                    except Exception as e:
                        failed.append(type(e).__name__)
            rounds.append(("fault", failed, s.head_revision))
        futs = [gc.submit(t) for t in txns]
        res = []
        for f in futs:
            try:
                res.append(str(f.result(timeout=10.0)))
            except Exception as e:
                res.append(type(e).__name__)
        rounds.append((res, s.head_revision, _contents(s)))
    tail = [gc.submit(_touch(ns, f"tail{i}")) for i in range(3)]
    gc.close()
    drained = [str(f.result(timeout=10.0)) for f in tail]
    try:
        gc.submit(_touch(ns, "late"))
        late = "accepted"
    except Exception as e:
        late = type(e).__name__
    return (rounds, drained, late, m.counter("write.groups"),
            m.counter("write.txns"), m.counter("write.flush_full"),
            m.counter("write.flush_drain"))


@pytest.mark.parametrize("seed", [4, 5])
def test_committer_equals_the_reference(seed):
    got, want = _both(_committer, seed)
    assert got == want
    rounds, drained, late, groups, txns, full, drain = got
    assert rounds[2] == ("fault", ["UnavailableError"] * 6, rounds[1][1])
    assert late == "UnavailableError"
    assert (full, drain) == (5, 1) and groups == 5 and txns == 27
    revs = [p_parse_rev(t) for t in drained]
    assert revs == list(range(revs[0], revs[0] + 3))


def test_write_path_section_has_the_reference_keys():
    got = {}
    for side, ns in SIDES.items():
        s = _store(ns)
        gc = ns.group.GroupCommitter(
            s, ns.group.GroupCommitConfig(max_group=1, hold_max_s=5.0))
        try:
            gc.submit(_touch(ns, "p")).result(timeout=10.0)
            wp = ns.perf.render_report()["write_path"]
        finally:
            gc.close()
        got[side] = (sorted(wp), sorted(wp["flush"]), sorted(wp["chain"]),
                     sorted(wp["apply_cost"]))
        assert wp["groups"] >= 1
    assert got["port"] == got["reference"]


# ---------------------------------------------------------------------------
# the chain compactor
# ---------------------------------------------------------------------------

def _compactor(ns):
    s = _store(ns)
    m = ns.metrics.Metrics()
    s.lsm_compact_min = 64
    cc = ns.group.ChainCompactor(
        s, ns.group.GroupCommitConfig(compact_poll_s=0.0, compact_fraction=0.5),
        registry=m)
    seed = ns.rel.Txn()
    for i in range(40):
        seed.touch(ns.rel.must_from_triple(f"document:s{i}", "reader", "user:u"))
    s.write(seed)
    s.snapshot_for(ns.cons.full())
    polls = []
    for n in range(12):
        s.write_group([_touch(ns, f"w{n}_{j}", user=f"user:v{j}") for j in range(8)])
        s.snapshot_for(ns.cons.full())
        polls.append((cc.poll_once(), s.peek_chain()[1:],
                      m.gauge("store.lsm_chain_len")))
    cc.close()
    return polls, m.counter("store.bg_compactions"), _contents(s)


def test_compactor_equals_the_reference():
    got, want = _both(_compactor)
    assert got == want
    polls, merges, _ = got
    assert merges >= 1 and any(p[0] for p in polls)
    for done, (rows, _len), _g in polls:
        if done:
            assert rows == 0


def test_lsm_compact_min_reaches_the_store():
    got = {}
    for side, ns in SIDES.items():
        c = ns.client(_store(ns), ns.with_cfg(ns.Config(lsm_compact_min=12_345)))
        got[side] = c._store.lsm_compact_min
        assert ns.Config().lsm_compact_min == 65_536
    assert got == {"port": 12_345, "reference": 12_345}


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------

def _client_rounds(ns, seed):
    """A client with group commit: seeded rounds of writes through it,
    then checks at ``at_least`` each round's last token."""
    ctx = ns.background()
    c = ns.client(_store(ns), ns.with_gc(
        ns.group.GroupCommitConfig(max_group=8, hold_max_s=0.002)))
    assert c._committer is not None and c._compactor is not None
    rng = np.random.default_rng(seed)
    checks = [ns.rel.must_from_triple(f"document:d{d}", p, f"user:u{u}")
              for d in range(6) for u in range(5) for p in ("view", "edit")]
    seen = []
    try:
        for _ in range(4):
            toks = []
            for t in _rand_txns(ns, rng, 5):
                try:
                    toks.append(str(c.write(ctx, t)))
                except Exception as e:
                    toks.append(type(e).__name__)
            last = next(t for t in reversed(toks) if t.startswith("gtz1."))
            seen.append((toks, c.check(ctx, ns.cons.at_least(last), *checks)))
    finally:
        c._committer.close()
        c._compactor.close()
    return seen


@pytest.mark.parametrize("seed", [6, 7])
def test_client_writes_through_the_committer_like_the_reference(seed):
    got, want = _both(_client_rounds, seed)
    assert got == want
    assert any(any(v) for _t, v in got)


def test_go_alias():
    assert WithGroupCommit is p_with_gc
