"""The port's serving front end (serve/batcher.py, serve/handle.py,
``Client.with_serving``) against the reference's.

The same submissions go through the reference's ServingHandle and the
port's (on the CPU), from one thread and from six concurrent ones, as
relationships and as interned columns: every answer equals the
reference's and the host oracle's, and the port's batcher coalesces
(fewer formed batches than submissions).  The reference's batcher cases
(tests/test_serve.py) run on both packages' MicroBatchers with the same
injected dispatch callables, and their outcomes must be equal: per-client
fairness, the deadline flush, the deadline passing in the queue, the
queue shed, close, the breaker re-forming onto the batch path, the
dispatcher's death and the per-submission slicing of a bulk item error.
The port's latency path must not capture across formed batches after its
warm-up.  Every output is a bool, an int or a string: the tolerance is
exact equality.
"""

import threading
import time

import numpy as np
import pytest

from gochugaru_tpu import consistency as jcons
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import (
    new_tpu_evaluator as j_new, with_host_only_evaluation as j_host_only,
    with_latency_mode as j_with_latency, with_store as j_with_store,
)
from gochugaru_tpu.serve import batcher as jbatcher
from gochugaru_tpu.utils import admission as jadm
from gochugaru_tpu.utils import errors as jerr
from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import (
    new_evaluator as p_new, with_admission_control as p_with_adm,
    with_latency_mode as p_with_latency,
)
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.serve import MicroBatcher, ServeConfig, ServingHandle
from gochugaru_tpu_torch.serve import batcher as pbatcher
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from gochugaru_tpu_torch.utils import admission as padm
from gochugaru_tpu_torch.utils import errors as perr
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils.context import background as p_background

from test_torch_latency_cuda import EPOCH, _queries, _rbac

RBAC = """
definition user {}
definition org { relation admin: user  relation member: user }
definition repo {
    relation org: org
    relation reader: user
    permission admin = org->admin
    permission read = reader + admin + org->member
}
"""
#: (batcher module, metrics module, admission module, errors module)
PKGS = {"port": (pbatcher, pmetrics, padm, perr),
        "reference": (jbatcher, jmetrics, jadm, jerr)}


def _triples(seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(120):
        out.append((f"repo:r{i}", "reader", f"user:u{rng.integers(60)}"))
        out.append((f"repo:r{i}", "org", f"org:o{i % 3}"))
    for o in range(3):
        out.append((f"org:o{o}", "admin", f"user:u{o}"))
        out.append((f"org:o{o}", "member", f"user:u{o + 10}"))
    return out


def _client(new, rel, background, *opts, **kw):
    c = new(*opts, **kw)
    ctx = background()
    c.write_schema(ctx, RBAC)
    txn = rel.Txn()
    for t in _triples():
        txn.touch(rel.must_from_triple(*t))
    c.write(ctx, txn)
    return c, ctx


@pytest.fixture(scope="module")
def world():
    """(port latency client, reference latency client, reference oracle
    client on the reference's store), over the same relationships."""
    pc, _ = _client(p_new, prel, p_background, p_with_latency(), device="cpu")
    jc, _ = _client(j_new, jrel, j_background, j_with_latency())
    oracle = j_new(j_host_only(), j_with_store(jc.store))
    return pc, jc, oracle


def _rand_checks(rng, n):
    return [(f"repo:r{rng.integers(120)}", "read", f"user:u{rng.integers(60)}")
            for _ in range(n)]


# ---------------------------------------------------------------------------
# parity through both handles, and coalescing
# ---------------------------------------------------------------------------

def test_serve_concurrent_parity_and_coalescing(world):
    """Six threads submit through both handles: every answer equals the
    reference handle's and the oracle's, and the port's batcher formed
    fewer batches than it got submissions."""
    pc, jc, oracle = world
    pctx, jctx = p_background(), j_background()
    m = pmetrics.default
    sub0, bat0 = m.counter("serve.submissions"), m.counter("serve.batches")
    errors, done = [], []
    with pc.with_serving() as ph, jc.with_serving() as jh:
        def worker(w):
            lr = np.random.default_rng(w)
            for _ in range(8):
                qs = _rand_checks(lr, 6)
                got = ph.check(pctx, *[prel.must_from_triple(*t) for t in qs],
                               client_id=w)
                jq = [jrel.must_from_triple(*t) for t in qs]
                want = jh.check(jctx, *jq, client_id=w)
                truth = oracle.check(jctx, jcons.full(), *jq)
                if not (list(got) == list(want) == list(truth)):
                    errors.append((w, got, want, truth))
                done.append(w)

        ts = [threading.Thread(target=worker, args=(w,)) for w in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not errors and len(done) == 48
    subs = m.counter("serve.submissions") - sub0
    bats = m.counter("serve.batches") - bat0
    assert subs == 48
    assert 0 < bats < subs, "no coalescing happened"


def test_serve_columns_parity_and_one_shot_surface(world):
    pc, jc, oracle = world
    pctx, jctx = p_background(), j_background()
    cols = []
    for c, cons in ((pc, pcons), (jc, jcons)):
        snap = c.store.snapshot_for(cons.full())
        it = snap.interner
        rng = np.random.default_rng(3)
        users = [n for i in range(60) if (n := it.lookup("user", f"u{i}")) >= 0]
        q_res = np.array([it.lookup("repo", f"r{rng.integers(120)}") for _ in range(80)],
                         np.int32)
        q_subj = np.array([users[i] for i in rng.integers(0, len(users), 80)], np.int32)
        q_perm = np.full(80, snap.compiled.slot_of_name["read"], np.int32)
        names = [(f"repo:{it.key_of(int(r))[1]}", "read", f"user:{it.key_of(int(s))[1]}")
                 for r, s in zip(q_res, q_subj)]
        cols.append(((q_res, q_perm, q_subj), names))
    assert cols[0][1] == cols[1][1]
    with pc.with_serving() as ph, jc.with_serving() as jh:
        got = np.asarray(ph.check_columns(pctx, *cols[0][0])).tolist()
        want = np.asarray(jh.check_columns(jctx, *cols[1][0])).tolist()
        fut = ph.submit_columns(pctx, *cols[0][0])
        assert np.asarray(fut.result(pctx, timeout=30)).tolist() == got
        r0 = prel.must_from_triple(*cols[0][1][0])
        assert ph.check_one(pctx, r0) == got[0]
        assert ph.check_many(pctx, [r0, r0]) == [got[0]] * 2
        assert ph.submit(pctx, r0).result(pctx, timeout=30) == [got[0]]
    truth = [oracle.check(jctx, jcons.full(), jrel.must_from_triple(*t))[0]
             for t in cols[1][1]]
    assert got == want == truth


def test_explain_raises_not_implemented(world):
    """``check(explain=True)`` and the handle's no longer raise: both give
    the reference's verdicts and trees (but for the timing field)."""
    pc, jc, _o = world

    def trees(got):
        return [(e.allowed, {k: v for k, v in e.explanation.items()
                             if k != "duration_ms"}) for e in got]

    checks = [("repo:r0", "read", "user:u0"), ("repo:r3", "read", "user:u7")]
    pr = [prel.must_from_triple(*t) for t in checks]
    jr = [jrel.must_from_triple(*t) for t in checks]
    assert trees(pc.check(p_background(), pcons.full(), *pr, explain=True)) == trees(
        jc.check(j_background(), jcons.full(), *jr, explain=True))
    with pc.with_serving() as ph, jc.with_serving() as jh:
        assert trees(ph.check(p_background(), *pr, explain=True)) == trees(
            jh.check(j_background(), *jr, explain=True))


def test_serving_handle_shares_the_admission_cost_model(world):
    pc, _jc, _o = world
    with pc.with_serving() as h:
        assert isinstance(h, ServingHandle)
        assert h.batcher._cost is pc._admission.cost
        h.check(p_background(), prel.must_from_triple("repo:r0", "read", "user:u0"))
        assert pc._admission.cost.has_samples()
        assert pc._admission.expected_cost_s(256) > 0.0


# ---------------------------------------------------------------------------
# the reference's batcher cases on both batchers
# ---------------------------------------------------------------------------

def _fairness(pkg):
    bmod, mmod, amod, _e = pkg
    b = bmod.MicroBatcher(tiers=(256, 1024, 4096), cost=amod.CostModel(), start=False,
                          registry=mmod.Metrics(),
                          config=bmod.ServeConfig(dedup=False))
    zipf = np.random.default_rng(1).zipf(1.3, 64 * 70)
    for i in range(70):
        cols = np.asarray(zipf[i * 64:(i + 1) * 64] % 97, np.int32)
        b.submit_columns("aggressor", cols, cols, cols)
    for w in range(3):
        one = np.zeros(1, np.int32)
        b.submit_columns(f"interactive{w}", one, one, one)
    depth = b.depth
    batch = b.form_batch()
    by_client = {}
    for s in batch.subs:
        by_client[s.client_id] = by_client.get(s.client_id, 0) + 1
    out = (depth, batch.reason, batch.total, batch.tier, by_client, b.depth)
    b.close()
    return out


def _deadline_flush(pkg):
    bmod, mmod, amod, _e = pkg
    reg = mmod.Metrics()
    cost = amod.CostModel()
    cost.observe(0.01, tier=256)
    b = bmod.MicroBatcher(tiers=(256, 1024, 4096), cost=cost, registry=reg,
                          config=bmod.ServeConfig(hold_max_s=2.0),
                          dispatch_cols=lambda q_res, *a: np.zeros(q_res.shape[0], bool))
    ctx = (p_background() if bmod is pbatcher else j_background()).with_timeout(0.25)
    try:
        t0 = time.perf_counter()
        one = np.zeros(1, np.int32)
        out = b.submit_columns("c", one, one, one, ctx=ctx).result(ctx, timeout=5.0)
        held = time.perf_counter() - t0
    finally:
        b.close()
    return (out.tolist(), held < 1.0, reg.counter("serve.flush_deadline"),
            reg.counter("serve.flush_maxhold"))


def _expired_in_queue(pkg):
    bmod, mmod, amod, emod = pkg
    reg = mmod.Metrics()
    b = bmod.MicroBatcher(tiers=(256,), cost=amod.CostModel(), start=False, registry=reg,
                          config=bmod.ServeConfig(hold_max_s=0.001))
    ctx = (p_background() if bmod is pbatcher else j_background()).with_timeout(0.005)
    one = np.zeros(1, np.int32)
    fut = b.submit_columns("c", one, one, one, ctx=ctx)
    time.sleep(0.02)
    batch = b.form_batch()
    with pytest.raises(emod.DeadlineExceededError):
        fut.result()
    b.close()
    return batch.total, fut.done(), reg.counter("serve.deadline_expired")


def _shed_and_close(pkg):
    bmod, mmod, amod, emod = pkg
    reg = mmod.Metrics()
    b = bmod.MicroBatcher(tiers=(256,), cost=amod.CostModel(), start=False, registry=reg,
                          config=bmod.ServeConfig(queue_max=64))
    cols = np.zeros(60, np.int32)
    fut = b.submit_columns("a", cols, cols, cols)
    with pytest.raises(emod.ShedError):
        b.submit_columns("b", cols[:8], cols[:8], cols[:8])
    b.close()
    with pytest.raises(emod.UnavailableError):
        fut.result()
    with pytest.raises(emod.UnavailableError):
        b.submit_columns("c", cols[:1], cols[:1], cols[:1])
    return reg.counter("serve.sheds"), issubclass(emod.ShedError, emod.UnavailableError)


def _breaker_reform(pkg):
    bmod, mmod, amod, _e = pkg
    cm = amod.CostModel()
    br = amod.CircuitBreaker(1, 1000.0, registry=mmod.Metrics())
    br.record_failure()  # OPEN
    seen = []
    b = bmod.MicroBatcher(
        tiers=(256,), cost=cm, breaker=br, start=False, registry=mmod.Metrics(),
        config=bmod.ServeConfig(batch_path_max=512),
        dispatch_cols=lambda q_res, q_perm, q_subj, latency, span:
            seen.append(latency) or np.zeros(q_res.shape[0], bool))
    eight = np.zeros(8, np.int32)
    futs = [b.submit_columns(f"c{i}", eight, eight, eight) for i in range(70)]
    batch = b.form_batch()
    shape = (batch.tier, batch.target, batch.total, len(batch.subs))
    b.dispatch_batch(batch)
    done = sum(f.done() for f in futs)
    b.close()
    return shape, seen, done, cm.expected_s(512) > 0.0, cm.expected_s(512) == cm.expected_s(99999)


def _dispatcher_death(pkg):
    bmod, mmod, amod, emod = pkg
    reg = mmod.Metrics()

    def dispatch_cols(*a):
        raise SystemExit("simulated dispatcher death")

    b = bmod.MicroBatcher(tiers=(256,), cost=amod.CostModel(), registry=reg,
                          config=bmod.ServeConfig(hold_max_s=0.0005),
                          dispatch_cols=dispatch_cols)
    one = np.zeros(1, np.int32)
    fut = b.submit_columns("c", one, one, one)
    with pytest.raises(emod.UnavailableError):
        fut.result(timeout=10.0)
    deadline = time.perf_counter() + 10.0
    closed = False
    while time.perf_counter() < deadline and not closed:
        try:
            f2 = b.submit_columns("c", one, one, one)
        except emod.UnavailableError:
            closed = True
            break
        try:
            f2.result(timeout=10.0)
        except emod.UnavailableError:
            pass
        time.sleep(0.01)
    return closed, reg.counter("serve.thread_crashes") >= 1


def _bulk_item_error(pkg, kind):
    bmod, mmod, amod, emod = pkg

    def fail(*a):
        part = [True] * 6 if kind == "rels" else np.ones(6, bool)
        raise emod.BulkCheckItemError(6, part, ValueError("bad item"))

    b = bmod.MicroBatcher(tiers=(256,), cost=amod.CostModel(), start=False,
                          registry=mmod.Metrics(), dispatch_rels=fail, dispatch_cols=fail)
    rel = prel if bmod is pbatcher else jrel
    r = rel.must_from_triple("doc:d", "read", "user:u")
    four = np.zeros(4, np.int32)
    futs = [b.submit_rels(c, [r] * 4) if kind == "rels"
            else b.submit_columns(c, four, four, four) for c in "ABC"]
    batch = b.form_batch()
    total = batch.total
    b.dispatch_batch(batch)
    out = [np.asarray(futs[0].result()).tolist()]
    with pytest.raises(emod.BulkCheckItemError) as ei:
        futs[1].result()
    out.append((ei.value.index, np.asarray(ei.value.results).tolist()))
    with pytest.raises(emod.UnavailableError):
        futs[2].result()
    b.close()
    return total, out


@pytest.mark.parametrize("case", [
    _fairness, _deadline_flush, _expired_in_queue, _shed_and_close, _breaker_reform,
    _dispatcher_death,
    lambda pkg: _bulk_item_error(pkg, "rels"),
    lambda pkg: _bulk_item_error(pkg, "cols"),
], ids=["fairness", "deadline_flush", "expired_in_queue", "shed_and_close",
        "breaker_reform", "dispatcher_death", "bulk_item_error_rels",
        "bulk_item_error_cols"])
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batcher_case_equals_the_reference(case):
    got = case(PKGS["port"])
    assert got == case(PKGS["reference"])
    if case is _fairness:
        assert all(got[4].get(f"interactive{w}") == 1 for w in range(3))
    if case is _breaker_reform:
        assert got[0][:2] == (None, 512) and got[1] == [False]


def test_breaker_trip_midqueue_reforms_and_loses_nothing():
    """Trip the latency-path breaker while submissions are queued: the
    envelopes re-submit, formation re-tiers for the batch path, no pinned
    shape replays while the breaker is open, and every answer equals the
    reference oracle's."""
    pc, pctx = _client(p_new, prel, p_background, p_with_latency(),
                       p_with_adm(padm.AdmissionConfig(breaker_threshold=2,
                                                       breaker_cooldown_s=120.0)),
                       device="cpu")
    jc, jctx = _client(j_new, jrel, j_background, j_host_only())
    m = pmetrics.default
    results, errors = {}, []
    with pc.with_serving() as h:
        with pfaults.armed("latency.dispatch", times=4):
            def worker(w):
                lr = np.random.default_rng(w)
                for j in range(6):
                    qs = _rand_checks(lr, 3)
                    try:
                        results[(w, j)] = (qs, h.check(
                            pctx.with_timeout(30.0),
                            *[prel.must_from_triple(*t) for t in qs], client_id=w))
                    except Exception as e:  # surfaced below
                        errors.append(e)

            ts = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        assert not errors
        assert pc._admission.breaker.state != 0, "breaker never tripped"
        lat0, reform0 = m.counter("latency.dispatches"), m.counter("serve.reformed_batchpath")
        qs = _rand_checks(np.random.default_rng(99), 12)
        results[("wave2", 0)] = (qs, h.check(pctx.with_timeout(30.0),
                                             *[prel.must_from_triple(*t) for t in qs]))
        assert m.counter("latency.dispatches") == lat0
        assert m.counter("serve.reformed_batchpath") > reform0
    pfaults.reset()
    assert len(results) == 25
    for qs, got in results.values():
        assert list(got) == jc.check(jctx, jcons.full(),
                                     *[jrel.must_from_triple(*t) for t in qs])


# ---------------------------------------------------------------------------
# no recapture across formed batches
# ---------------------------------------------------------------------------

def test_no_recapture_across_formed_batches():
    """100+ formed batches of varying occupancy through the port's latency
    path, coalesced by the batcher: no capture after the warm-up (every
    formed batch lands on a pinned tier), answers equal to the eager
    check_columns."""
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    engine = PEngine(cs, device="cpu")
    dsnap = engine.prepare(snap)
    lp = engine.latency_path(dsnap)

    def dispatch_cols(q_res, q_perm, q_subj, latency, span):
        out = lp.dispatch_columns(q_res, q_perm, q_subj, now_us=EPOCH, span=span)
        return np.asarray(out[0], bool)

    reg = pmetrics.Metrics()
    b = MicroBatcher(tiers=engine.config.latency_tiers, cost=padm.CostModel(),
                     registry=reg, config=ServeConfig(hold_max_s=0.0005),
                     dispatch_cols=dispatch_cols)
    rng = np.random.default_rng(23)
    try:
        for perm in ("read", "admin"):  # one pin per tier and permission set
            for tier in engine.config.latency_tiers:
                q = _queries(users, repos, slot, tier, seed=tier)
                b.submit_columns("warm", q[0], np.full(tier, slot[perm], np.int32),
                                 q[2]).result(timeout=30)
        warm = lp.compile_count
        c0 = pmetrics.default.counter("latency.compiles")
        bat0 = reg.counter("serve.batches")
        for i in range(110):
            B = int(rng.integers(1, 200))
            q_res = rng.choice(repos, B).astype(np.int32)
            q_perm = np.full(B, slot["read" if i % 2 else "admin"], np.int32)
            q_subj = rng.choice(users, B).astype(np.int32)
            got = b.submit_columns("t", q_res, q_perm, q_subj).result(timeout=30)
            if i % 37 == 0:
                d, _p, _o = engine.check_columns(dsnap, q_res, q_perm, q_subj, now_us=EPOCH)
                assert np.asarray(got).tolist() == np.asarray(d, bool).tolist()
        assert reg.counter("serve.batches") - bat0 >= 100
        assert lp.compile_count == warm
        assert pmetrics.default.counter("latency.compiles") == c0
    finally:
        b.close()
