"""The port's verdict cache, singleflight and decision log (engine/vcache.py,
utils/decisions.py, the client's evaluate layer) against the reference's.

Keys and the cache's bookkeeping are compared directly: the same seeded
inputs through both packages' ``pack_cols``/``pack_one``/``rel_key``/
``fingerprint_context``, one scripted insert/lookup/evict/drop sequence
through both ``VerdictCache``s (results and ``stats()``), ``policy_for``
over every strategy.  The client layer runs twice from the same
relationships and writes, through a reference client and the port's on
the CPU, each with its verdict cache: every verdict equals the
reference's and the host oracle's along a write chain under all four
consistency strategies, live-context caveats never touch the cache, an
expiring edge's entry pins its evaluation time, a dsnap eviction drops
the shard, and the decision log records the reference's entries and
counters.  Every output is a bool, an int or a string: the tolerance is
exact equality.
"""

import datetime as dt
import time

import numpy as np
import pytest

from gochugaru_tpu import consistency as jcons
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import (
    new_tpu_evaluator as j_new, with_decision_log as j_with_log,
    with_host_only_evaluation as j_host_only, with_store as j_with_store,
    with_verdict_cache as j_with_cache,
)
from gochugaru_tpu.engine import vcache as jvc
from gochugaru_tpu.serve.batcher import SubmitFuture as JFuture
from gochugaru_tpu.utils import decisions as jdec
from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import (
    new_evaluator as p_new, with_decision_log as p_with_log,
    with_latency_mode as p_with_latency, with_verdict_cache as p_with_cache,
)
from gochugaru_tpu_torch.engine import vcache as pvc
from gochugaru_tpu_torch.serve.batcher import SubmitFuture as PFuture
from gochugaru_tpu_torch.utils import decisions as pdec
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils.context import background as p_background
from gochugaru_tpu_torch.utils.errors import UnavailableError

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
ALL_CS = ("full", "min_latency", "at_least", "snapshot")


def _strategy(cons, name, rev):
    if name == "full":
        return cons.full()
    if name == "min_latency":
        return cons.min_latency()
    if name == "at_least":
        return cons.at_least(rev)
    return cons.snapshot(rev)


def _rbac_triples(seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(120):
        out.append((f"repo:r{i}", "reader", f"user:u{rng.integers(60)}"))
        out.append((f"repo:r{i}", "org", f"org:o{i % 3}"))
    for o in range(3):
        out.append((f"org:o{o}", "admin", f"user:u{o}"))
        out.append((f"org:o{o}", "member", f"user:u{o + 10}"))
    return out


class Pair:
    """The same world through a reference client (with an oracle client
    on its store) and through the port's client on the CPU."""

    def __init__(self, schema, triples, j_opts=(), p_opts=(), caveats=None):
        self.jc = j_new(*j_opts)
        self.pc = p_new(*p_opts, device="cpu")
        self.jctx, self.pctx = j_background(), p_background()
        self.jc.write_schema(self.jctx, schema)
        self.pc.write_schema(self.pctx, schema)
        self.oracle = j_new(j_host_only(), j_with_store(self.jc.store))
        self.rev = self.write(touch=triples, caveats=caveats)

    def write(self, touch=(), delete=(), caveats=None):
        """One transaction on both; returns (reference token, port token)."""
        toks = []
        for c, rel, ctx in ((self.jc, jrel, self.jctx), (self.pc, prel, self.pctx)):
            txn = rel.Txn()
            for t in touch:
                r = rel.must_from_triple(*t)
                if caveats and t in caveats:
                    r = caveats[t](r)
                txn.touch(r)
            for t in delete:
                txn.delete(rel.must_from_triple(*t))
            toks.append(c.write(ctx, txn))
        return tuple(toks)

    def check(self, name, triples, rev=None, ctx_of=None):
        """(port verdicts, reference verdicts, oracle verdicts) under the
        strategy ``name`` (at ``rev``, a pair of tokens)."""
        rev = rev or self.rev
        jq = [jrel.must_from_triple(*t) for t in triples]
        pq = [prel.must_from_triple(*t) for t in triples]
        if ctx_of is not None:
            jq = [r.with_caveat("", ctx_of) for r in jq]
            pq = [r.with_caveat("", ctx_of) for r in pq]
        got = self.pc.check(self.pctx, _strategy(pcons, name, rev[1]), *pq)
        want = self.jc.check(self.jctx, _strategy(jcons, name, rev[0]), *jq)
        oracle = self.oracle.check(self.jctx, _strategy(jcons, name, rev[0]), *jq)
        return got, want, oracle


def _checks(rng, n):
    return [(f"repo:r{rng.integers(120)}", "read", f"user:u{rng.integers(60)}")
            for _ in range(n)]


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_cols_and_pack_one_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 500
    p = rng.integers(0, 1 << 15, n).astype(np.int32)
    r = rng.integers(0, 1 << 24, n).astype(np.int32)
    s = rng.integers(0, 1 << 24, n).astype(np.int32)
    got, want = pvc.pack_cols(p, r, s), jvc.pack_cols(p, r, s)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    for i in range(0, n, 50):
        a, b, c = int(p[i]), int(r[i]), int(s[i])
        assert pvc.pack_one(a, b, c) == jvc.pack_one(a, b, c) == int(got[i])
    # ids past the pack's bounds: the exact tuple fallback, as the reference
    for bad in ((1 << 15, 0, 0), (0, 1 << 24, 0), (0, 0, 1 << 24), (-1, 0, 0)):
        cols = [np.array([x, 1], np.int32) for x in bad]
        assert pvc.pack_cols(*cols) == jvc.pack_cols(*cols)
        assert isinstance(pvc.pack_cols(*cols), list)
        assert pvc.pack_one(*bad) == jvc.pack_one(*bad)
    z = np.zeros(0, np.int32)
    assert np.array_equal(pvc.pack_cols(z, z, z), jvc.pack_cols(z, z, z))


@pytest.mark.parametrize("seed", [3, 4])
def test_rel_key_and_fingerprint_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        t = (f"repo:r{rng.integers(9)}", "read",
             f"user:u{rng.integers(9)}" + ("#member" if rng.random() < 0.3 else ""))
        ctx = {"tier": int(rng.integers(5)), "name": f"n{rng.integers(3)}",
               "ok": bool(rng.integers(2)), "x": float(rng.integers(4)) / 2}
        if rng.random() < 0.3:
            ctx = {}
        jr = jrel.must_from_triple(*t).with_caveat("", ctx) if ctx else jrel.must_from_triple(*t)
        pr = prel.must_from_triple(*t).with_caveat("", ctx) if ctx else prel.must_from_triple(*t)
        assert pvc.rel_key(pr) == jvc.rel_key(jr)
        assert pvc.fingerprint_context(ctx) == jvc.fingerprint_context(ctx)
    assert pvc.fingerprint_context(None) == pvc.EMPTY_CTX_FP == jvc.EMPTY_CTX_FP


def test_policy_for_maps_every_strategy_as_the_reference():
    for name in ALL_CS:
        got = pvc.policy_for(_strategy(pcons, name, "7"))
        want = jvc.policy_for(_strategy(jcons, name, "7"))
        assert tuple(got) == tuple(want)
    assert tuple(pvc.policy_for(None)) == tuple(jvc.policy_for(None)) == (False, False)


# ---------------------------------------------------------------------------
# the cache's bookkeeping
# ---------------------------------------------------------------------------

def _script(vc_mod, metrics_mod):
    """One scripted insert / lookup / evict / drop sequence; returns
    every result and the final stats."""
    m = metrics_mod.Metrics()
    vc = vc_mod.VerdictCache(max_bytes=vc_mod.VerdictCache.COL_ENTRY_BYTES * 3000,
                             max_revisions=3, registry=m)
    rng = np.random.default_rng(21)
    out = []
    for rev in range(1, 6):
        keys = vc_mod.pack_cols(
            np.full(1500, rev % 3, np.int32),
            rng.permutation(1500).astype(np.int32),
            rng.integers(0, 99, 1500).astype(np.int32))
        verd = rng.random(1500) < 0.5
        vc.insert_cols(rev, keys, verd, now_us=1000 + rev)
        got = vc.lookup_cols(rev, keys)
        out.append(("cols", rev, got.tolist(), vc.resident_revisions))
        out.append(("miss", rev, vc.lookup_cols(rev + 100, keys)))
        out.append(("get", vc.get_col(rev, int(keys[7]))))
        rk = [(("repo", f"r{i}", "read", "user", f"u{i % 7}", ""), 0) for i in range(50)]
        vc.insert_rels(rev, [(k, i % 3 == 0) for i, k in enumerate(rk)], 77 + rev)
        out.append(("rels", vc.lookup_rels(rev, rk[:20] + [None, rk[3]])))
        out.append(("peek", vc.peek_rel(rev, rk[5]), vc.peek_rel(rev, ("x",))))
        out.append(("stats", {k: v for k, v in vc.stats().items()}))
    vc.drop_revision(5)
    vc.drop_revisions([3, 4, 99])
    out.append(("drop", vc.resident_revisions, vc.residency()))
    vc.set_max_bytes(vc_mod.VerdictCache.COL_ENTRY_BYTES * 100)
    out.append(("shrunk", vc.stats()))
    out.append(("counters", dict(sorted(m.counters_prefixed("cache.").items()))))
    vc.clear()
    out.append(("clear", vc.stats()))
    return out


def test_scripted_cache_sequence_equals_the_reference():
    assert _script(pvc, pmetrics) == _script(jvc, jmetrics)


# ---------------------------------------------------------------------------
# the client's evaluate layer, cache on
# ---------------------------------------------------------------------------

def test_delta_chain_cache_on_verdicts_all_strategies():
    """Writes interleave with cached checks at all four strategies: every
    port verdict equals the reference's (cache on) and the oracle's at the
    same strategy, warm repeats too; pinned revisions keep answering
    their own verdicts while resident."""
    w = Pair(RBAC, _rbac_triples(), j_opts=(j_with_cache(),),
             p_opts=(p_with_latency(), p_with_cache()))
    rng = np.random.default_rng(2)
    qs = _checks(rng, 10)
    h0 = pmetrics.default.counter("cache.hits")
    pinned = []
    for round_i in range(6):
        e = (f"repo:r{int(rng.integers(120))}", "reader", f"user:u{int(rng.integers(60))}")
        rev = w.write(touch=[] if round_i % 2 else [e], delete=[e] if round_i % 2 else [])
        for name in ALL_CS:
            for _ in range(2):  # cold, then served warm
                got, want, oracle = w.check(name, qs, rev)
                assert got == want == oracle, (round_i, name)
        pinned.append((rev, w.check("snapshot", qs, rev)[0]))
    for rev, verdicts in pinned[-2:]:
        assert w.check("snapshot", qs, rev)[0] == verdicts
    assert pmetrics.default.counter("cache.hits") > h0
    # one write that flips a verdict the cache holds: no stale read
    q = ("repo:r0", "read", "user:u55")
    rev = w.write(touch=[("repo:r0", "reader", "user:u55")])
    assert w.check("full", [q], rev) == ([True],) * 3  # materializes the head
    assert w.check("min_latency", [q], rev) == ([True],) * 3
    assert w.check("min_latency", [q], rev)[0] == [True]
    rev = w.write(delete=[("repo:r0", "reader", "user:u55")])
    for name in ("full", "at_least", "min_latency"):
        assert w.check(name, [q], rev) == ([False],) * 3, name


CAVEAT_SCHEMA = """
caveat tier_at_least(tier int, minimum int) { tier >= minimum }
definition user {}
definition doc {
    relation viewer: user with tier_at_least
    permission view = viewer
}
"""


def test_live_context_never_cached_and_context_free_outcomes_are():
    cav = {("doc:a", "viewer", "user:u1"): lambda r: r.with_caveat(
               "tier_at_least", {"minimum": 5}),
           ("doc:b", "viewer", "user:u2"): lambda r: r.with_caveat(
               "tier_at_least", {"minimum": 5, "tier": 9})}
    w = Pair(CAVEAT_SCHEMA, list(cav), j_opts=(j_with_cache(),),
             p_opts=(p_with_latency(), p_with_cache()), caveats=cav)
    m = pmetrics.default
    h0, b0 = m.counter("cache.hits"), m.counter("cache.bypass")
    for _ in range(3):
        got, want, oracle = w.check("min_latency", [("doc:a", "view", "user:u1")],
                                    ctx_of={"tier": 7})
        assert got == want == oracle == [True]
        got, want, oracle = w.check("min_latency", [("doc:a", "view", "user:u1")],
                                    ctx_of={"tier": 3})
        assert got == want == oracle == [False]
    assert m.counter("cache.hits") == h0, "a live-context verdict was cached"
    assert m.counter("cache.bypass") - b0 == 6
    qs = [("doc:b", "view", "user:u2"), ("doc:a", "view", "user:u1")]
    assert w.check("min_latency", qs)[:2] == ([True, False],) * 2
    got = w.check("min_latency", qs)
    assert got[0] == got[1] == [True, False]
    assert m.counter("cache.hits") - h0 == 2


def test_expiring_edge_entry_pins_now_us():
    exp = dt.datetime.now(dt.timezone.utc) + dt.timedelta(hours=1)
    t = ("doc:x", "viewer", "user:u1")
    w = Pair("""
    definition user {}
    definition doc { relation viewer: user  permission view = viewer }
    """, [t], j_opts=(j_with_cache(),), p_opts=(p_with_latency(), p_with_cache()),
             caveats={t: lambda r: r.with_expiration(exp)})
    q = ("doc:x", "view", "user:u1")
    t0 = int(time.time() * 1_000_000)
    assert w.check("min_latency", [q]) == ([True],) * 3
    snap = w.pc.store.snapshot_for(pcons.min_latency())
    entry = w.pc._vcache._revs[snap.revision]["r"][pvc.rel_key(prel.must_from_triple(*q))]
    assert entry[0] is True and abs(entry[1] - t0) < 60_000_000
    # the reference pins its entry the same way
    jsnap = w.jc.store.snapshot_for(jcons.min_latency())
    jentry = w.jc._vcache._revs[jsnap.revision]["r"][jvc.rel_key(jrel.must_from_triple(*q))]
    assert jentry[0] is True and abs(jentry[1] - entry[1]) < 60_000_000
    h0 = pmetrics.default.counter("cache.hits")
    assert w.check("min_latency", [q])[0] == [True]
    assert pmetrics.default.counter("cache.hits") == h0 + 1
    assert w.pc._peek_cached(snap, [prel.must_from_triple(*q)],
                             pcons.min_latency()) == [entry]
    assert w.pc._peek_cached(snap, [prel.must_from_triple(*q)],
                             pcons.full()) == [None]


def test_columns_dedup_and_cache_hits_match_the_reference():
    w = Pair(RBAC, _rbac_triples(), j_opts=(j_with_cache(),),
             p_opts=(p_with_latency(), p_with_cache()))
    outs = []
    for c, cons in ((w.pc, pcons), (w.jc, jcons)):
        snap = c.store.snapshot_for(cons.full())
        it = snap.interner
        rng = np.random.default_rng(3)
        users = [n for i in range(60) if (n := it.lookup("user", f"u{i}")) >= 0]
        res = np.array([it.lookup("repo", f"r{i}") for i in rng.integers(0, 120, 64)], np.int32)
        subj = np.array([users[i] for i in rng.integers(0, len(users), 64)], np.int32)
        res, subj = np.tile(res, 4), np.tile(subj, 4)
        perm = np.full(res.shape[0], snap.compiled.slot_of_name["read"], np.int32)
        got = [c._evaluate_columns(snap, res, perm, subj, latency=True,
                                   cs=cons.min_latency(), dedup=True)
               for _ in range(2)]
        oracle = c._oracle_for(snap)
        want = [c._check_interned(oracle, snap, res[i], perm[i], subj[i])
                for i in range(res.shape[0])]
        assert got[0].tolist() == got[1].tolist() == want
        outs.append((got[0].tolist(), c._vcache.stats()["entries"]))
    assert outs[0] == outs[1]


def test_dsnap_eviction_drops_the_cache_shard():
    w = Pair(RBAC, _rbac_triples(), j_opts=(j_with_cache(),),
             p_opts=(p_with_latency(), p_with_cache()))
    q = [("repo:r1", "read", "user:u1")]
    revs = []
    for i in range(w.pc.SNAPSHOT_CACHE_MAX + 2):
        revs.append(w.write(touch=[(f"repo:r{i}", "reader", f"user:uev{i}")]))
        w.check("full", q, revs[-1])
        assert w.check("at_least", q, revs[-1])[0] == w.check("at_least", q, revs[-1])[1]
    first = int(revs[0][1].split(".")[-1]) if "." in revs[0][1] else int(revs[0][1])
    assert first not in w.pc._vcache.resident_revisions
    assert sorted(w.pc._vcache.resident_revisions) == sorted(w.jc._vcache.resident_revisions)


def test_cache_lookup_fault_site_classifies_into_the_retry_envelope():
    w = Pair(RBAC, _rbac_triples(), p_opts=(p_with_latency(), p_with_cache()))
    qs = _checks(np.random.default_rng(5), 6)
    want = w.check("full", qs)[1]
    with pfaults.armed("cache.lookup", times=2) as spec:
        assert w.check("min_latency", qs)[0] == want
    assert spec.fired == 2
    pfaults.reset()


# ---------------------------------------------------------------------------
# singleflight
# ---------------------------------------------------------------------------

def _window(vc_mod, fut_cls, metrics_mod):
    m = metrics_mod.Metrics()
    sf = vc_mod.Singleflight(registry=m)
    keys = np.array([10, 20, 30, 40], np.int64)
    sf.open_cols(keys, np.sort(keys))
    probes = (sf.active, sf.probe(20), sf.probe(99))
    fut = fut_cls(time.perf_counter())
    parked = sf.try_park(np.array([30, 10], np.int64), fut, "cols", 2)
    fut2 = fut_cls(time.perf_counter())
    partial = sf.try_park(np.array([30, 99], np.int64), fut2, "cols", 2)
    settled = sf.close(np.array([True, False, True, False]), None, time.perf_counter())
    out = fut.result(timeout=1.0).tolist()
    # a relationship window whose batch fails: the parked future rejects
    # retriable, its envelope re-submits
    km = {vc_mod.rel_key(jrel.must_from_triple("a:1", "r", "b:2")): 0}
    sf.open_map(km)
    fut3 = fut_cls(time.perf_counter())
    parked3 = sf.try_park(list(km), fut3, "rels", 1)
    sf.close(None, RuntimeError("twin failed"), time.perf_counter())
    try:
        fut3.result(timeout=1.0)
        err = None
    except Exception as e:  # the module's own UnavailableError
        err = type(e).__name__
    return (probes, parked, partial, settled, out, not sf.active, parked3, err,
            m.counter("serve.dedup_parked"), m.counter("serve.checks"))


def test_singleflight_parks_fans_out_and_rejects_like_the_reference():
    got = _window(pvc, PFuture, pmetrics)
    assert got == _window(jvc, JFuture, jmetrics)
    assert got[4] == [True, True] and got[7] == UnavailableError.__name__


# ---------------------------------------------------------------------------
# the decision log
# ---------------------------------------------------------------------------

@pytest.fixture
def log_hygiene():
    yield
    pdec.install(None)
    jdec.install(None)


def _strip(entries):
    return [{k: v for k, v in e.items() if k not in ("unix_s", "latency_ms", "trace_id")}
            for e in entries]


def _log_script(dec, rel, cons, metrics_mod, tmp_path):
    out = []
    m = metrics_mod.Metrics()
    log = dec.DecisionLog(capacity=4096, sample_rate=0.0, registry=m, seed=1)
    dec.install(log)
    rels = [rel.must_from_triple(f"doc:d{i}", "read", f"user:u{i}") for i in range(50)]
    dec.record_rels(rels, [i % 5 != 0 for i in range(50)], revision=7,
                    strategy=cons.full(), latency_s=0.001)
    out.append(_strip(log.tail()))
    log2 = dec.DecisionLog(sample_rate=0.0, denied_keep_max=3, registry=m)
    dec.install(log2)
    dec.record_rels(rels, [False] * 50, strategy="direct")
    out.append((_strip(log2.tail()), {k: v for k, v in log2.stats().items() if k != "sink"}))
    log3 = dec.DecisionLog(capacity=8, registry=m, sample_rate=1.0)
    dec.install(log3)
    dec.record_rels(rels[:20], [True] * 20, revision=3, strategy=cons.min_latency(),
                    cache_hits=[i % 2 == 0 for i in range(20)], latency_s=0.002,
                    client_id="w7", dedup_parked=True)
    dec.record_cols(4, [True, False, True, True],
                    lambda i: (f"doc:d{i}", "read", f"user:u{i}"),
                    revision=2, strategy="min_latency", latency_s=0.01)
    out.append(_strip(log3.tail()))
    sink = str(tmp_path / "d.jsonl")
    log4 = dec.DecisionLog(sink_path=sink, rotate_bytes=600, rotate_keep=2, registry=m)
    dec.install(log4)
    for b in range(20):
        dec.record_rels([rels[b]], [True], revision=b, strategy="direct")
    dec.install(None)
    out.append(sorted(p.name for p in tmp_path.iterdir()))
    dec.count_verdicts(m, 5, 2, "min_latency", cache_hits=3)
    dec.count_verdicts(m, 1, 0, "full")
    out.append(dict(sorted(m.counters_prefixed("check.verdicts.").items())))
    out.append(dict(sorted(m.counters_prefixed("decisions.").items())))
    out.append([dec.strategy_name(s) for s in (
        None, cons.full(), cons.min_latency(), cons.at_least("3"), cons.snapshot("3"))])
    return out


def test_decision_log_records_and_counters_equal_the_reference(tmp_path, log_hygiene):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = _log_script(pdec, prel, pcons, pmetrics, tmp_path / "p")
    assert got == _log_script(jdec, jrel, jcons, jmetrics, tmp_path / "j")
    assert len(got[0]) == 10 and got[5]["decisions.rotated"] > 0


def test_client_decisions_equal_the_reference_client(log_hygiene):
    """The same checks through a reference client and the port's, each
    with the decision log and the verdict cache: equal entries (the
    cache-served repeats flagged ``cache_hit``) and equal per-strategy
    counter deltas."""
    jdec.install(None)
    pdec.install(None)
    w = Pair(RBAC, _rbac_triples(), j_opts=(j_with_cache(), j_with_log(capacity=512)),
             p_opts=(p_with_latency(), p_with_cache(), p_with_log(capacity=512)))
    jc0 = jmetrics.default.counters_prefixed("check.verdicts.")
    pc0 = pmetrics.default.counters_prefixed("check.verdicts.")
    qs = _checks(np.random.default_rng(8), 12)
    for name in ("full", "min_latency", "min_latency", "at_least"):
        got = w.pc.check(w.pctx, _strategy(pcons, name, w.rev[1]),
                         *[prel.must_from_triple(*t) for t in qs])
        want = w.jc.check(w.jctx, _strategy(jcons, name, w.rev[0]),
                          *[jrel.must_from_triple(*t) for t in qs])
        assert got == want
    ents = [_strip(d.get().tail()) for d in (pdec, jdec)]
    assert ents[0] == ents[1] and any(e.get("cache_hit") for e in ents[0])

    def delta(m, before):
        now = m.counters_prefixed("check.verdicts.")
        return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}

    assert delta(pmetrics.default, pc0) == delta(jmetrics.default, jc0)
