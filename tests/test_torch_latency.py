"""The port's latency-mode Check (engine/latency.py) and pipelined check
against the reference's.

Worlds are built twice from the same numpy seed, once by the reference
package (``gochugaru_tpu``) and once by the port, and the port must give,
bit for bit, the reference's planes: ``LatencyPath.dispatch_columns`` at
tiers 256 and 1024 (and the port's own ``check_columns``), the
``(lo, hi, d, p, ovf)`` tuples of ``check_columns_pipelined``, a
``with_latency_mode`` client's verdicts, and the circuit breaker's
reroutes under the same injected faults.  On the CPU a pin runs the eager
program over its static buffers; the CUDA graph itself is held to the
eager planes by tests/test_torch_latency_cuda.py and by ``chip_smoke.py``
phase 13.  All outputs are int or bool: the tolerance is exact equality.
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from gochugaru_tpu import consistency as jconsistency
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import (
    new_tpu_evaluator as j_new, with_admission_control as j_with_adm,
    with_engine_config as j_with_config, with_latency_mode as j_with_latency,
)
from gochugaru_tpu.engine import latency as JL
from gochugaru_tpu.engine.device import DeviceEngine as JEngine
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.delta import apply_delta as j_apply
from gochugaru_tpu.store.snapshot import build_snapshot as j_build_rels
from gochugaru_tpu.store.snapshot import build_snapshot_from_columns as j_build
from gochugaru_tpu.utils import faults as jfaults
from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils import perf as jperf
from gochugaru_tpu.utils.admission import AdmissionConfig as JAdmissionConfig
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pconsistency
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import (
    new_evaluator as p_new, with_admission_control as p_with_adm,
    with_engine_config as p_with_config, with_latency_mode as p_with_latency,
)
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine import latency as PL
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.device import to_device_tensor
from gochugaru_tpu_torch.engine import hash as PH
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.delta import apply_delta as p_apply
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import (
    build_snapshot as p_build_rels, build_snapshot_from_columns as p_build,
)
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils import perf as pperf
from gochugaru_tpu_torch.utils.admission import AdmissionConfig as PAdmissionConfig
from gochugaru_tpu_torch.utils.context import background as p_background
from test_torch_latency_cuda import (
    CHAIN_SCHEMA, EPOCH, RBAC_SCHEMA, _chain_queries, _chain_world, _queries, _rbac,
    _same,
)

@pytest.fixture(scope="module")
def worlds():
    """The rbac world in both packages: (engine, dsnap, snap, users, repos,
    slot) each."""
    jcs, jsnap, users, repos, slot = _rbac(j_compile, j_parse, JInterner(), j_build)
    pcs, psnap, pusers, prepos, pslot = _rbac(p_compile, p_parse, PInterner(), p_build)
    assert np.array_equal(users, pusers) and np.array_equal(repos, prepos)
    assert slot == pslot
    je = JEngine(jcs)
    pe = PEngine(pcs, device="cpu")
    return (dict(engine=je, dsnap=je.prepare(jsnap)),
            dict(engine=pe, dsnap=pe.prepare(psnap), snap=psnap),
            users, repos, slot)


# ---------------------------------------------------------------------------
# tiers and config
# ---------------------------------------------------------------------------

def test_tier_for_matches_reference_on_random_ladders():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ladder = tuple(int(x) for x in rng.integers(1, 5000, rng.integers(1, 5)))
        for B in rng.integers(0, 6000, 8):
            assert PL.tier_for(ladder, int(B)) == JL.tier_for(ladder, int(B))


def test_engine_config_latency_tiers_match_the_reference(worlds):
    """The reference's default ladder, and a custom one steering the
    path.  The reference's knobs that would do nothing here (donation, a
    staged-timing override, the pipelined sub-batch as a config field)
    are not accepted."""
    _j, p, users, repos, slot = worlds
    assert PConfig().latency_tiers == JConfig().latency_tiers
    cfg = PConfig(latency_tiers=(192, 576, 4096))
    pe = PEngine(p_compile(p_parse(RBAC_SCHEMA)), cfg, device="cpu")
    lp = pe.latency_path(pe.prepare(p["snap"]))
    lp.dispatch_columns(*_queries(users, repos, slot, 300, 19), now_us=EPOCH)
    assert lp.last_budget.tier == 576
    for knob in ("latency_donate", "latency_staged_timing", "flat_pipeline_batch"):
        with pytest.raises(TypeError):
            PConfig(**{knob: None})


# ---------------------------------------------------------------------------
# the latency path vs the reference's and vs check_columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,tier", [(200, 256), (700, 1024)])
def test_dispatch_planes_match_reference_and_check_columns(worlds, B, tier):
    j, p, users, repos, slot = worlds
    q = _queries(users, repos, slot, B, seed=B)
    jlp = j["engine"].latency_path(j["dsnap"])
    plp = p["engine"].latency_path(p["dsnap"])
    want = jlp.dispatch_columns(*q, now_us=EPOCH)
    got = plp.dispatch_columns(*q, now_us=EPOCH)
    assert plp.last_budget.tier == jlp.last_budget.tier == tier
    assert _same(got, want)
    assert _same(got, p["engine"].check_columns(p["dsnap"], *q, now_us=EPOCH))
    assert got[0].any() and not got[0].all()


def test_batch_past_the_top_tier_returns_none_and_latency_entry_answers(worlds):
    _j, p, users, repos, slot = worlds
    pe, ds = p["engine"], p["dsnap"]
    B = max(pe.config.latency_tiers) + 1
    q = _queries(users, repos, slot, B, seed=13)
    lp = pe.latency_path(ds)
    assert lp.tier_for(B) is None
    n = lp.dispatch_count
    assert lp.dispatch_columns(*q, now_us=EPOCH) is None
    assert _same(pe.check_columns_latency(ds, *q, now_us=EPOCH),
                 pe.check_columns(ds, *q, now_us=EPOCH))
    assert lp.dispatch_count == n


def test_one_staging_buffer_per_tier_reused(worlds):
    _j, p, users, repos, slot = worlds
    pe = p["engine"]
    ds = dataclasses.replace(p["dsnap"], latency_path=None)
    lp = pe.latency_path(ds)
    lp.dispatch_columns(*_queries(users, repos, slot, 100, 1), now_us=EPOCH)
    buf = lp._qm_bufs[256][0]
    lp.dispatch_columns(*_queries(users, repos, slot, 250, 2), now_us=EPOCH)
    lp.dispatch_columns(*_queries(users, repos, slot, 600, 3), now_us=EPOCH)
    assert sorted(lp._qm_bufs) == [256, 1024]
    assert lp._qm_bufs[256][0] is buf
    assert tuple(buf.shape) == (8, 256) and buf.dtype == torch.int32


def test_warm_dispatches_leave_compile_count_flat(worlds):
    _j, p, users, repos, slot = worlds
    pe, ds = p["engine"], p["dsnap"]
    lp = pe.latency_path(ds)
    q_res, q_perm, q_subj = _queries(users, repos, slot, 700, seed=11)
    lp.dispatch_columns(q_res, q_perm, q_subj, now_us=EPOCH)
    warm = lp.compile_count
    assert warm >= 1
    for i in range(20):
        got = lp.dispatch_columns(np.roll(q_res, i), q_perm,
                                  np.roll(q_subj, i), now_us=EPOCH)
        assert not lp.last_budget.compiled
        if i % 7 == 0:
            assert _same(got, pe.check_columns(
                ds, np.roll(q_res, i), q_perm, np.roll(q_subj, i), now_us=EPOCH))
    lp.dispatch_columns(q_res[:500], q_perm[:500], q_subj[:500], now_us=EPOCH)
    assert lp.compile_count == warm
    snap = pmetrics.default.snapshot()
    for stage in ("host_lower", "h2d", "kernel", "d2h", "dispatch"):
        assert snap[f"latency.{stage}_s.count"] >= 1
    pad = pperf.pad_stats()["per_tier"]["1024"]
    assert pad["total"] >= 21 * 1024 and 0 < pad["pad_fraction"] < 1
    assert any(e["kind"] == "latency_pin" and e["tier"] == 1024
               for e in pperf.cost_entries())


def test_perf_ledger_matches_the_reference(worlds):
    """The copied ledger: the gathered-bytes model over the same prepared
    tables, and the wall ledger's attribution, equal the reference's."""
    j, p, *_ = worlds
    want = jperf.gathered_bytes_model(j["dsnap"])
    got = pperf.gathered_bytes_model(p["dsnap"])
    assert got.per_table == want.per_table and got.per_level == want.per_level
    assert pperf.table_bytes(p["dsnap"]) == jperf.table_bytes(j["dsnap"])
    iv = [(0, 0.0, 2.0), (1, 1.0, 3.0), (4, 2.5, 6.0), (3, 7.0, 8.0)]
    assert pperf._attribute_wall(iv, 0.0, 10.0) == jperf._attribute_wall(iv, 0.0, 10.0)


def test_pins_live_with_their_snapshot(worlds):
    """Pins live with the storage they read: a re-prepare (new storage)
    captures its own; the revisions of a delta chain in one shape band
    share the pin the first of them captured (new overlays, copied into
    the pin's private buffers), and each answers its own revision."""
    _j, p, users, repos, slot = worlds
    pe, ds, snap = p["engine"], p["dsnap"], p["snap"]
    q = _queries(users, repos, slot, 200, seed=17)
    lp = pe.latency_path(ds)
    lp.dispatch_columns(*q, now_us=EPOCH)
    pins, caps = lp.pins(), lp.compile_count
    assert _same(lp.dispatch_columns(*q, now_us=EPOCH),
                 pe.check_columns(ds, *q, now_us=EPOCH))
    assert lp.pins() == pins and lp.compile_count == caps
    assert not lp.last_budget.compiled
    fresh = pe.latency_path(pe.prepare(snap))
    fresh.dispatch_columns(*q, now_us=EPOCH)
    assert fresh.compile_count == 1
    # a delta chain: each revision adds a reader, shapes stay in band
    prev, revs = ds, []
    for rev, (r, u) in enumerate(((0, 1), (1, 2)), start=2):
        key = snap.interner.key_of
        add = prel.must_from_triple(
            f"{':'.join(key(int(repos[r])))}", "reader",
            f"{':'.join(key(int(users[u])))}")
        nsnap = p_apply(prev.snapshot, rev, [add], [], interner=snap.interner)
        nds = pe.prepare(nsnap, prev=prev)
        assert nds.flat_meta.delta is not None
        revs.append(nds)
        prev = nds
    a, b = revs
    assert a.flat_meta == b.flat_meta
    assert {k: tuple(v.shape) for k, v in a.arrays.items()} == {
        k: tuple(v.shape) for k, v in b.arrays.items()}
    caps = []
    for nds in revs:
        lp = pe.latency_path(nds)
        assert _same(lp.dispatch_columns(*q, now_us=EPOCH),
                     pe.check_columns(nds, *q, now_us=EPOCH))
        caps.append(lp.compile_count)
    assert caps == [1, 0]


# ---------------------------------------------------------------------------
# the clock as a device tensor
# ---------------------------------------------------------------------------

EXP_SCHEMA = """
definition user {}
definition team { relation member: user }
definition doc {
    relation reader: user | team#member
    relation banned: user
    permission view = reader - banned
}
"""


def _expiring_world(seed=3, n_users=30, n_teams=5, n_docs=40):
    """Readers, team members and bans, a third of them expiring 100 s or
    10,000 s after the epoch."""
    rng = np.random.default_rng(seed)
    rels = []

    def rel_(res, relation, subj):
        r = prel.must_from_triple(res, relation, subj)
        k = rng.integers(0, 3)
        if k:
            when = EPOCH + (100 if k == 1 else 10_000) * 1_000_000
            r = r.with_expiration(dt.datetime.fromtimestamp(
                when / 1e6, tz=dt.timezone.utc))
        return r

    for t in range(n_teams):
        for u in rng.choice(n_users, 5, replace=False):
            rels.append(rel_(f"team:t{t}", "member", f"user:u{u}"))
    for d in range(n_docs):
        rels.append(rel_(f"doc:d{d}", "reader", f"user:u{rng.integers(n_users)}"))
        rels.append(rel_(f"doc:d{d}", "reader",
                         f"team:t{rng.integers(n_teams)}#member"))
        if d % 4 == 0:
            rels.append(rel_(f"doc:d{d}", "banned", f"user:u{rng.integers(n_users)}"))
    cs = p_compile(p_parse(EXP_SCHEMA))
    snap = p_build_rels(1, cs, PInterner(), rels, epoch_us=EPOCH)
    q_res = np.array([snap.interner.lookup("doc", f"d{rng.integers(n_docs)}")
                      for _ in range(300)], np.int32)
    q_subj = np.array([snap.interner.lookup("user", f"u{rng.integers(n_users)}")
                       for _ in range(300)], np.int32)
    perms = np.array([cs.slot_of_name["view"], cs.slot_of_name["reader"]], np.int32)
    q_perm = rng.choice(perms, 300)
    return cs, snap, (q_res, q_perm, q_subj)


NOWS = (EPOCH, EPOCH + 1_000 * 1_000_000, EPOCH + 10**9 * 1_000_000)


@pytest.mark.parametrize("aligned", [False, True], ids=["off", "aligned"])
def test_now_tensor_equals_int_through_the_flat_program(aligned):
    cs, snap, q = _expiring_world()
    pe = PEngine(cs, PConfig(flat_aligned=aligned), device="cpu")
    ds = pe.prepare(snap)
    if aligned:
        assert ds.flat_meta.aligned
    queries, qctx = pe._columns_preamble(ds, *q)
    lp = pe.latency_path(ds)
    planes = []
    for now_us in NOWS:
        now = snap.now_rel32(now_us)
        fn, args = pe.flat_fn_and_args(ds, queries, qctx, now, len(q[0]))
        assert args[2].dim() == 0 and args[2].dtype == torch.int32
        with torch.no_grad():
            by_tensor = fn(*args)
            by_int = fn(*args[:2], now, *args[3:])
        assert _same(by_tensor, by_int)
        got = lp.dispatch_columns(*q, now_us=now_us)
        assert _same(got, [x[: len(q[0])] for x in by_tensor])
        planes.append(got[0])
    assert lp.compile_count == 1  # one pin answered every clock
    # the answers really move with the clock
    assert planes[0].sum() > planes[1].sum() > planes[2].sum()


def _table(seed, n=600):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 70, n).astype(np.int32)
    k2 = rng.integers(0, 40, n).astype(np.int32)
    u_d = rng.integers(0, 1000, n).astype(np.int32)
    u_p = (u_d // 2).astype(np.int32)
    exp = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 1000, n)).astype(np.int32)
    qi = rng.integers(0, n, (9, 5))  # present pairs, then absent ones
    q1, q2 = k1[qi].copy(), k2[qi].copy()
    q1[0], q2[0] = rng.integers(-2, 72, 5), rng.integers(0, 41, 5)
    return [k1, k2], [k1, k2, u_d, u_p, exp], (q1, q2)


@pytest.mark.parametrize("now", [0, 300, 700, 1000])
def test_now_tensor_equals_int_through_both_plain_twins(now):
    keys, cols, qs = _table(now)
    qt = tuple(torch.from_numpy(x) for x in qs)
    h = PH.build_hash(keys, target_cap=4)
    off = to_device_tensor(h.off, "cpu")
    tbl = to_device_tensor(PH.interleave_buckets(h, cols), "cpu")
    ai = PH.build_aligned(keys, cols, cover=(0.5, 0.9))
    lv = [to_device_tensor(t, "cpu") for t, _ in ai.levels]
    now_t = torch.tensor(now, dtype=torch.int32)
    for mode, kw in (("until2", {}), ("gate", {"exp_lane": 4})):
        a = K.fused_probe(qt, off, tbl, cap=h.cap, mode=mode, now=now, **kw)
        b = K.fused_probe(qt, off, tbl, cap=h.cap, mode=mode, now=now_t, **kw)
        assert _same(a, b)
        a = K.fused_probe_aligned(qt, lv, ai.caps, ai.w, mode=mode, now=now, **kw)
        b = K.fused_probe_aligned(qt, lv, ai.caps, ai.w, mode=mode, now=now_t, **kw)
        assert _same(a, b)
        if mode == "gate":
            assert a[0].any()  # hits: the aligned probe found present keys


# ---------------------------------------------------------------------------
# the pipelined check
# ---------------------------------------------------------------------------

def test_pipelined_check_yields_the_reference_tuples(worlds):
    j, p, users, repos, slot = worlds
    q = _queries(users, repos, slot, 300, seed=23)
    want = list(j["engine"].check_columns_pipelined(
        j["dsnap"], *q, now_us=EPOCH, sub_batch=128))
    got = list(p["engine"].check_columns_pipelined(
        p["dsnap"], *q, now_us=EPOCH, sub_batch=128))
    assert [(lo, hi) for lo, hi, *_ in got] == [(0, 128), (128, 256), (256, 300)]
    assert [(lo, hi) for lo, hi, *_ in want] == [(lo, hi) for lo, hi, *_ in got]
    for (_l, _h, *a), (_l2, _h2, *b) in zip(got, want):
        assert _same(a, b)
    whole = p["engine"].check_columns(p["dsnap"], *q, now_us=EPOCH)
    assert _same([np.concatenate([t[k] for t in got]) for k in (2, 3, 4)], whole)


# ---------------------------------------------------------------------------
# the client: latency mode and its breaker
# ---------------------------------------------------------------------------

FOUNDERS = """
definition user {}
definition document {
    relation founder: user
    permission view = founder
}
"""
FOUNDER_CHECKS = [("document:readme", "view", f"user:{n}")
                  for n in ("jake", "joey", "jimmy", "judas", "jeb")] + [
    ("document:readme", "founder", "user:jake")]


def _founders(new, rel, background, *opts, **kw):
    c = new(*opts, **kw)
    ctx = background()
    c.write_schema(ctx, FOUNDERS)
    txn = rel.Txn()
    for name in ("jake", "joey", "jimmy"):
        txn.touch(rel.must_from_triple("document:readme", "founder", f"user:{name}"))
    c.write(ctx, txn)
    return c, ctx, [rel.must_from_triple(*t) for t in FOUNDER_CHECKS]


def test_latency_mode_client_agrees_with_the_reference_on_founders():
    jc, jctx, jchecks = _founders(j_new, jrel, j_background, j_with_latency())
    pc, pctx, pchecks = _founders(p_new, prel, p_background, p_with_latency(),
                                  device="cpu")
    before = pmetrics.default.counter("latency.dispatches")
    want = jc.check(jctx, jconsistency.full(), *jchecks)
    got = pc.check(pctx, pconsistency.full(), *pchecks)
    assert got == want == [True, True, True, False, False, True]
    assert pmetrics.default.counter("latency.dispatches") > before


def _breaker_script(new, rel, background, consistency, faults, metrics,
                    with_latency, with_adm, Config, **kw):
    """The reference's breaker walk (tests/test_faults.py:346-387) with the
    fault on the latency site: the trace of (reroutes, state, latency
    dispatches moved) after each step."""
    c, ctx, checks = _founders(new, rel, background, with_latency(), with_adm(
        Config(breaker_threshold=2, breaker_cooldown_s=60.0)), **kw)
    m = metrics.default
    full = consistency.full()
    steps = []

    def step(tag):
        r0 = m.counter("breaker.latency_rerouted")
        l0 = m.counter("latency.dispatches")
        out = c.check(ctx, full, *checks)
        steps.append((tag, out, m.counter("breaker.latency_rerouted") - r0,
                      c._admission.breaker.state,
                      m.counter("latency.dispatches") > l0))

    step("warm")
    with faults.armed("latency.dispatch", times=2):
        step("faulted")
    step("open")
    c._admission.breaker._opened_at -= 61.0
    step("probe")
    faults.reset()
    return steps


def test_breaker_reroutes_and_recovers_like_the_reference():
    want = _breaker_script(j_new, jrel, j_background, jconsistency, jfaults,
                           jmetrics, j_with_latency, j_with_adm, JAdmissionConfig)
    got = _breaker_script(p_new, prel, p_background, pconsistency, pfaults,
                          pmetrics, p_with_latency, p_with_adm, PAdmissionConfig,
                          device="cpu")
    assert got == want
    assert [s[3] for s in got] == [0, 2, 2, 0]  # closed, open, open, closed
    assert got[2][2] == 1 and not got[2][4]  # rerouted, no latency dispatch


# ---------------------------------------------------------------------------
# pins shared across the revisions of a delta chain
# ---------------------------------------------------------------------------

class _Chains:
    """One chain in both packages: revision 1 a full prepare, each later
    one ``prepare(snap, prev=...)`` of the previous."""

    def __init__(self, n_revs=6, **cfg):
        base, writes, (n_users, n_docs) = _chain_world()
        self.writes = writes[: n_revs - 1]
        jcs, pcs = j_compile(j_parse(CHAIN_SCHEMA)), p_compile(p_parse(CHAIN_SCHEMA))
        ji, pi = JInterner(), PInterner()
        for interner in (ji, pi):
            for i in range(n_users):
                interner.node("user", f"u{i}")
        jsnap = j_build_rels(1, jcs, ji, [jrel.must_from_triple(*t) for t in base],
                             epoch_us=EPOCH)
        psnap = p_build_rels(1, pcs, pi, [prel.must_from_triple(*t) for t in base],
                             epoch_us=EPOCH)
        self.je = JEngine(jcs, JConfig(pallas=False, **cfg))
        self.pe = PEngine(pcs, PConfig(**cfg), device="cpu")
        self.j = [self.je.prepare(jsnap)]
        self.p = [self.pe.prepare(psnap)]
        for rev, (adds, dels) in enumerate(self.writes, start=2):
            jsnap = j_apply(jsnap, rev, [jrel.must_from_triple(*t) for t in adds],
                            [jrel.must_from_triple(*t) for t in dels], interner=ji)
            psnap = p_apply(psnap, rev, [prel.must_from_triple(*t) for t in adds],
                            [prel.must_from_triple(*t) for t in dels], interner=pi)
            self.j.append(self.je.prepare(jsnap, prev=self.j[-1]))
            self.p.append(self.pe.prepare(psnap, prev=self.p[-1]))
        self.q = _chain_queries(pi, self.writes, n_users, n_docs,
                                pcs.slot_of_name["view"])
        assert np.array_equal(
            self.q[0], _chain_queries(ji, self.writes, n_users, n_docs,
                                      jcs.slot_of_name["view"])[0])

    def dispatch(self, i, q=None):
        """Revision ``i``'s planes through both latency paths, and the
        port's eager ones: (port, reference, eager)."""
        q = self.q if q is None else q
        got = self.pe.latency_path(self.p[i]).dispatch_columns(*q, now_us=EPOCH)
        want = self.je.latency_path(self.j[i]).dispatch_columns(*q, now_us=EPOCH)
        return got, want, self.pe.check_columns(self.p[i], *q, now_us=EPOCH)


def test_delta_chain_shares_one_pin_per_key_and_answers_each_revision():
    """Five delta revisions of one shape band share the pin the first of
    them captured: switching revisions A -> B -> A -> C... on one pin,
    each dispatch gives the reference's planes for ITS revision (the
    revisions' answers differ), and only the first switch to a revision
    copies its tensors."""
    ch = _Chains(n_revs=7)
    deltas = ch.p[1:]
    assert all(d.flat_meta.delta is not None for d in deltas)
    assert len({d.flat_meta for d in deltas}) == 1
    assert len({tuple((k, tuple(v.shape)) for k, v in sorted(d.arrays.items()))
                for d in deltas}) == 1
    planes = {}
    m0 = pmetrics.default.counter("latency.rebinds")
    for i in (1, 2, 1, 3, 4, 2, 5, 6, 6, 1):
        got, want, eager = ch.dispatch(i)
        assert _same(got, want) and _same(got, eager), i
        planes.setdefault(i, got[0].copy())
    assert len({p.tobytes() for p in planes.values()}) == len(planes)
    paths = [ch.pe.latency_path(d) for d in deltas]
    assert [lp.compile_count for lp in paths] == [1, 0, 0, 0, 0, 0]
    assert all(lp.pin_count == 1 for lp in paths)
    assert len({id(pin) for lp in paths for pin in lp.pins().values()}) == 1
    pin = next(iter(paths[0].pins().values()))
    # the overlays, and the node column the fresh users replaced
    assert {k for k in pin.band.private if not k.startswith("dl_")} == {"node_type"}
    # every dispatch after the first switched revision except the repeat
    assert pmetrics.default.counter("latency.rebinds") - m0 == 8
    # the full-prepared revision is its own key (no overlays)
    got, want, eager = ch.dispatch(0)
    assert _same(got, want) and _same(got, eager)
    assert ch.pe.latency_path(ch.p[0]).compile_count == 1


def test_band_buffers_are_shared_by_its_pins_and_copied_once_a_switch():
    """Two tiers of one band are two pins over ONE set of private
    buffers: a revision switch copies its tensors once, and the other
    tier's first dispatch at that revision copies nothing; every answer
    is the reference's."""
    ch = _Chains(n_revs=3)
    small = tuple(c[:200] for c in ch.q)
    assert ch.q[0].shape[0] > 256
    lp1, lp2 = (ch.pe.latency_path(d) for d in ch.p[1:3])
    for i, q in ((1, small), (1, ch.q), (2, small)):
        got, want, eager = ch.dispatch(i, q)
        assert _same(got, want) and _same(got, eager), i
    assert lp2.last_budget.rebind_bytes > 0
    got, want, eager = ch.dispatch(2)
    assert _same(got, want) and _same(got, eager)
    assert lp2.last_budget.rebind_bytes == 0 and not lp2.last_budget.compiled
    pins = list(lp1.pins().values())
    assert len(pins) == 2 and pins[0].band is pins[1].band
    assert lp2.pins().keys() == lp1.pins().keys()
    assert len(ch.pe._latency_bands) == 1 + (ch.p[0].latency_path is not None)


def test_full_reprepare_and_grown_band_capture_anew():
    """A full prepare of a chain revision (new base storage) captures its
    own pin, and so does a revision whose overlay crossed into the next
    shape band; both answer as the reference."""
    ch = _Chains(n_revs=3)
    for i in (1, 2):
        got, want, _e = ch.dispatch(i)
        assert _same(got, want)
    assert [ch.pe.latency_path(d).compile_count for d in ch.p[1:]] == [1, 0]
    full = ch.pe.prepare(ch.p[2].snapshot)
    lp = ch.pe.latency_path(full)
    assert _same(lp.dispatch_columns(*ch.q, now_us=EPOCH),
                 ch.je.latency_path(ch.j[2]).dispatch_columns(*ch.q, now_us=EPOCH))
    assert lp.compile_count == 1
    # grow the overlay past its band: many readers in one write
    jsnap, psnap = ch.j[2].snapshot, ch.p[2].snapshot
    adds = [("doc:d%d" % (i % 40), "reader", "user:u%d" % (i % 30)) for i in range(60)]
    jsnap = j_apply(jsnap, 4, [jrel.must_from_triple(*t) for t in adds], [],
                    interner=jsnap.interner)
    psnap = p_apply(psnap, 4, [prel.must_from_triple(*t) for t in adds], [],
                    interner=psnap.interner)
    ch.j.append(ch.je.prepare(jsnap, prev=ch.j[2]))
    ch.p.append(ch.pe.prepare(psnap, prev=ch.p[2]))
    assert ch.p[3].delta_acc is not None
    grown = {k for k, v in ch.p[3].arrays.items()
             if k.startswith("dl_") and tuple(v.shape) != tuple(ch.p[2].arrays[k].shape)}
    assert grown
    got, want, eager = ch.dispatch(3)
    assert _same(got, want) and _same(got, eager)
    assert ch.pe.latency_path(ch.p[3]).compile_count == 1


def test_evicted_full_prepare_base_is_held_by_no_pin():
    """A latency-mode client along a chain that bails to a full prepare:
    once the client's dsnap LRU no longer holds the first base, its
    tensors are freed (no pin keeps them alive), and with no help from
    the caller the engine holds no pin of a band none of whose revisions
    is cached; every answer equals the reference client's."""
    import gc
    import weakref

    kw = dict(flat_delta_floor=4, flat_delta_min_compact=16)
    base, writes, _sizes = _chain_world()
    jc = j_new(j_with_latency(), j_with_config(JConfig(pallas=False, **kw)))
    pc = p_new(p_with_latency(), p_with_config(PConfig(**kw)), device="cpu")
    ctxs = []
    for c, rel_mod, bg in ((jc, jrel, j_background), (pc, prel, p_background)):
        ctx = bg()
        c.write_schema(ctx, CHAIN_SCHEMA)
        txn = rel_mod.Txn()
        for t in base:
            txn.touch(rel_mod.must_from_triple(*t))
        c.write(ctx, txn)
        ctxs.append(ctx)
    checks = [("doc:d%d" % d, "view", "user:u%d" % u) for d in range(0, 40, 3)
              for u in range(0, 30, 7)]

    def check_both():
        want = jc.check(ctxs[0], jconsistency.full(),
                        *[jrel.must_from_triple(*t) for t in checks])
        got = pc.check(ctxs[1], pconsistency.full(),
                       *[prel.must_from_triple(*t) for t in checks])
        assert got == want
        return pc._dsnap_cache[max(pc._dsnap_cache)]

    first = check_both()
    assert first.delta_acc is None
    ref = weakref.ref(first.arrays["ehx"] if "ehx" in first.arrays
                      else next(iter(first.arrays.values())))
    fulls = []
    for adds, dels in writes:
        for c, rel_mod, ctx in ((jc, jrel, ctxs[0]), (pc, prel, ctxs[1])):
            txn = rel_mod.Txn()
            for t in adds:
                txn.touch(rel_mod.must_from_triple(*t))
            for t in dels:
                txn.delete(rel_mod.must_from_triple(*t))
            c.write(ctx, txn)
        ds = check_both()
        fulls.append(ds.delta_acc is None)
    # the chain bailed to a full prepare, and the LRU holds only its
    # revisions since
    assert any(fulls[:-pc.SNAPSHOT_CACHE_MAX])
    del first, ds
    gc.collect()
    assert ref() is None, "a freed base is still held"
    # the engine dropped the pins of every band no cached revision is in
    eng = pc._engine
    live = {id(d.latency_path._band) for d in pc._dsnap_cache.values()
            if d.latency_path is not None and d.latency_path._band is not None}
    assert eng._latency_pins
    assert {id(k[0]) for k in eng._latency_pins} <= live
    assert {id(b) for b in eng._latency_bands.values()} <= live
    # and all of them once the client's cache lets go of its revisions
    pc._dsnap_cache.clear()
    gc.collect()
    assert not eng._latency_pins and not eng._latency_bands


def test_shared_pin_under_concurrent_revisions():
    """More threads than cores, at a short switch interval, dispatch two
    revisions that share one pin: every answer is its own revision's
    (the pin's copy-in, replay and read-back are one critical section)."""
    import os
    import sys
    import threading

    ch = _Chains(n_revs=3)
    want = {i: ch.pe.check_columns(ch.p[i], *ch.q, now_us=EPOCH) for i in (1, 2)}
    assert not _same(want[1], want[2])
    n = len(os.sched_getaffinity(0)) + 1
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(t):
            for k in range(3):
                i = 1 + (t + k) % 2
                got = ch.pe.latency_path(ch.p[i]).dispatch_columns(*ch.q, now_us=EPOCH)
                if not _same(got, want[i]):
                    errors.append((t, k, i))

        ts = [threading.Thread(target=worker, args=(t,)) for t in range(n)]
        for x in ts:
            x.start()
        for x in ts:
            x.join(timeout=120)
        assert not any(x.is_alive() for x in ts)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert sum(ch.pe.latency_path(d).compile_count for d in ch.p[1:]) == 1
