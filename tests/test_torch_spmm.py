"""The port's fused K-hop lookup program (engine/spmm.py) against the
reference's ``EngineConfig(pallas=False, spmm=True)`` on the CPU.

Each fuzz world (the reference's tests/test_spmm.py schema and
generator, seeds 1, 2 and 7) is built in both packages from the same
relationships, interned in the same order, so node ids agree.  The port
runs its plain probe steps here (``device="cpu"``); the card holds the
kernels to them in tests/test_torch_spmm_cuda.py and chip_smoke.py.
The port must reproduce, exactly (all outputs are int32 ids):

- the fused candidate blocks of ``FusedLookup.resources`` /
  ``.subjects``, block for block and in order, and the overflow
  decision (None), for every query the reference test visits; the full
  answers equal the port's looped path (``spmm=False``) and the oracle;
- ``tjoin_spmm`` byte for byte against the reference's and against
  ``t_join_core`` (a prepare calls ``t_join_core`` whatever the
  config);
- the dispatch contracts: one ``spmm.dispatches`` and no looped
  dispatch for a multi-hop lookup, K fixed rounds == the early-exit
  loop, overflow falls back and counts ``spmm.fallbacks``, cursors
  resume across a fused dispatch, the ``spmm.dispatch`` fault retries
  under the client's envelope, and the config fields and defaults are
  the reference's.
"""

import dataclasses
import gc
import random
import weakref

import numpy as np
import pytest

import test_torch_engine as TE
from test_spmm import FUZZ_SCHEMA, fuzz_world
from gochugaru_tpu.engine import lookup as jlookup
from gochugaru_tpu.engine import spmm as jspmm
from gochugaru_tpu.engine import spmv as jspmv
from gochugaru_tpu.engine.fold import t_join_core as j_t_join_core
from gochugaru_tpu.engine.plan import EngineConfig as JConfig

from gochugaru_tpu_torch import caveats as pcel
from gochugaru_tpu_torch.engine import lookup as plookup
from gochugaru_tpu_torch.engine import spmm as pspmm
from gochugaru_tpu_torch.engine import spmv as pspmv
from gochugaru_tpu_torch.engine.fold import t_join_core
from gochugaru_tpu_torch.engine.oracle import Oracle as POracle
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils.metrics import default as _m

NOW = TE.NOW


def _oracle(w, rels):
    progs = {n: pcel.compile_cel(n, d.params, d.expression)
             for n, d in w.p_cs.schema.caveats.items()}
    return POracle(w.p_cs, [TE._port_rel(r) for r in rels], progs, now_us=NOW)


class SWorld:
    """One fuzz world: the reference's spmm=True engine, the port's
    fused (default) and looped (spmm=False) engines over one snapshot
    each, the port's oracle, and the reference test's queries."""

    def __init__(self, seed):
        rels, users, groups, projs = fuzz_world(seed)
        w = TE.World(FUZZ_SCHEMA, rels=rels)
        self.w = w
        self.je = TE.JEngine(w.j_cs, JConfig(pallas=False, spmm=True, **w.cfg))
        self.jd = self.je.prepare(w.j_snap)
        self.pe = w.p_engine()
        self.pd = self.pe.prepare(w.p_snap)
        self.pe_off = w.p_engine(spmm=False)
        self.pd_off = self.pe_off.prepare(w.p_snap)
        self.oracle = _oracle(w, rels)
        # the queries of the reference's test_spmm_fuzz_parity
        rng = random.Random(seed * 31)
        self.res_q = [("proj", p, "user", u.split(":")[1], "")
                      for u in rng.sample(users, 5) + ["user:stranger"]
                      for p in ("write", "manage")]
        self.res_q += [("proj", "write", "group", g.split(":")[1], "member")
                       for g in groups]
        self.subj_q = []
        for p in rng.sample(projs, 4):
            pid = p.split(":")[1]
            self.subj_q += [("proj", pid, perm, "user", "")
                            for perm in ("write", "manage")]
            self.subj_q.append(("proj", pid, "write", "group", "member"))


SEEDS = (1, 2, 7)
_WORLDS = {}


@pytest.fixture(scope="module", params=SEEDS)
def sw(request):
    if request.param not in _WORLDS:
        _WORLDS[request.param] = SWorld(request.param)
    return _WORLDS[request.param]


def _same_blocks(got, want):
    if got is None or want is None:
        return got is None and want is None
    return len(got) == len(want) and all(
        np.array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))
        for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# (a) fused blocks, their order and overflow == the reference's
# ---------------------------------------------------------------------------


def test_fused_blocks_match_reference(sw):
    jst = jspmv.state_for(sw.je, sw.jd)
    pst = pspmv.state_for(sw.pe, sw.pd)
    assert jst._spmm is not None and pst._spmm is not None
    served = 0
    for q in sw.res_q:
        jr = jlookup._resolve_resources(sw.jd, *q)
        assert jr == plookup._resolve_resources(sw.pd, *q), q
        if jr is None:
            continue
        rtid, _p, srel, subj, wc = jr
        want = jst._spmm.resources(rtid, subj, srel, wc, NOW)
        got = pst._spmm.resources(rtid, subj, srel, wc, NOW)
        assert _same_blocks(got, want), q
        served += got is not None
    for q in sw.subj_q:
        jr = jlookup._resolve_subjects(sw.jd, *q)
        assert jr == plookup._resolve_subjects(sw.pd, *q), q
        if jr is None:
            continue
        res, _p, srel, stid, wc = jr
        want = jst._spmm.subjects(res, stid, srel, wc, NOW)
        got = pst._spmm.subjects(res, stid, srel, wc, NOW)
        assert _same_blocks(got, want), q
        served += got is not None
    assert served


def test_fused_answers_match_looped_path_and_oracle(sw):
    """Every query's fused candidate set equals the looped path's
    (``spmm=False``), so the one exact filter gives both the same
    answer; that answer, through ``lookup_*_device`` on the fused
    engine, equals the oracle's (every fourth query: the filter's check
    batch is the costly part here)."""
    fst = pspmv.state_for(sw.pe, sw.pd)
    lst = pspmv.state_for(sw.pe_off, sw.pd_off)
    assert lst._spmm is None
    d0 = _m.counter("spmm.dispatches")
    for i, q in enumerate(sw.res_q):
        rtid, _p, srel, subj, wc = plookup._resolve_resources(sw.pd, *q)
        fused = {int(x) for b in fst.resource_candidates(
            rtid, subj, srel, wc, NOW) for x in b}
        looped = {int(x) for b in lst.resource_candidates(
            rtid, subj, srel, wc, NOW) for x in b}
        assert fused == looped, q
        if i % 4 == 0:
            assert plookup.lookup_resources_device(
                sw.pe, sw.pd, *q, now_us=NOW, oracle_factory=lambda: sw.oracle,
            ) == sorted(sw.oracle.lookup_resources(*q)), q
    for i, q in enumerate(sw.subj_q):
        res, _p, srel, stid, wc = plookup._resolve_subjects(sw.pd, *q)
        fused = {int(x) for b in fst.subject_candidates(
            res, stid, srel, wc, NOW) for x in b}
        looped = {int(x) for b in lst.subject_candidates(
            res, stid, srel, wc, NOW) for x in b}
        assert fused == looped, q
        if i % 4 == 0:
            assert plookup.lookup_subjects_device(
                sw.pe, sw.pd, *q, now_us=NOW, oracle_factory=lambda: sw.oracle,
            ) == sorted(sw.oracle.lookup_subjects(*q)), q
    # the fused path served (not silently falling back)
    assert _m.counter("spmm.dispatches") > d0


# ---------------------------------------------------------------------------
# (b) the T-join: the semiring product is the bespoke join, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tjoin_spmm_bitwise_parity(seed):
    rng = np.random.RandomState(seed)
    n_us = int(rng.randint(1, 200))
    n_cl = int(rng.randint(1, 300))
    k1 = rng.randint(0, 50, n_us).astype(np.int64)
    pe = rng.randint(0, 40, n_us).astype(np.int64)
    w = rng.randint(1, 1000, n_us).astype(np.int32)
    cl_k1 = rng.randint(0, 60, n_cl).astype(np.int64)
    cl_k2 = rng.randint(0, 40, n_cl).astype(np.int64)
    c_d = rng.randint(0, 1000, n_cl).astype(np.int32)
    c_p = rng.randint(0, 1000, n_cl).astype(np.int32)
    args = (k1, pe, w, cl_k1, cl_k2, c_d, c_p)
    # plenty / tight / guaranteed closure-overflow caps: the size gate
    # must agree too (None == None)
    for cap in (1 << 30, n_us + n_cl // 2, 1):
        got = pspmm.tjoin_spmm(*args, cap)
        for want in (jspmm.tjoin_spmm(*args, cap), t_join_core(*args, cap),
                     j_t_join_core(*args, cap)):
            if want is None:
                assert got is None
                continue
            assert got is not None and len(got) == len(want)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tjoin_large_join_matches_reference(dtype):
    """A join past the native sort's threshold (65,536 rows) takes the
    native radix sort, with int32 keys and with int64 ones of int32
    range, and gives the reference's tables byte for byte."""
    rng = np.random.RandomState(5)
    n_us, n_cl = 5_000, 3_000
    k1 = rng.randint(-1_000, 2_000, n_us).astype(dtype)
    pe = rng.randint(0, 40, n_us).astype(dtype)
    w = rng.randint(1, 1000, n_us).astype(np.int32)
    cl_k1 = rng.randint(-500, 3_000, n_cl).astype(dtype)
    cl_k2 = rng.randint(0, 40, n_cl).astype(dtype)
    c_d = rng.randint(0, 1000, n_cl).astype(np.int32)
    c_p = rng.randint(0, 1000, n_cl).astype(np.int32)
    args = (k1, pe, w, cl_k1, cl_k2, c_d, c_p, 1 << 30)
    got, want = t_join_core(*args), j_t_join_core(*args)
    assert got[0].shape[0] > (1 << 16)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_masked_semiring_identity_term():
    # one A row, empty B: the product is exactly A's identity rows
    args = (
        np.asarray([7], np.int64), np.asarray([3], np.int64),
        np.asarray([9], np.int32),
        np.empty(0, np.int64), np.empty(0, np.int64),
        (np.empty(0, np.int32), np.empty(0, np.int32)), 16,
    )
    got = pspmm.masked_semiring_spmm(*args)
    want = jspmm.masked_semiring_spmm(*args)
    assert len(got) == len(want) == 4
    for x, y, v in zip(got, want, ([7], [3], [9], [9])):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, v)


# ---------------------------------------------------------------------------
# dispatch contracts (port worlds; the reference's tests/test_spmm.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rbac():
    rels = TE._rbac_rels()
    w = TE.World(TE.G.SCHEMA, rels=rels)
    pe = w.p_engine()
    return w, pe, pe.prepare(w.p_snap), _oracle(w, rels)


def test_multihop_lookup_is_one_device_dispatch(rbac):
    """(c) A LookupResources crossing two hops (the org->admin arrow)
    drains its whole candidate fixpoint in one fused dispatch and no
    looped dispatch."""
    w, pe, pd, oracle = rbac
    st = pspmv.state_for(pe, pd)
    assert st._spmm is not None
    snap = w.p_snap
    rtid = snap.interner.type_lookup("repo")
    # a user who reaches repos through the org->admin arrow
    admins = [r.subject_id for r in TE._rbac_rels() if r.resource_relation == "admin"]
    uid = next(u for u in admins
               if oracle.lookup_resources("repo", "admin", "user", u, ""))
    un = snap.interner.lookup("user", uid)
    d0, l0 = _m.counter("spmm.dispatches"), _m.counter("lookup.dispatches")
    blocks = list(st.resource_candidates(rtid, un, -1, -1, NOW))
    assert _m.counter("spmm.dispatches") - d0 == 1
    assert _m.counter("lookup.dispatches") - l0 == 0
    cands = {int(x) for b in blocks for x in b}
    names = sorted(oracle.lookup_resources("repo", "admin", "user", uid, ""))
    want = {snap.interner.lookup("repo", r) for r in names}
    assert want and want <= cands
    f0 = _m.counter("lookups.fused")
    assert plookup.lookup_resources_device(
        pe, pd, "repo", "admin", "user", uid, "", now_us=NOW,
        oracle_factory=lambda: oracle) == names
    assert _m.counter("lookups.fused") - f0 == 1


def test_dropped_frontier_state_frees_its_fused_server(rbac):
    """The fused server holds its FrontierState weakly, so the two make
    no cycle: with the cyclic collector off, dropping the state frees
    the server (and, on the card, its graphs and their pool memory)."""
    _w, pe, pd, _oracle = rbac
    st = pspmv.FrontierState(pe, pd)
    assert st._spmm is not None and st._spmm.st is st
    ref = weakref.ref(st._spmm)
    was = gc.isenabled()
    gc.disable()
    try:
        del st
        assert ref() is None
    finally:
        if was:
            gc.enable()


def _raw(fl, direction, args):
    """The program's packed outputs, early-exit loop and K fixed rounds."""
    make = fl.resources_inputs if direction == "res" else fl.subjects_inputs
    inp = make(*args, NOW)
    return (fl._dispatch(direction, inp, "loop", False),
            fl._dispatch(direction, inp, "rounds", False))


def test_fixed_rounds_equal_the_early_exit_loop(sw):
    """(d) K fixed rounds (what a graph replays) == the reference's
    early-exit loop, bit for bit, on lookups that converge in fewer than
    K rounds; on a capacity overflow the decision is the same."""
    fl = pspmv.state_for(sw.pe, sw.pd)._spmm
    n = 0
    for q in sw.res_q[:6]:
        rtid, _p, srel, subj, wc = plookup._resolve_resources(sw.pd, *q)
        loop, fixed = _raw(fl, "res", (rtid, subj, srel, wc))
        assert loop[1] == fixed[1], q
        if not loop[1]:
            assert np.array_equal(loop, fixed), q
            n += 1
    for q in sw.subj_q[:3]:
        res, _p, srel, stid, wc = plookup._resolve_subjects(sw.pd, *q)
        loop, fixed = _raw(fl, "subj", (res, stid, srel, wc))
        assert loop[3] == fixed[3], q
        if not loop[3]:
            assert np.array_equal(loop, fixed), q
            n += 1
    assert n


def test_fixed_rounds_equal_the_loop_past_the_round_budget():
    """(d) A folder chain deeper than the round budget: both runs stop
    at K with a live frontier, flag it, and agree bit for bit; with the
    budget raised the same lookup converges and is served."""
    from gochugaru_tpu import rel as jrel

    rels = [jrel.must_from_tuple(f"folder:f{i + 1}#parent", f"folder:f{i}")
            for i in range(12)]
    rels.append(jrel.must_from_tuple("folder:f0#viewer", "user:u0"))
    rels += [jrel.must_from_tuple(f"proj:p{i}#parent", f"folder:f{i}")
             for i in range(13)]
    w = TE.World(FUZZ_SCHEMA, rels=rels)
    oracle = _oracle(w, rels)
    q = ("proj", "write", "user", "u0", "")
    for rounds, ovf in ((3, 1), (20, 0)):
        pe = w.p_engine(spmm_rounds=rounds)
        pd = pe.prepare(w.p_snap)
        fl = pspmv.state_for(pe, pd)._spmm
        rtid, _p, srel, subj, wc = plookup._resolve_resources(pd, *q)
        loop, fixed = _raw(fl, "res", (rtid, subj, srel, wc))
        assert loop[1] == fixed[1] == ovf
        assert np.array_equal(loop, fixed)
        f0 = _m.counter("spmm.fallbacks")
        assert plookup.lookup_resources_device(
            pe, pd, *q, now_us=NOW, oracle_factory=lambda: oracle,
        ) == sorted(oracle.lookup_resources(*q)) == sorted(
            f"p{i}" for i in range(13))
        assert _m.counter("spmm.fallbacks") - f0 == ovf


def test_overflow_falls_back_and_answers_stay_exact(rbac):
    """(e) Tiny capacities overflow every multi-hop lookup: the looped
    path serves, ``spmm.fallbacks`` counts it, answers are exact."""
    w, _pe, _pd, oracle = rbac
    pe = w.p_engine(spmm_rounds=1, spmm_frontier=1, spmm_emit=1,
                    spmm_candidates=2)
    pd = pe.prepare(w.p_snap)
    kern = pspmv.state_for(pe, pd)._spmm.kern
    assert (kern.F, kern.E, kern.C, kern.K) == (256, 1024, 2, 1)
    f0 = _m.counter("spmm.fallbacks")
    for i in range(0, 12, 3):
        for q in (("repo", "read", "user", f"u{i}", ""),
                  ("repo", f"r{i}", "read", "user", "")):
            if q[1] == "read":
                got = plookup.lookup_resources_device(
                    pe, pd, *q, now_us=NOW, oracle_factory=lambda: oracle)
                want = oracle.lookup_resources(*q)
            else:
                got = plookup.lookup_subjects_device(
                    pe, pd, *q, now_us=NOW, oracle_factory=lambda: oracle)
                want = oracle.lookup_subjects(*q)
            assert got == sorted(want), q
    assert _m.counter("spmm.fallbacks") - f0 >= 4


def test_cursor_resume_across_fused_dispatch(rbac):
    """(f) Paged draining over the fused path: cursors round-trip through
    their encoding, and an evicted stream recompute-resumes to the
    identical continuation (the fused program is deterministic)."""
    w, pe, pd, oracle = rbac
    qs = [("repo", "read", "user", f"u{i}", "") for i in range(40)]
    qs = [q for q in qs if len(list(oracle.lookup_resources(*q))) >= 5][:3]
    assert qs
    for q in qs:
        full = plookup.lookup_resources_device(
            pe, pd, *q, now_us=NOW, oracle_factory=lambda: oracle)
        out, cursor, pages = [], None, 0
        d0 = _m.counter("spmm.dispatches")
        while True:
            ids, cursor = plookup.lookup_resources_page(
                pe, pd, *q, page_size=2, cursor=cursor, now_us=NOW,
                oracle_factory=lambda: oracle)
            out.extend(ids)
            pages += 1
            if cursor is None:
                break
            cursor = pspmv.LookupCursor.decode(cursor.encode())
            if pages % 2 == 1:  # evict: the next page recomputes and skips
                pd.__dict__.get("_lookup_streams", {}).clear()
        assert pages > 2 and sorted(out) == full
        assert len(out) == len(set(out))
        assert _m.counter("spmm.dispatches") - d0 >= pages // 2


def test_client_envelope_retries_spmm_dispatch_fault():
    """(g) The armed ``spmm.dispatch`` site retries under the client's
    lookup envelope, as ``lookup.dispatch`` does."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import new_evaluator
    from gochugaru_tpu_torch.utils.context import background

    c = new_evaluator(device="cpu")
    ctx = background()
    c.write_schema(ctx, TE.G.SCHEMA)
    txn = rel.Txn()
    for r in TE._rbac_rels():
        txn.touch(TE._port_rel(r))
    c.write(ctx, txn)
    cs = consistency.full()
    oracle = c._oracle_for(c.store.snapshot_for(cs))
    r0 = _m.counter("retry.retries")
    with pfaults.default.armed("spmm.dispatch", times=1) as spec:
        got = sorted(c.lookup_resources(ctx, cs, "repo#read", "user:u3"))
    assert spec.fired == 1
    assert _m.counter("retry.retries") >= r0 + 1
    assert got == sorted(oracle.lookup_resources("repo", "read", "user", "u3", ""))
    assert pfaults.default.spec("spmm.dispatch") is None


def test_engine_config_takes_the_reference_fields_with_its_defaults():
    """(h) Every field the slice adds is accepted, with the reference's
    defaults; ``spmm`` is on by default."""
    names = ("spmm", "spmm_rounds", "spmm_frontier", "spmm_emit",
             "spmm_candidates", "lookup_chunk", "lookup_frontier_min")
    ref, port = JConfig(), PConfig()
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert port.spmm is True
    cfg = PConfig(spmm=False, spmm_rounds=3, spmm_frontier=300, spmm_emit=2000,
                  spmm_candidates=99, lookup_chunk=4096, lookup_frontier_min=256)
    assert dataclasses.replace(cfg, spmm=True).spmm_candidates == 99
    w = TE.World(TE.G.SCHEMA, rels=TE._rbac_rels())
    pe = w.p_engine(lookup_chunk=4096, lookup_frontier_min=256,
                    spmm_frontier=300, spmm_emit=2000)
    pd = pe.prepare(w.p_snap)
    st = pspmv.state_for(pe, pd)
    assert (st.kern.CH, st.kern.F_min) == (4096, 256)
    assert (st._spmm.kern.F, st._spmm.kern.E) == (512, 2048)
    from gochugaru_tpu_torch.utils import perf

    assert perf.render_report()["spmm"]["dispatches"] == _m.counter("spmm.dispatches")
