"""Decision provenance on the port (engine/explain.py, the witness plane of
``make_flat_fn(witness=True)``, ``Client.explain`` / ``check(explain=True)``,
``LatencyPath.arm_witness``, ``ServingHandle.check(explain=True)``) against
the reference package's.

The same worlds, built from numpy seeds, go through the reference client
(JAX on the CPU, the Pallas kernels off, as its own tests run it) and the
port's on ``cpu`` (the plain twins of the kernels): witness codes are
int32 and must be bit-equal; explain trees must be equal once the one
timing field, ``duration_ms``, is dropped from both; verdicts are bools.
The tolerance is exact equality throughout.  The seeded world and its
checks live in tests/test_torch_explain_cuda.py, which holds the kernels
against their plain twins on the card.
"""

import numpy as np
import pytest

from gochugaru_tpu import consistency as jcons
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import (
    new_tpu_evaluator as j_new, with_engine_config as j_with_cfg,
    with_verdict_cache as j_with_vcache,
)
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import (
    ExplainedCheck, new_evaluator as p_new, with_engine_config as p_with_cfg,
    with_latency_mode as p_with_latency, with_verdict_cache as p_with_vcache,
)
from gochugaru_tpu_torch.engine import explain as pex
from gochugaru_tpu_torch.engine import kernels as pK
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.store.store import parse_revision as p_parse_revision
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils.context import background as p_background
from test_torch_explain_cuda import (
    NOW_US, SCHEMA, _tree, _world_checks, _world_txn,
)

#: the reference's branch-class world (tests/test_explain.py:167-177)
CLASS_SCHEMA = """
definition user {}
definition team { relation member: user }
definition org { relation admin: user }
definition doc {
    relation org: org
    relation reader: user | user:* | team#member
    permission admin = org->admin
    permission read = reader
}
"""

#: (package name, rel module, consistency module, client constructor,
#: engine-config option, EngineConfig, background, extra client kwargs)
PKG = {
    "reference": (jrel, jcons, j_new, j_with_cfg, JConfig, j_background, {}),
    "port": (prel, pcons, p_new, p_with_cfg, PConfig, p_background,
             {"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _reset_port_faults():
    pfaults.reset()
    yield
    pfaults.reset()


def _client(pkg, schema, txn_fn, *opts_extra, cfg=None):
    rel, cons, new, with_cfg, Config, bg, kw = PKG[pkg]
    opts = list(opts_extra)
    if cfg is not None:
        opts.append(with_cfg(Config(**cfg)))
    c = new(*opts, **kw)
    ctx = bg()
    c.write_schema(ctx, schema)
    out = txn_fn(rel)
    c.write(ctx, out[0] if isinstance(out, tuple) else out)
    return c, out


def _engine_of(c, cons):
    snap = c.store.snapshot_for(cons.full())
    engine = c._engine_for(snap)
    return snap, engine, c._dsnap_for(engine, snap)


def _pair(seed, n_checks=30, cfg=None):
    """The seeded world through both clients, and its checks in each
    package's terms."""
    out = {}
    for pkg in PKG:
        c, (txn, rng) = _client(pkg, SCHEMA, lambda rel: _world_txn(rel, seed),
                                cfg=cfg)
        out[pkg] = (c, _world_checks(PKG[pkg][0], rng, n_checks))
    return out


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_witness_codes_and_trees_equal_reference(seed):
    """Witness codes bit-equal to the reference's; every Client.explain
    tree equal to the reference's but for ``duration_ms``, consistent with
    its witness, and its verdict the check's."""
    w = _pair(seed)
    codes, trees, verdicts = {}, {}, {}
    for pkg, (c, checks) in w.items():
        cons = PKG[pkg][1]
        _snap, engine, dsnap = _engine_of(c, cons)
        codes[pkg] = engine.witness_codes(dsnap, checks, now_us=NOW_US)
        ctx = PKG[pkg][5]()
        verdicts[pkg] = c.check(ctx, cons.full(), *checks)
        trees[pkg] = [_tree(c.explain(ctx, cons.full(), r)) for r in checks]
    assert codes["port"].dtype == np.int32
    assert np.array_equal(codes["port"], codes["reference"]), (
        codes["port"].tolist(), codes["reference"].tolist())
    assert verdicts["port"] == verdicts["reference"]
    assert trees["port"] == trees["reference"]
    for i, tree in enumerate(trees["port"]):
        assert (tree["result"] == "allowed") == verdicts["port"][i]
        wc = int(codes["port"][i])
        if wc or tree["result"] != "allowed":
            assert pex.witness_consistent(tree, wc), (i, wc, tree)
    # the armed program's check planes are the disarmed program's
    c, checks = w["port"]
    _snap, engine, dsnap = _engine_of(c, pcons)
    queries, qctx = engine._lower_queries(dsnap.snapshot, checks, dsnap.strings)
    now = dsnap.snapshot.now_rel32(NOW_US)
    fn, args = engine.flat_fn_and_args(dsnap, queries, qctx, now, len(checks))
    wfn, wargs = engine.flat_fn_and_args(dsnap, queries, qctx, now,
                                         len(checks), witness=True)
    plain = fn(*args)
    armed = wfn(*wargs)
    assert len(plain) == 3 and len(armed) == 4 and wfn is not fn
    for a, b in zip(plain, armed[:3]):
        assert np.array_equal(a.numpy(), b.numpy())
    # the columnar entry gives the same codes and planes
    got, planes = engine.witness_codes_columns(
        dsnap, queries["q_res"], queries["q_perm"], queries["q_subj"],
        q_srel=queries["q_srel"], q_wc=queries["q_wc"],
        q_ctx=queries["q_ctx"], qctx_rows=[
            r.caveat_context for r in checks if r.caveat_context] or None,
        now_us=NOW_US, planes=True)
    assert np.array_equal(got, codes["port"])
    for a, b in zip(planes, plain):
        assert np.array_equal(a, b[:len(checks)].numpy())
    # every row the card settles as allowed names its branch; no other does
    assert np.array_equal(got != 0, planes[0] & ~planes[2])


@pytest.mark.parametrize("cfg", [None, {"flat_tindex": False},
                                 {"flat_fold": False}],
                         ids=["default", "no_tindex", "no_fold"])
def test_witness_branch_classes(cfg):
    """Every branch class appears (the reference's
    test_witness_branch_classes_deterministic world), with codes equal to
    the reference's: self, direct, wildcard, the T probe (or, with the T
    index off, the userset x closure path), the fold (or, with the fold
    off, the rewrite)."""

    def txn_fn(rel):
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:a", "reader", "user:alice"))
        txn.touch(rel.must_from_triple("doc:w", "reader", "user:*"))
        txn.touch(rel.must_from_triple("team:t", "member", "user:bob"))
        txn.touch(rel.must_from_tuple("doc:t#reader", "team:t#member"))
        txn.touch(rel.must_from_triple("doc:a", "org", "org:o"))
        txn.touch(rel.must_from_triple("org:o", "admin", "user:root"))
        return txn

    cases = [
        (("doc:a", "reader", "user:alice"), "direct"),
        (("doc:w", "reader", "user:zed"), "wildcard"),
        (("team:t#member", "team:t#member"), "self"),
        (("doc:t", "reader", "user:bob"),
         "userset" if cfg == {"flat_tindex": False} else "t_probe"),
        (("doc:a", "admin", "user:root"),
         "rewrite" if cfg == {"flat_fold": False} else "fold"),
        # a folded permission answers at the fold's root site; unfolded,
        # its program's leaf collects the direct edge under its type mask
        (("doc:a", "read", "user:alice"),
         "direct" if cfg == {"flat_fold": False} else "fold"),
        (("doc:a", "reader", "user:bob"), None),
    ]
    got = {}
    for pkg in PKG:
        rel, cons = PKG[pkg][0], PKG[pkg][1]
        c, _ = _client(pkg, CLASS_SCHEMA, txn_fn, cfg=cfg)
        _snap, engine, dsnap = _engine_of(c, cons)
        rels = [rel.must_from_tuple(*a) if len(a) == 2
                else rel.must_from_triple(*a) for a, _ in cases]
        got[pkg] = engine.witness_codes(dsnap, rels)
        if pkg == "port":
            for (a, branch), r, w in zip(cases, rels, got[pkg]):
                assert pex.witness_name(int(w)) == branch, (a, int(w))
                tree = c.explain(PKG[pkg][5](), cons.full(), r)
                assert pex.witness_consistent(tree, int(w)), (a, tree)
                if branch in ("t_probe", "userset"):
                    # the seeded walk explores the witness class first
                    assert tree["witness"] == branch
    assert np.array_equal(got["port"], got["reference"])


def test_check_explain_verdicts_and_cached_flag():
    """``check(explain=True)`` gives the check's verdicts with trees equal
    to the reference's; under a verdict cache a served verdict explains
    ``cached`` at the pinned revision, and ``full()`` never claims it."""
    out = {}
    for pkg in PKG:
        rel, cons, new, _wc, _C, bg, kw = PKG[pkg]
        vc = j_with_vcache if pkg == "reference" else p_with_vcache
        c, (txn, rng) = _client(pkg, SCHEMA, lambda rel: _world_txn(rel, 5),
                                vc())
        checks = _world_checks(rel, rng, 24)
        ctx = bg()
        cs = cons.min_latency()
        plain = c.check(ctx, cs, *checks)
        again = c.check(ctx, cs, *checks, explain=True)
        full = c.check(ctx, cons.full(), *checks, explain=True)
        out[pkg] = (plain, [(e.allowed, _tree(e.explanation)) for e in again],
                    [(e.allowed, _tree(e.explanation)) for e in full])
        if pkg == "port":
            assert all(isinstance(e, ExplainedCheck) for e in again)
            assert [e.allowed for e in again] == plain
            assert [e.allowed for e in full] == plain
            rev = c.store.snapshot_for(cs).revision
            for e, r in zip(again, checks):
                if r.caveat_context:  # live context: never cache-served
                    assert "cached" not in e.explanation
                assert e.explanation["revision"] == rev
                assert e.explanation["strategy"] == "min_latency"
            assert any(e.explanation.get("cached") for e in again)
            assert not any("cached" in e.explanation for e in full)
    assert out["port"] == out["reference"]


def test_codes_along_a_delta_chain_and_across_layouts():
    """Three writes (direct edges, then a tombstone of one of them and a
    userset grant, then a new team member and a deleted ban) each
    followed by the witness codes at the new revision: the port's
    delta-prepared codes equal the reference's, revision by revision,
    and the aligned layout's equal the off+interleave one's; the
    tombstone clears its edge's ``direct`` witness."""
    writes = [
        [("touch", ("doc:d0", "reader", "user:u1")),
         ("touch", ("doc:d1", "reader", "user:u2"))],
        [("delete", ("doc:d0", "reader", "user:u1")),
         ("touch_tuple", ("doc:d2#reader", "team:t4#member"))],
        [("touch_tuple", ("team:t4#member", "user:u7")),
         ("delete", ("doc:d3", "banned", "user:u5"))],
    ]

    def checks_of(rel):
        rng = np.random.default_rng(3)
        fixed = [rel.must_from_triple(f"doc:d{d}", p, f"user:u{u}")
                 for d in range(4) for p in ("read", "reader")
                 for u in (1, 2, 5, 7)]
        return fixed + _world_checks(rel, rng, 24)

    codes = {}
    for pkg, cfg in (("reference", None), ("port", None),
                     ("port aligned", {"flat_aligned": True})):
        base = pkg.split()[0]
        rel, cons, _n, _w, _C, bg, _kw = PKG[base]
        c, _ = _client(base, SCHEMA, lambda rel: _world_txn(rel, 29)[0],
                       cfg=cfg)
        checks = checks_of(rel)
        ctx = bg()
        c.check(ctx, cons.full(), *checks)  # the base revision resident
        seq = []
        for w in writes:
            txn = rel.Txn()
            for op, a in w:
                r = (rel.must_from_tuple(*a) if op == "touch_tuple"
                     else rel.must_from_triple(*a))
                (txn.delete if op == "delete" else txn.touch)(r)
            rev = c.write(ctx, txn)
            cs = cons.at_least(rev)
            c.check(ctx, cs, *checks)
            snap = c.store.snapshot_for(cs)
            engine = c._engine_for(snap)
            dsnap = c._dsnap_for(engine, snap)
            if base == "port":
                assert dsnap.flat_meta.delta is not None, pkg
                assert snap.revision == p_parse_revision(rev)
            seq.append(engine.witness_codes(dsnap, checks, now_us=NOW_US))
        codes[pkg] = seq
    for a, b, c_ in zip(codes["reference"], codes["port"],
                        codes["port aligned"]):
        assert np.array_equal(a, b) and np.array_equal(b, c_)
    at = checks_of(prel).index(prel.must_from_triple("doc:d0", "reader",
                                                      "user:u1"))
    assert codes["port"][0][at] == pex.WIT_DIRECT
    assert codes["port"][1][at] != pex.WIT_DIRECT


def test_latency_arm_witness():
    """Armed, a latency dispatch leaves the eager codes on
    ``last_witness`` (host-settled rows aside), on pins of its own: the
    disarmed keys are untouched, and disarming replays them."""
    c, (txn, rng) = _client("port", SCHEMA, lambda rel: _world_txn(rel, 11),
                            p_with_latency())
    checks = _world_checks(prel, rng, 40)
    snap, engine, dsnap = _engine_of(c, pcons)
    lp = engine.latency_path(dsnap)
    d, p, ovf = engine.check_batch(dsnap, checks, now_us=NOW_US, latency=True)
    assert lp.last_witness is None and not lp.witness_armed
    disarmed = set(lp.pins())
    assert all(len(k) == 3 for k in disarmed)
    lp.arm_witness()
    want = engine.witness_codes(dsnap, checks, now_us=NOW_US)
    for _ in range(2):
        got = engine.check_batch(dsnap, checks, now_us=NOW_US, latency=True)
        for a, b in zip(got, (d, p, ovf)):
            assert np.array_equal(a, b)
        wit = lp.last_witness.copy()
        wit[(p & ~d) | ovf] = 0
        assert np.array_equal(wit, want)
    armed = set(lp.pins()) - disarmed
    assert armed and all(k[-1] == "wit" for k in armed)
    assert lp.compile_count == 2
    lp.arm_witness(False)
    assert lp.last_witness is None
    engine.check_batch(dsnap, checks, now_us=NOW_US, latency=True)
    assert lp.compile_count == 2 and lp.last_witness is None
    assert set(lp.pins()) == disarmed | armed


def test_serving_handle_explain_matches_reference():
    """``ServingHandle.check(explain=True)``: the coalesced verdicts and
    trees equal the reference handle's."""
    out = {}
    for pkg in PKG:
        rel, cons, _n, _w, _C, bg, _kw = PKG[pkg]
        c, (txn, rng) = _client(pkg, SCHEMA, lambda rel: _world_txn(rel, 47))
        checks = _world_checks(rel, rng, 16)
        with c.with_serving(cs=cons.full()) as h:
            got = h.check(bg(), *checks, explain=True)
            plain = h.check(bg(), *checks)
        assert [e.allowed for e in got] == plain
        out[pkg] = [(e.allowed, _tree(e.explanation)) for e in got]
    assert out["port"] == out["reference"]


def test_explain_walk_fault_retries_without_torn_trees():
    """The ``explain.walk`` fault classifies into the retry envelope:
    every returned tree is complete and verdict-exact."""
    c, (txn, rng) = _client("port", SCHEMA, lambda rel: _world_txn(rel, 77))
    checks = _world_checks(prel, rng, 12)
    ctx = p_background()
    want = c.check(ctx, pcons.full(), *checks)
    m = pmetrics.default
    r0 = m.counter("retry.retries")
    with pfaults.armed("explain.walk", probability=0.5, seed=9) as spec:
        for i, q in enumerate(checks):
            tree = c.explain(ctx, pcons.full(), q)
            assert (tree["result"] == "allowed") == want[i]
            assert tree["tree"] is not None and "verdict" in tree["tree"]
    assert spec.fired > 0
    # a batch retries whole: two faulted walks, then a clean attempt
    with pfaults.armed("explain.walk", times=2) as spec:
        got = c.check(ctx, pcons.full(), *checks, explain=True)
    assert [e.allowed for e in got] == want
    assert all("verdict" in e.explanation["tree"] for e in got)
    assert spec.fired == 2
    assert m.counter("retry.retries") > r0


def test_kernel_error_on_the_witness_path_raises(monkeypatch):
    """A kernel failure inside the armed dispatch propagates out of
    ``check(explain=True)`` and is not counted as a witness error; any
    other witness error degrades to the unseeded walk and is counted."""
    c, (txn, rng) = _client("port", SCHEMA, lambda rel: _world_txn(rel, 23))
    checks = _world_checks(prel, rng, 8)
    ctx = p_background()
    want = c.check(ctx, pcons.full(), *checks)
    m = pmetrics.default
    armed = {"on": False}
    orig_probe = pK.fused_probe
    orig_codes = PEngine.witness_codes

    def failing_probe(*a, **kw):
        if armed["on"]:
            raise pK.KernelError("fused_probe kernel launch failed (cudaError 719)")
        return orig_probe(*a, **kw)

    def witness_codes(self, *a, **kw):
        armed["on"] = True
        try:
            return orig_codes(self, *a, **kw)
        finally:
            armed["on"] = False

    monkeypatch.setattr(pK, "fused_probe", failing_probe)
    monkeypatch.setattr(PEngine, "witness_codes", witness_codes)
    e0 = m.counter("explain.witness_errors")
    with pytest.raises(pK.KernelError):
        c.check(ctx, pcons.full(), *checks, explain=True)
    with pytest.raises(pK.KernelError):
        c.explain(ctx, pcons.full(), checks[0])
    assert m.counter("explain.witness_errors") == e0
    assert c.check(ctx, pcons.full(), *checks) == want

    def broken(self, *a, **kw):
        raise ValueError("not a kernel error")

    monkeypatch.setattr(PEngine, "witness_codes", broken)
    got = c.check(ctx, pcons.full(), *checks, explain=True)
    assert [e.allowed for e in got] == want
    assert all("witness" not in e.explanation for e in got)
    assert m.counter("explain.witness_errors") == e0 + 1
