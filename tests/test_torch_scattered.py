"""The port's scattered table layout against the reference's.

``EngineConfig(flat_blockslice=False)`` keeps each hash table as bucket
offsets, a row permutation and full-width int32 key and payload columns,
probed by the plain gathers ``probe_rows``/``probe_range``
(engine/hash.py) at every site of the flat program.  It has no
permission fold, no reverse index, no ancestor closure, no packing and
no delta level.  Built from the same inputs, the port must reproduce the
reference package (``gochugaru_tpu``), bit for bit:

- ``probe_rows``/``probe_range`` against the reference's, elementwise:
  hits, misses, -1 keys, duplicate keys (the first row wins), an empty
  table, ``[B]`` and ``[B, K]`` query shapes;
- ``prepare_host``'s arrays and FlatMeta against the reference's
  ``flat_blockslice=False`` prepare;
- the (definite, possible, overflow) planes against the reference's
  scattered program (``pallas=False``) on every world of
  test_torch_engine.py, the feature worlds of
  tests/test_flat_engine.py (seeds 7 and 8) and a permission-userset
  world; the port's scattered planes against its blockslice ones where
  the reference's ``test_blockslice_scatter_parity`` asserts it;
- the witness codes, lookups, and a write (a full prepare) through the
  client, against the reference client.

Every output is int or bool: exact equality.  The card is held to the
CPU by tests/test_torch_scattered_cuda.py and by chip_smoke.py phase 19.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_flat_engine as TF
import test_torch_client as TC
import test_torch_engine as TE
import test_torch_explain as TX
import gochugaru_tpu.client as jclient
from gochugaru_tpu import consistency as jcons, rel as jrel
from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pcons, rel as prel
from gochugaru_tpu_torch.client import new_evaluator, with_engine_config
from gochugaru_tpu_torch.engine import hash as PH
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.store.store import parse_revision
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils.context import background

NOW = TE.NOW
SCATTERED = {"flat_blockslice": False}


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------


def _pad(a, size, fill):
    out = np.full(size, fill, np.int32)
    out[: a.shape[0]] = a
    return out


def _table(seed, n=3_000, dup=6):
    """Two key columns with ``dup`` copies of one full key (distinct rows,
    same bucket) as ``put_hash`` lays them out: off, rows padded to
    pow2, key columns padded with -1; ``n`` is the static row count."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, n // 4, n).astype(np.int32)
    k2 = rng.integers(0, 30, n).astype(np.int32)
    k1[:dup], k2[:dup] = 5, 7
    h = JH.build_hash([k1, k2])
    R = PH._ceil_pow2(h.rows.shape[0])
    E = PH._ceil_pow2(max(n, 1))
    return dict(off=h.off, rows=_pad(h.rows, R, 0),
                keys=[_pad(k1, E, -1), _pad(k2, E, -1)],
                cap=h.cap, n=PH._ceil_pow2(max(h.n, 1)), raw=(k1, k2))


def _queries(t, shape, seed):
    """Query columns of ``shape``: present keys, the duplicated key, -1
    keys on either column and absent pairs."""
    rng = np.random.default_rng(seed)
    k1, k2 = t["raw"]
    qi = rng.integers(0, k1.shape[0], shape)
    q1, q2 = k1[qi].copy(), k2[qi].copy()
    f1, f2 = q1.reshape(-1), q2.reshape(-1)
    f1[:6] = (5, -1, 5, 10**6, -1, 5)
    f2[:6] = (7, 7, -1, 3, -1, 29)
    f2[-40:] = rng.integers(30, 40, 40)  # absent pairs
    return q1, q2


def _ref_rows(t, qs):
    return np.asarray(JH.probe_rows(
        jnp.asarray(t["off"]), jnp.asarray(t["rows"]),
        [jnp.asarray(k) for k in t["keys"]], [jnp.asarray(q) for q in qs],
        t["cap"], t["n"]))


def _port_rows(t, qs):
    return PH.probe_rows(
        torch.from_numpy(t["off"]), torch.from_numpy(t["rows"]),
        [torch.from_numpy(k) for k in t["keys"]],
        [torch.from_numpy(np.asarray(q)) for q in qs], t["cap"], t["n"])


@pytest.mark.parametrize("shape", [(500,), (60, 9)], ids=["B", "BK"])
def test_probe_rows_matches_reference(shape):
    t = _table(1)
    qs = _queries(t, shape, 2)
    got = _port_rows(t, qs)
    want = _ref_rows(t, qs)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)
    g = got.numpy().reshape(-1)
    assert (g >= 0).any() and (g < 0).any()
    assert (g[[1, 2, 4]] == -1).all()  # a -1 key matches nothing


def test_probe_rows_broadcasts_b_against_bk():
    """A ``[B, 1]`` column against a ``[B, K]`` one, as the KU and arrow
    expansions probe the closure: the same rows as the full-shape query."""
    t = _table(3)
    q1, q2 = _queries(t, (40, 7), 4)
    q1 = np.repeat(q1[:, :1], 7, axis=1)
    got = _port_rows(t, (q1[:, :1], q2))
    assert tuple(got.shape) == (40, 7)
    assert np.array_equal(got.numpy(), _ref_rows(t, (q1[:, :1], q2)))
    assert np.array_equal(got.numpy(), _port_rows(t, (q1, q2)).numpy())


def test_probe_rows_first_duplicate_wins():
    """Six rows hold the key (5, 7): the probe returns the one the bucket
    lists first, as the reference's does (the gate reads that row)."""
    t = _table(5)
    got = int(_port_rows(t, (np.array([5]), np.array([7])))[0])
    h = int(PH.bucket_of([torch.tensor([5]), torch.tensor([7])],
                         t["off"].shape[0] - 1)[0])
    lo, hi = int(t["off"][h]), int(t["off"][h + 1])
    dups = [int(r) for r in t["rows"][lo:hi]
            if t["keys"][0][r] == 5 and t["keys"][1][r] == 7]
    assert len(dups) == 6 and got == dups[0]
    assert got == int(_ref_rows(t, (np.array([5]), np.array([7])))[0])


def test_probe_rows_on_an_empty_table():
    """An empty table as the build lays it out (``n`` padded to 8):
    every query misses, the reference's too."""
    h = JH.build_hash([np.zeros(0, np.int32)])
    t = dict(off=h.off, rows=_pad(h.rows, 8, 0), keys=[np.full(8, -1, np.int32)],
             cap=h.cap, n=8)
    q = (np.array([0, 5, -1], np.int32),)
    got = _port_rows(t, q)
    assert got.tolist() == [-1, -1, -1]
    assert np.array_equal(got.numpy(), _ref_rows(t, q))


@pytest.mark.parametrize("shape", [(300,), (30, 8)], ids=["B", "BK"])
def test_probe_range_matches_reference(shape):
    rng = np.random.default_rng(6)
    k = np.sort(rng.integers(0, 400, 2_000)).astype(np.int32)
    ri = JH.build_range_hash(k)
    G = PH._ceil_pow2(max(ri.gk.shape[0], 1))
    arrs = dict(gk=_pad(ri.gk, G, -1), glo=_pad(ri.glo, G, 0),
                ghi=_pad(ri.ghi, G, 0), off=ri.index.off,
                rows=_pad(ri.index.rows, PH._ceil_pow2(ri.index.rows.shape[0]), 0))
    n = PH._ceil_pow2(max(ri.index.n, 1))
    q = rng.integers(-2, 450, shape).astype(np.int32)
    lo, hi = PH.probe_range({k_: torch.from_numpy(v) for k_, v in arrs.items()},
                            ri.index.cap, n, torch.from_numpy(q))
    jlo, jhi = JH.probe_range({k_: jnp.asarray(v) for k_, v in arrs.items()},
                              ri.index.cap, n, jnp.asarray(q))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    miss = ~np.isin(q, k)
    assert miss.any() and (lo.numpy()[miss] == 0).all() and (hi.numpy()[miss] == 0).all()
    assert (hi.numpy()[~miss] > lo.numpy()[~miss]).all()


# ---------------------------------------------------------------------------
# worlds: the build and the planes
# ---------------------------------------------------------------------------


def _feature_world(seed):
    """tests/test_flat_engine.py's feature world (caveats, expiry,
    wildcards, nested groups, a folder tree, bans) at that file's
    recursion budget and lattice width."""
    rng = random.Random(seed)
    rels = TF.build_feature_world(rng)
    checks = TF.make_checks(rng, 10, 10, n=48)
    return TE.World(TF.FEATURES, rels=rels, checks=checks,
                    flat_recursion=3, flat_max_width=32)


PUS_SCHEMA = """
definition user {}
definition team { relation member: user | team#member | document#view }
definition document {
    relation viewer: user | team#member
    relation shared: document#view
    permission view = viewer + shared
}
"""


def _pus_world():
    """Permission usersets: team membership fed by ``document#view`` (the
    ``push`` table) and a ``shared`` relation on ``document#view``."""
    rng = random.Random(9)
    rels = []
    for d in range(12):
        for u in rng.sample(range(10), 2):
            rels.append(jrel.must_from_triple(f"document:d{d}", "viewer", f"user:u{u}"))
    for t in range(4):
        rels.append(jrel.must_from_tuple(f"team:t{t}#member", f"document:d{t}#view"))
        rels.append(jrel.must_from_triple(f"team:t{t}", "member", f"user:u{t + 5}"))
    rels.append(jrel.must_from_tuple("team:t3#member", "team:t1#member"))
    for d in range(4, 12):
        rels.append(jrel.must_from_tuple(f"document:d{d}#viewer",
                                         f"team:t{d % 4}#member"))
    for d in range(8, 12):
        rels.append(jrel.must_from_tuple(f"document:d{d}#shared",
                                         f"document:d{d - 8}#view"))
    checks = [jrel.must_from_triple(f"document:d{d}", "view", f"user:u{u}")
              for d in range(12) for u in range(10)]
    checks += [jrel.must_from_tuple("document:d9#view", "document:d1#view"),
               jrel.must_from_tuple("document:d5#viewer", "team:t1#member")]
    return TE.World(PUS_SCHEMA, rels=rels, checks=checks)


WORLDS = dict(TE.WORLDS)
WORLDS["feature_7"] = lambda: _feature_world(7)
WORLDS["feature_8"] = lambda: _feature_world(8)
WORLDS["permission_usersets"] = _pus_world


def _scattered(w):
    w.cfg = dict(w.cfg, **SCATTERED)
    return w


@pytest.fixture(scope="module", params=sorted(WORLDS))
def sworld(request):
    w = _scattered(WORLDS[request.param]())
    je = w.j_engine()
    jd = je.prepare(w.j_snap)
    assert not jd.flat_meta.blockslice
    np_arrays = {k: np.asarray(v) for k, v in jd.arrays.items()}
    return request.param, w, je, jd, np_arrays


def test_scattered_prepare_matches_reference(sworld):
    """Key for key and bit for bit, with equal FlatMeta: the scattered
    tables (``*_off``/``*_rows``/``*_gk``/``*_glo``/``*_ghi``, ``e_k1``,
    ``cl_*``, ``t_*``, ``us_srel_d``, ...), the raw per-edge columns the
    gates read, and none of the fold, reverse, ancestor or packed ones."""
    _name, w, _je, jd, np_arrays = sworld
    pe = w.p_engine()
    arrays, meta = pe.prepare_host(w.p_snap)
    assert set(arrays) == set(np_arrays)
    for k, v in np_arrays.items():
        assert arrays[k].dtype == v.dtype, k
        assert np.array_equal(arrays[k], v), k
    jm = dataclasses.asdict(jd.flat_meta)
    pm = dataclasses.asdict(meta)
    assert pm == {k: jm[k] for k in pm}
    assert not meta.blockslice and not meta.fold_pairs and not meta.has_rev
    assert not meta.packed and not meta.rc_slots and not meta.aligned
    for k in ("eh_off", "eh_rows", "e_k1", "e_k2", "usr_gk", "arr_ghi",
              "clh_rows", "cl_d_until", "push_off", "pus_k", "ovf_k",
              "us_srel_d", "us_subj", "ar_child", "e_exp"):
        assert k in arrays, k
    for k in ("ehx", "usx", "usgx", "arx", "argx", "clx", "tx", "pusx",
              "ovfx", "rvx", "pfx"):
        assert k not in arrays, k


def test_scattered_planes_match_reference(sworld):
    name, w, je, jd, _np_arrays = sworld
    ref = TE._ref_planes(w, je, jd)
    pe = w.p_engine()
    pd = pe.prepare(w.p_snap)
    got = TE._port_planes(w, pe, pd)
    for nm, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), nm
    assert ref[0].any() and (~ref[1]).any()
    if name.startswith("closure_overflow"):
        assert pd.flat_meta.has_ovf and ref[2].any()


def test_scattered_planes_on_reference_arrays(sworld):
    """arrays_from_reference: the reference's scattered tables through the
    port's program give the reference's planes."""
    _name, w, je, jd, np_arrays = sworld
    pe = w.p_engine()
    pd = pe.snapshot_from_reference(w.p_snap, np_arrays, jd.flat_meta,
                                    jd.strings)
    got = TE._port_planes(w, pe, pd)
    for nm, a, b in zip("dpo", TE._ref_planes(w, je, jd), got):
        assert np.array_equal(a, b), nm


def test_world_coverage():
    """The worlds reach the sites the layout changes: the tri VM on
    caveated rows, expiry, wildcard edges and closure, the T-index, the
    push probe and closure overflow."""
    metas = {}
    for name in ("random_caveats", "feature_7", "permission_usersets",
                 "closure_overflow", "docs", "rbac_walked"):
        w = _scattered(WORLDS[name]())
        metas[name] = w.p_engine().prepare_host(w.p_snap)[1]
    assert metas["random_caveats"].e_hascav and metas["random_caveats"].us_hascav
    assert metas["feature_7"].e_hasexp and metas["feature_7"].has_wc_edges
    assert metas["feature_7"].has_wc_closure
    assert metas["closure_overflow"].has_ovf
    assert any(m.has_tindex for m in metas.values())
    w = WORLDS["permission_usersets"]()
    assert w.p_cs.has_permission_usersets
    assert w.p_snap.pus_n.shape[0] > 0
    assert metas["docs"].ar_fanout_by_slot and metas["rbac_walked"].us_fanout_by_slot


@pytest.mark.parametrize("seed", [7, 8])
def test_scattered_equals_blockslice(seed):
    """The reference's test_blockslice_scatter_parity on the port: the two
    layouts agree plane for plane on the feature worlds."""
    w = _feature_world(seed)
    eb = w.p_engine()
    es = _scattered(_feature_world(seed)).p_engine()
    assert eb.config.flat_blockslice and not es.config.flat_blockslice
    db = eb.prepare(w.p_snap)
    ds = es.prepare(w.p_snap)
    assert db.flat_meta.blockslice and not ds.flat_meta.blockslice
    for nm, a, b in zip("dpo", TE._port_planes(w, eb, db),
                        TE._port_planes(w, es, ds)):
        assert np.array_equal(a, b), nm


def test_scattered_program_launches_no_kernel():
    """``kernels=True`` on a scattered snapshot: the program has no probe
    kernel site.  On the CPU a wrapper never launches; the card's twin of
    this test is in tests/test_torch_scattered_cuda.py."""
    w = _scattered(TE._rbac_world())
    pe = w.p_engine()
    pd = pe.prepare(w.p_snap)
    K.reset_launches()
    TE._port_planes(w, pe, pd)
    assert not any(K.LAUNCHES.values())


# ---------------------------------------------------------------------------
# witness codes, lookups and writes through the client
# ---------------------------------------------------------------------------


def test_witness_codes_match_reference():
    """The reference's branch-class world on the scattered layout: codes
    equal to the reference's and naming each branch (no fold here, so the
    admin arrow is the rewrite), explain trees equal to the reference's
    but for ``duration_ms``."""

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
        (("doc:t", "reader", "user:bob"), "t_probe"),
        (("doc:a", "admin", "user:root"), "rewrite"),
        (("doc:a", "read", "user:alice"), "direct"),
        (("doc:a", "reader", "user:bob"), None),
    ]
    codes, trees = {}, {}
    for pkg in TX.PKG:
        rel, cons = TX.PKG[pkg][0], TX.PKG[pkg][1]
        c, _ = TX._client(pkg, TX.CLASS_SCHEMA, txn_fn, cfg=SCATTERED)
        _snap, engine, dsnap = TX._engine_of(c, cons)
        assert not dsnap.flat_meta.blockslice
        rels = [rel.must_from_tuple(*a) if len(a) == 2
                else rel.must_from_triple(*a) for a, _ in cases]
        codes[pkg] = engine.witness_codes(dsnap, rels)
        trees[pkg] = [TX._tree(c.explain(TX.PKG[pkg][5](), cons.full(), r))
                      for r in rels]
    assert codes["port"].dtype == np.int32
    assert np.array_equal(codes["port"], codes["reference"])
    assert [TX.pex.witness_name(int(w)) for w in codes["port"]] == [
        b for _, b in cases]
    assert trees["port"] == trees["reference"]


def test_witness_codes_match_reference_on_worlds():
    """Engine-level witness codes on the caveated and feature worlds."""
    for make in (lambda: TE._random_world(caveats=True),
                 lambda: _feature_world(7)):
        w = _scattered(make())
        je = w.j_engine()
        jd = je.prepare(w.j_snap)
        pe = w.p_engine()
        pd = pe.prepare(w.p_snap)
        want = je.witness_codes(jd, w.checks, now_us=NOW)
        got = pe.witness_codes(pd, [TE._port_rel(c) for c in w.checks],
                               now_us=NOW)
        assert np.array_equal(got, want)
        assert (got != 0).any()


def test_single_row_witness_codes_match_reference():
    """A row's code depends on its batch's permission set (ROADMAP queue 3
    item 13): on the rbac world some ``read`` rows report ``rewrite`` in
    the read+admin batch and another branch alone.  The port's codes
    equal the reference's both ways."""
    w = _scattered(TE._rbac_world())
    je = w.j_engine()
    jd = je.prepare(w.j_snap)
    pe = w.p_engine()
    pd = pe.prepare(w.p_snap)
    pchecks = [TE._port_rel(c) for c in w.checks]
    batch = pe.witness_codes(pd, pchecks, now_us=NOW)
    assert np.array_equal(batch, je.witness_codes(jd, w.checks, now_us=NOW))
    single = np.array([pe.witness_codes(pd, [c], now_us=NOW)[0]
                       for c in pchecks])
    diff = np.nonzero(batch != single)[0]
    assert diff.size
    want = [je.witness_codes(jd, [w.checks[i]], now_us=NOW)[0] for i in diff]
    assert single[diff].tolist() == [int(x) for x in want]


@pytest.fixture(scope="module")
def sclients():
    triples = TC._triples(3)
    half = len(triples) // 2
    pc = new_evaluator(with_engine_config(PConfig(**SCATTERED)), device="cpu")
    jc = jclient.new_tpu_evaluator(
        jclient.with_engine_config(JConfig(pallas=False, **SCATTERED)))
    assert TC._write_all(pc, prel, background(), triples, half) == TC._write_all(
        jc, jrel, j_background(), triples, half)
    return pc, jc


def test_client_checks_match_reference(sclients):
    pc, jc = sclients
    got = pc.check(background(), pcons.full(), *TC._checks(prel, 9))
    want = jc.check(j_background(), jcons.full(), *TC._checks(jrel, 9))
    assert got == want and any(got) and not all(got)
    head = pc.store.snapshot_for(pcons.full())
    ds = pc._dsnap_for(pc._engine_for(head), head)
    assert not ds.flat_meta.blockslice


def test_lookups_match_reference_on_the_walker(sclients):
    """No reverse index: lookups take the walker (never the device
    frontier nor the fused program) and equal the reference client's."""
    pc, jc = sclients
    m = pmetrics.default
    before = {k: m.counter(k) for k in
              ("lookups.walker", "lookups.frontier", "lookups.fused")}
    for u in range(6):
        got = list(pc.lookup_resources(background(), pcons.full(), "repo#read",
                                       f"user:u{u}"))
        want = list(jc.lookup_resources(j_background(), jcons.full(), "repo#read",
                                        f"user:u{u}"))
        assert got == want
    for r in range(4):
        got = list(pc.lookup_subjects(background(), pcons.full(), f"repo:r{r}",
                                      "admin", "user"))
        want = list(jc.lookup_subjects(j_background(), jcons.full(), f"repo:r{r}",
                                       "admin", "user"))
        assert got == want
    moved = {k: m.counter(k) - v for k, v in before.items()}
    assert moved["lookups.walker"] >= 10
    assert moved["lookups.frontier"] == 0 and moved["lookups.fused"] == 0


def test_write_takes_a_full_prepare_and_answers_as_reference():
    triples = TC._triples(4)
    half = len(triples) // 2
    pc = new_evaluator(with_engine_config(PConfig(**SCATTERED)), device="cpu")
    jc = jclient.new_tpu_evaluator(
        jclient.with_engine_config(JConfig(pallas=False, **SCATTERED)))
    TC._write_all(pc, prel, background(), triples, half)
    TC._write_all(jc, jrel, j_background(), triples, half)
    pc.check(background(), pcons.full(), *TC._checks(prel, 2, n=8))
    jc.check(j_background(), jcons.full(), *TC._checks(jrel, 2, n=8))
    out = {}
    for c, mod, cons, bg in ((pc, prel, pcons, background),
                             (jc, jrel, jcons, j_background)):
        txn = mod.Txn()
        txn.create(mod.must_from_triple("repo:r2", "reader", "user:u29"))
        txn.delete(mod.must_from_triple(*triples[0][:3]))
        tok = c.write(bg(), txn)
        checks = [mod.must_from_triple("repo:r2", "read", "user:u29"),
                  mod.must_from_triple(*triples[0][:3])] + TC._checks(mod, 5)
        out[mod] = (tok, c.check(bg(), cons.at_least(tok), *checks))
    assert out[prel][1] == out[jrel][1]
    assert out[prel][1][0] and not out[prel][1][1]
    ds = pc._dsnap_cache[parse_revision(out[prel][0])]
    assert ds.flat_meta.delta is None and ds.delta_acc is None
    assert not ds.flat_meta.blockslice


def test_engine_builds_for_the_scattered_layout():
    cs = TC.compile_schema(TC.parse_schema(TC.SCHEMA))
    eng = DeviceEngine(cs, PConfig(**SCATTERED), device="cpu")
    assert not eng.config.flat_blockslice and not eng.config.packed_on()
