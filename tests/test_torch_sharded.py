"""The port's model-sharded mesh against the reference's and its own
unsharded engine.

``parallel.ShardedEngine`` runs the flat (or legacy) program once per
position of a (data × model) mesh of torch devices, each on a thread of
its own, with the collectives of parallel/collectives.py at the merge
points.  Here the mesh is ``[torch.device("cpu")] * n`` — the port's
counterpart of the reference's 8 virtual CPU devices (tests/conftest.py)
— and every output is int or bool, so the tolerance is exact equality:

- ``build_flat_arrays_sharded``'s arrays and FlatMeta equal the
  reference's for M in {1, 2, 4, 8}, under both builds (partition-first
  and full-then-stack);
- the port's ShardedEngine gives the reference ShardedEngine's planes on
  its 8-device mesh (two shapes: each costs a JAX compile), over its own
  tables and over the reference's (``snapshot_from_reference``);
- on the other shapes the port's sharded planes equal its unsharded ones:
  (8, 1), (4, 2), the legacy (2, 3) (a non-pow2 model size, which the
  reference's placement refuses), and worlds with the fold, wildcards,
  the T-index, caveats, ancestor closures and closure overflow;
- the sharded delta chain equals a full sharded prepare (and the
  unsharded engine); sharded lookups equal unsharded ones; ``with_mesh``
  through the client answers as a client without a mesh and as the
  oracle;
- a shard that raises makes the dispatch raise, a barrier that times out
  breaks, and no shard thread is left waiting.
"""

import random
import threading

import numpy as np
import pytest
import torch

import test_flat_engine as TF
import test_torch_client as TC
import test_torch_engine as TE
import test_torch_scattered as TSC
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.engine.flat import build_flat_arrays_sharded as j_build_sharded
from gochugaru_tpu.engine.oracle import Oracle as JOracle, T as JT
from gochugaru_tpu.engine.plan import EngineConfig as JConfig, build_plan as j_plan
from gochugaru_tpu.parallel import ShardedEngine as JSharded, make_mesh as j_make_mesh

from gochugaru_tpu_torch import consistency as pcons, rel as prel
from gochugaru_tpu_torch.client import new_evaluator, with_mesh
from gochugaru_tpu_torch.engine import device as pdevice
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.flat import (
    build_flat_arrays_sharded, make_flat_fn, placement_split,
)
from gochugaru_tpu_torch.engine.lookup import (
    lookup_resources_device, lookup_subjects_device,
)
from gochugaru_tpu_torch.engine.plan import EngineConfig, build_plan
from gochugaru_tpu_torch.parallel import (
    MODEL_AXIS, ShardedEngine, default_mesh, make_mesh,
)
from gochugaru_tpu_torch.parallel import collectives as C
from gochugaru_tpu_torch.parallel.sharded import resident_bytes
from gochugaru_tpu_torch.store.delta import apply_delta
from gochugaru_tpu_torch.store.store import parse_revision
from gochugaru_tpu_torch.utils import metrics
from gochugaru_tpu_torch.utils.context import background

NOW = TE.NOW
CPU8 = [torch.device("cpu")] * 8

SCHEMA = """
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


def _mesh(data, model):
    return make_mesh(data, model, devices=CPU8)


def sharded_world(seed=7):
    """tests/test_sharded.py's world (``build_world``), in both
    packages, with its query batch."""
    rng = random.Random(seed)
    triples = []
    users = [f"user:u{i}" for i in range(40)]
    teams = [f"team:t{i}" for i in range(6)]
    orgs = [f"org:o{i}" for i in range(3)]
    repos = [f"repo:r{i}" for i in range(20)]
    for t in teams:
        for u in rng.sample(users, 8):
            triples.append((f"{t}#member", u))
    for o in orgs:
        triples.append((f"{o}#admin", rng.choice(users)))
        for t in rng.sample(teams, 2):
            triples.append((f"{o}#member", f"{t}#member"))
    for r in repos:
        triples.append((f"{r}#org", rng.choice(orgs)))
        triples.append((f"{r}#maintainer", f"{rng.choice(teams)}#member"))
        for u in rng.sample(users, 3):
            triples.append((f"{r}#reader", u))
    rels = [jrel.must_from_tuple(*t) for t in triples]
    checks = []
    rng2 = random.Random(seed + 1)
    for r in repos:
        for u in rng2.sample(users, 8):
            checks.append(jrel.must_from_triple(
                r, rng2.choice(["read", "admin"]), u))
    w = TE.World(SCHEMA, rels=rels, checks=checks)
    w.rels = rels
    return w


WORLDS = {
    "sharded": sharded_world,
    "docs": TE._docs_world,
    "docs_walked": lambda: TE._docs_world(flat_fold=False),
    "docs_ancestor_closure": lambda: TE._docs_world(
        flat_fold=False, flat_recursion=1),
    "rbac_walked": lambda: TE._rbac_world(flat_fold=False),
    "random_expiry_wildcards": TE._random_world,
    "random_caveats": lambda: TE._random_world(caveats=True),
    "closure_overflow_caveats": lambda: TE._random_world(cap=4, caveats=True),
    "feature_7": lambda: TSC._feature_world(7),
    "permission_usersets": TSC._pus_world,
}


def _j_config(w, **kw):
    return JConfig(pallas=False, spmm=False, **w.cfg, **kw)


def _unsharded(w, **kw):
    pe = w.p_engine(**kw)
    return TE._port_planes(w, pe, pe.prepare(w.p_snap))


def _assert_planes(got, want, what=""):
    for nm, a, b in zip("dpo", got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{what} plane {nm}"


def _no_shard_threads():
    return not any(t.name.startswith("gochugaru-shard-")
                   for t in threading.enumerate())


# ---------------------------------------------------------------------------
# the sharded build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", ["partition", "stack"])
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["sharded", "docs", "random_caveats",
                                  "feature_7"])
def test_sharded_build_matches_reference(name, M, build):
    """Every stacked table (primary, closure, pus, ovf, userset / arrow
    ranges, T join, reverse index, fold, ancestor closures) key for key
    and bit for bit, packed lanes included, and an equal FlatMeta."""
    w = WORLDS[name]()
    part = build == "partition"
    ja, jm, _jf, _jc = j_build_sharded(
        w.j_snap, _j_config(w, flat_partition_build=part), M,
        plan=j_plan(w.j_cs))
    pa, pm, _pf, pc = build_flat_arrays_sharded(
        w.p_snap, EngineConfig(flat_partition_build=part, **w.cfg), M,
        plan=build_plan(w.p_cs))
    assert set(pa) == set(ja)
    for k, v in ja.items():
        assert pa[k].dtype == v.dtype and np.array_equal(pa[k], v), k
    assert pdevice._meta_from(jm) == pm
    assert pm.sharded and pm.blockslice and pc is None
    for k in ("eh_off", "ehx", "clx", "usx", "argx", "rvx"):
        assert pa[k].shape[0] % M == 0, k


def test_partition_chunk_and_fields():
    """``EngineConfig(flat_partition_build=, flat_partition_chunk=)`` is
    accepted (it raised TypeError before the mesh slice), and a chunk of
    a few rows gives the same tables as one chunk."""
    w = WORLDS["feature_7"]()
    plan = build_plan(w.p_cs)
    one, _m1, _, _ = build_flat_arrays_sharded(
        w.p_snap, EngineConfig(**w.cfg), 4, plan=plan)
    small, _m2, _, _ = build_flat_arrays_sharded(
        w.p_snap, EngineConfig(flat_partition_chunk=7, **w.cfg), 4, plan=plan)
    for k in one:
        assert np.array_equal(one[k], small[k]), k
    cfg = EngineConfig(flat_partition_build=False, flat_partition_chunk=5)
    assert not cfg.flat_partition_build and cfg.flat_partition_chunk == 5
    assert EngineConfig().flat_partition_build


# ---------------------------------------------------------------------------
# against the reference's ShardedEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_planes_match_reference_sharded_engine(shape):
    """The reference ShardedEngine on its 8-virtual-device mesh and the
    port's on an 8-position CPU mesh: the same planes, over the port's
    own tables and over the reference's stacked arrays, and verdicts
    equal to the oracle's."""
    w = WORLDS["sharded"]()
    je = JSharded(w.j_cs, j_make_mesh(*shape), _j_config(w))
    jd = je.prepare(w.j_snap)
    ref = je.check_batch(jd, w.checks, now_us=NOW)
    pe = ShardedEngine(w.p_cs, _mesh(*shape), EngineConfig(**w.cfg))
    pd = pe.prepare(w.p_snap)
    assert pd.flat_meta.sharded and pdevice._meta_from(jd.flat_meta) == pd.flat_meta
    got = TE._port_planes(w, pe, pd)
    _assert_planes(got, ref, "own tables")
    np_arrays = {k: np.asarray(v) for k, v in jd.arrays.items()}
    on_ref = pe.snapshot_from_reference(w.p_snap, np_arrays, jd.flat_meta,
                                        jd.strings)
    _assert_planes(TE._port_planes(w, pe, on_ref), ref, "reference tables")
    oracle = JOracle(w.j_cs, w.rels, now_us=NOW)
    d, p, ovf = got
    assert not ovf.any()
    for i, q in enumerate(w.checks):
        assert bool(d[i]) == (oracle.check_relationship(q) == JT), q
    assert pe.last_collectives["calls"] > 0


# ---------------------------------------------------------------------------
# against the port's unsharded engine
# ---------------------------------------------------------------------------

CASES = [
    ("sharded", (8, 1)), ("sharded", (4, 2)), ("sharded", (2, 3)),
    ("docs", (2, 4)), ("docs_walked", (1, 8)),
    ("docs_ancestor_closure", (2, 4)), ("rbac_walked", (4, 2)),
    ("random_expiry_wildcards", (2, 4)), ("random_caveats", (1, 4)),
    ("closure_overflow_caveats", (2, 2)), ("closure_overflow_caveats", (1, 3)),
    ("feature_7", (2, 4)), ("feature_7", (2, 3)),
    ("permission_usersets", (4, 2)),
]


@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{d}x{m}" for n, (d, m) in CASES])
def test_sharded_planes_match_unsharded(name, shape):
    """A pow2 model size runs the bucket-sharded flat program; a model
    size of 3 the sharded legacy program (held to the unsharded legacy
    engine).  No probe kernel is counted on a mesh."""
    w = WORLDS[name]()
    pe = ShardedEngine(w.p_cs, _mesh(*shape), EngineConfig(**w.cfg))
    pd = pe.prepare(w.p_snap)
    flat = shape[1] & (shape[1] - 1) == 0
    assert (pd.flat_meta is not None) == flat
    K.reset_launches()
    got = TE._port_planes(w, pe, pd)
    assert not any(K.LAUNCHES.values())
    want = _unsharded(w) if flat else _unsharded(w, use_flat=False)
    _assert_planes(got, want, name)
    assert got[0].any()
    if name.startswith("closure_overflow"):
        assert got[2].any()


def test_world_coverage():
    """The worlds reach the sites the mesh changes: the fold (pf probes,
    its userset slice and the subject closure slice broadcast), the
    T-index, wildcards, caveats, ancestor closures, arrows, closure
    overflow and permission usersets."""
    metas = {n: build_flat_arrays_sharded(
        w.p_snap, EngineConfig(**w.cfg), 2, plan=build_plan(w.p_cs))[1]
        for n, w in ((n, WORLDS[n]()) for n in WORLDS)}
    assert metas["docs"].fold_pairs and metas["docs"].pf_has_u
    assert metas["rbac_walked"].has_tindex and not metas["rbac_walked"].fold_pairs
    assert metas["random_expiry_wildcards"].has_wc_edges
    assert metas["random_caveats"].e_hascav and metas["random_caveats"].us_hascav
    assert metas["docs_ancestor_closure"].rc_slots
    assert metas["closure_overflow_caveats"].has_ovf
    assert metas["feature_7"].has_wc_closure
    assert WORLDS["permission_usersets"]().p_cs.has_permission_usersets


def test_slot_chunking_matches_unsharded():
    """More distinct permissions than ``flat_max_slots``: the sharded
    dispatch runs slot chunks (both slot rows of the query matrix
    spliced), the unsharded engine the legacy program; the definite and
    possible planes agree wherever neither overflows."""
    w = WORLDS["feature_7"]()
    pe = ShardedEngine(w.p_cs, _mesh(2, 2),
                       EngineConfig(flat_max_slots=1, **w.cfg))
    pd = pe.prepare(w.p_snap)
    got = TE._port_planes(w, pe, pd)
    ref = _unsharded(w)
    _assert_planes(got, ref, "chunked")


def test_pipelined_and_fetchless_dispatch():
    w = WORLDS["sharded"]()
    pe = ShardedEngine(w.p_cs, _mesh(2, 2), EngineConfig(**w.cfg))
    pd = pe.prepare(w.p_snap)
    q, _ = pe._lower_queries(w.p_snap, [TE._port_rel(c) for c in w.checks],
                             pd.strings)
    want = pe.check_columns(pd, q["q_res"], q["q_perm"], q["q_subj"],
                            now_us=NOW)
    d, p, o = pe.check_columns(pd, q["q_res"], q["q_perm"], q["q_subj"],
                               now_us=NOW, fetch=False)
    B = q["q_res"].shape[0]
    assert d.shape[0] >= B and np.array_equal(d[:B].numpy(), want[0])
    parts = list(pe.check_columns_pipelined(
        pd, q["q_res"], q["q_perm"], q["q_subj"], now_us=NOW, sub_batch=48))
    assert len(parts) > 1
    for lo, hi, pd_, pp_, po_ in parts:
        assert np.array_equal(pd_, want[0][lo:hi])
        assert np.array_equal(pp_, want[1][lo:hi])
        assert np.array_equal(po_, want[2][lo:hi])


# ---------------------------------------------------------------------------
# the delta chain and lookups
# ---------------------------------------------------------------------------


def _feature_state(seed, shape=(2, 4)):
    rng = random.Random(seed)
    rels = [TE._port_rel(r) for r in TF.build_feature_world(rng)]
    w = TE.World(TF.FEATURES, rels=TF.build_feature_world(random.Random(seed)),
                 flat_recursion=3, flat_max_width=32)
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot

    interner = Interner()
    snap = build_snapshot(1, w.p_cs, interner, rels, epoch_us=NOW)
    sh = ShardedEngine(w.p_cs, _mesh(*shape), EngineConfig(**w.cfg))
    single = DeviceEngine(w.p_cs, EngineConfig(**w.cfg), device="cpu")
    return rng, rels, w, interner, snap, sh, single


def _checks(rng, extra=()):
    return [TE._port_rel(c) for c in TF.make_checks(rng, 10, 12, n=32)] + list(extra)


def test_sharded_delta_chain_matches_full_prepare():
    """Chained revisions of direct, userset and caveated adds and base-row
    deletes on a (2, 4) mesh: each revision takes the incremental path
    (the sharded base tables stay resident — the same tensors — and only
    the replicated ``dl_*`` overlays ship), and its planes equal a full
    sharded prepare's and the unsharded engine's."""
    rng, rels, w, interner, snap, sh, single = _feature_state(3)
    prev = sh.prepare(snap)
    used = sorted({r.subject_id for r in rels if r.subject_type == "group"
                   and r.subject_relation == "member"})
    readers = [r for r in rels if r.resource_type == "doc"
               and r.resource_relation == "reader" and not r.caveat_name
               and r.expiration is None]
    for revision in (2, 3, 4):
        adds = [
            prel.must_from_triple(f"doc:d{revision}", "reader",
                                  f"user:shnew{revision}"),
            prel.must_from_tuple(f"doc:d{revision + 3}#reader",
                                 f"group:{used[0]}#member"),
            prel.must_from_triple(f"doc:d{revision + 1}", "reader", "user:u2"
                                  ).with_caveat("tier", {"min": revision}),
        ]
        deletes = [readers.pop()]
        snap = apply_delta(snap, revision, adds, deletes, interner=interner)
        inc = sh.prepare(snap, prev=prev)
        assert inc.flat_meta.delta is not None, f"rev {revision} fell back"
        assert inc.flat_meta.sharded and inc.delta_acc is not None
        for k, v in prev.arrays.items():
            if not k.startswith("dl_") and k in inc.arrays and v.sharded:
                assert inc.arrays[k] is v, k
        assert all(not inc.arrays[k].sharded for k in inc.arrays
                   if k.startswith("dl_"))
        full = sh.prepare(snap)
        assert full.flat_meta.delta is None
        checks = _checks(rng, [
            prel.must_from_triple(f"doc:d{revision}", "read",
                                  f"user:shnew{revision}")] + [
            prel.must_from_triple(f"doc:{d.resource_id}", "read",
                                  f"user:{d.subject_id}") for d in deletes])
        a = sh.check_batch(inc, checks, now_us=NOW)
        _assert_planes(a, sh.check_batch(full, checks, now_us=NOW),
                       f"rev {revision} full")
        _assert_planes(a, single.check_batch(single.prepare(snap), checks,
                                             now_us=NOW),
                       f"rev {revision} unsharded")
        prev = inc


def test_sharded_delta_userset_tombstone():
    """Deleting a base userset row under a T-covered slot: the replicated
    dirty-group mask voids the bucket-sharded T answers and the forced KU
    pass (tombstones masked over the broadcast candidate block)
    re-derives the union."""
    rng, rels, w, interner, snap, sh, single = _feature_state(11)
    prev = sh.prepare(snap)
    meta = prev.flat_meta
    names = {v: k for k, v in w.p_cs.slot_of_name.items()}
    t_named = {names[s] for s in meta.t_slots} if meta.has_tindex else set()
    target = next(r for r in rels if r.subject_relation == "member"
                  and r.resource_type in ("doc", "folder")
                  and r.resource_relation in t_named)
    snap2 = apply_delta(snap, 2, [], [target], interner=interner)
    inc = sh.prepare(snap2, prev=prev)
    assert inc.flat_meta.delta.has_ustomb and inc.flat_meta.delta.t_dirty
    checks = _checks(rng, [prel.must_from_tuple(
        f"{target.resource_type}:{target.resource_id}"
        f"#{target.resource_relation}",
        f"{target.subject_type}:{target.subject_id}#{target.subject_relation}")])
    a = sh.check_batch(inc, checks, now_us=NOW)
    _assert_planes(a, sh.check_batch(sh.prepare(snap2), checks, now_us=NOW))
    _assert_planes(a, single.check_batch(single.prepare(snap2), checks,
                                         now_us=NOW))


def test_sharded_lookups_match_unsharded():
    """LookupResources / LookupSubjects over the sharded reverse index
    (owner-routed hops, no collective; the exact filter through the mesh
    dispatch) give the unsharded engine's answers."""
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.engine.oracle import Oracle

    rng, rels, w, interner, snap, sh, single = _feature_state(4)
    progs = {n: compile_cel(n, d.params, d.expression)
             for n, d in w.p_cs.schema.caveats.items()}
    oracle = Oracle(w.p_cs, rels, progs, now_us=NOW)
    sds, ods = sh.prepare(snap), single.prepare(snap)
    assert sds.flat_meta.has_rev and sds.flat_meta.has_fw
    before = metrics.default.counter("lookups.frontier")
    hops = metrics.default.counter("lookup.hops")
    for u in ("u0", "u3", "u7"):
        want = lookup_resources_device(single, ods, "doc", "read", "user", u,
                                       now_us=NOW, oracle_factory=lambda: oracle)
        got = lookup_resources_device(sh, sds, "doc", "read", "user", u,
                                      now_us=NOW, oracle_factory=lambda: oracle)
        assert got == want, u
    for d in ("d0", "d4", "d7"):
        want = lookup_subjects_device(single, ods, "doc", d, "read", "user",
                                      now_us=NOW, oracle_factory=lambda: oracle)
        got = lookup_subjects_device(sh, sds, "doc", d, "read", "user",
                                     now_us=NOW, oracle_factory=lambda: oracle)
        assert got == want, d
    assert metrics.default.counter("lookups.frontier") >= before + 12
    assert metrics.default.counter("lookup.hops") > hops
    from gochugaru_tpu_torch.engine import spmv

    st = spmv.state_for(sh, sds)
    assert st._hops is not None and st._spmm is None and not st.kern.kernels


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


def test_with_mesh_client_matches_plain_client_and_oracle():
    """``with_mesh(make_mesh(2, 2, devices=[cpu]*4))``: checks, writes
    followed by checks (the sharded delta path) and lookups answer as a
    client without a mesh, and the checks as the oracle."""
    triples = TC._triples(3)
    half = len(triples) // 2
    ctx = background()
    mc = new_evaluator(with_mesh(_mesh(2, 2)))
    pc = new_evaluator(device="cpu")
    assert mc.device == torch.device("cpu")
    revs = [TC._write_all(c, prel, ctx, triples, half) for c in (mc, pc)]
    assert revs[0] == revs[1]
    checks = TC._checks(prel, 11)
    got = mc.check(ctx, pcons.full(), *checks)
    assert got == pc.check(ctx, pcons.full(), *checks)
    oracle = JOracle(TC.j_compile(TC.j_parse(TC.SCHEMA)),
                     TC._rels(jrel, triples))
    for c, v in zip(TC._checks(jrel, 11), got):
        assert v == (oracle.check_relationship(c) == JT), c
    assert isinstance(mc._engine, ShardedEngine)
    # a membership row (team:t2#member) rebuilds on a mesh, as the
    # reference's sharded prepare does: the closure advance is
    # single-device
    for adds, deletes, incremental in (
        ([("repo:r1", "reader", "user:u29", None)], [], True),
        ([("repo:r2", "banned", "user:u28", None)],
         [("repo:r3", "reader", "user:*", None)], True),
        ([("team:t2", "member", "user:u28", None)], [], False),
    ):
        for c in (mc, pc):
            txn = prel.Txn()
            for r in TC._rels(prel, adds):
                txn.touch(r)
            for r in TC._rels(prel, deletes):
                txn.delete(r)
            rev = c.write(ctx, txn)
        checks = TC._checks(prel, 17)
        assert (mc.check(ctx, pcons.at_least(rev), *checks)
                == pc.check(ctx, pcons.at_least(rev), *checks))
        ds = mc._dsnap_cache[parse_revision(rev)]
        assert ds.flat_meta.sharded
        assert (ds.flat_meta.delta is not None) == incremental
    for u in ("user:u1", "user:u28", "user:u29"):
        assert (sorted(mc.lookup_resources(ctx, pcons.full(), "repo#read", u))
                == sorted(pc.lookup_resources(ctx, pcons.full(), "repo#read", u)))
    for r in ("repo:r1", "repo:r2"):
        got = list(mc.lookup_subjects(ctx, pcons.full(), r, "read", "user"))
        assert got and got == list(
            pc.lookup_subjects(ctx, pcons.full(), r, "read", "user"))


def test_with_mesh_explain_matches_reference_mesh_client():
    """Explain on a ``with_mesh`` client: the armed (witness) program is
    single-device, so a sharded snapshot yields no witness codes and the
    walk runs unseeded, as on the reference's mesh client.  No explain
    counts a witness error, and the trees (``explain`` and
    ``check(explain=True)``) equal the reference mesh client's."""
    import test_torch_explain as TX
    from gochugaru_tpu.client import with_mesh as j_with_mesh

    def txn_fn(rel):
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:a", "reader", "user:alice"))
        txn.touch(rel.must_from_triple("doc:w", "reader", "user:*"))
        txn.touch(rel.must_from_triple("team:t", "member", "user:bob"))
        txn.touch(rel.must_from_tuple("doc:t#reader", "team:t#member"))
        txn.touch(rel.must_from_triple("doc:a", "org", "org:o"))
        txn.touch(rel.must_from_triple("org:o", "admin", "user:root"))
        return txn

    cases = [("doc:a", "reader", "user:alice"), ("doc:w", "reader", "user:zed"),
             ("doc:t", "reader", "user:bob"), ("doc:a", "admin", "user:root"),
             ("doc:a", "read", "user:alice"), ("doc:a", "reader", "user:bob")]
    meshes = {"reference": j_with_mesh(j_make_mesh(1, 2)),
              "port": with_mesh(_mesh(1, 2))}
    out = {}
    for pkg in TX.PKG:
        rel, cons = TX.PKG[pkg][0], TX.PKG[pkg][1]
        c, _ = TX._client(pkg, TX.CLASS_SCHEMA, txn_fn, meshes[pkg])
        _snap, engine, dsnap = TX._engine_of(c, cons)
        assert dsnap.flat_meta.sharded
        rels = [rel.must_from_triple(*a) for a in cases]
        assert engine.witness_codes(dsnap, rels) is None
        m = c._metrics
        e0 = m.counter("explain.witness_errors")
        ctx = TX.PKG[pkg][5]()
        trees = [TX._tree(c.explain(ctx, cons.full(), r)) for r in rels]
        got = c.check(ctx, cons.full(), *rels, explain=True)
        assert m.counter("explain.witness_errors") == e0, pkg
        assert [TX._tree(e.explanation) for e in got] == trees
        out[pkg] = ([e.allowed for e in got], trees)
    assert out["port"] == out["reference"]
    assert out["port"][0] == [True, True, True, True, True, False]


def test_with_mesh_partitioned_option_set():
    """``with_mesh(partitioned=True)`` makes a client of the partitioned
    serve (tests/test_torch_routed.py drives it); without a mesh the
    option is off."""
    c = new_evaluator(with_mesh(_mesh(1, 2), partitioned=True))
    assert c._mesh_partitioned and c._mesh.shape["model"] == 2
    assert not new_evaluator(device="cpu")._mesh_partitioned


# ---------------------------------------------------------------------------
# the mesh, its collectives and its failures
# ---------------------------------------------------------------------------


def test_make_mesh():
    m = make_mesh(2, 3, devices=CPU8)
    assert m.shape == {"data": 2, MODEL_AXIS: 3}
    assert m.devices[1][2] == torch.device("cpu")
    with pytest.raises(ValueError):
        make_mesh(3, 3, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(0, 2, devices=CPU8)
    if torch.cuda.device_count() == 0:
        # no cards: no silent CPU mesh
        with pytest.raises(ValueError):
            make_mesh(1, 1)
        with pytest.raises(ValueError):
            default_mesh()


def test_collectives_off_and_on_mesh():
    x = torch.tensor([0, 1, 0, 1], dtype=torch.bool)
    assert C.OFF.por(x) is x and C.OFF.axis_size() == 1
    assert C.OFF.all_gather(x).shape == (1, 4)
    mesh = _mesh(2, 3)

    def body(r, j, comm):
        v = torch.tensor([j == 0, j == 2, r == 1, False])
        return (comm.axis_index(), comm.axis_size(), comm.por(v),
                comm.psum(torch.full((2,), j + 10 * r, dtype=torch.int32)),
                comm.all_gather(torch.tensor([j])))

    res, comms = C.run_mesh(mesh, body)
    for r in range(2):
        for j in range(3):
            idx, size, o, s, g = res[r][j]
            assert (idx, size) == (j, 3)
            assert o.tolist() == [True, True, r == 1, False]
            assert s.tolist() == [3 + 30 * r] * 2
            assert g.tolist() == [[0], [1], [2]]
            assert comms[r][j].calls == 3
    assert _no_shard_threads()


def test_collectives_under_thread_switching():
    """Sixteen shard threads, a switch interval of a microsecond and 300
    back-to-back collectives each: every sum and gather is exact, so no
    shard ever read another collective's slots or result."""
    import sys

    mesh = make_mesh(2, 8, devices=[torch.device("cpu")] * 16)
    rounds = 300

    def body(r, j, comm):
        bad = 0
        for k in range(rounds):
            s = comm.psum(torch.tensor([k * 100 + j + 1000 * r]))
            bad += int(s.item()) != 800 * k + 28 + 8000 * r
            g = comm.all_gather(torch.tensor([k, j]))
            bad += g[:, 1].tolist() != list(range(8)) or bool((g[:, 0] != k).any())
        return bad

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res, comms = C.run_mesh(mesh, body, timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert all(b == 0 for row in res for b in row)
    assert all(c.calls == 2 * rounds for row in comms for c in row)
    assert _no_shard_threads()


def test_shard_error_raises_and_no_thread_waits():
    mesh = _mesh(2, 4)

    def body(r, j, comm):
        comm.por(torch.ones(3, dtype=torch.bool))
        if (r, j) == (1, 2):
            raise KeyError("shard 1.2 failed")
        return comm.por(torch.ones(3, dtype=torch.bool))

    with pytest.raises(KeyError, match="shard 1.2"):
        C.run_mesh(mesh, body, timeout=60)
    assert _no_shard_threads()

    # a shard that skips a collective: its row's barrier times out
    def skip(r, j, comm):
        if j == 1:
            return None
        return comm.por(torch.ones(1, dtype=torch.bool))

    with pytest.raises(threading.BrokenBarrierError):
        C.run_mesh(_mesh(1, 2), skip, timeout=0.2)
    assert _no_shard_threads()


def test_engine_dispatch_raises_the_shard_error(monkeypatch):
    """A shard whose program raises mid-dispatch: the dispatch raises that
    shard's error, and a later dispatch on the same engine answers."""
    w = WORLDS["rbac_walked"]()
    pe = ShardedEngine(w.p_cs, _mesh(2, 4), EngineConfig(**w.cfg))
    pd = pe.prepare(w.p_snap)
    checks = [TE._port_rel(c) for c in w.checks]
    want = pe.check_batch(pd, checks, now_us=NOW)
    real = pe._flat_fn_for

    def failing(slots, meta, witness=False):
        fn = real(slots, meta, witness=witness)

        def wrapped(arrs, tid, now, qm, qctx, specs, comm=None):
            comm.por(torch.zeros(1, dtype=torch.bool))
            if comm.axis_index() == 3:
                raise RuntimeError("shard program failed")
            return fn(arrs, tid, now, qm, qctx, specs, comm=comm)

        return wrapped

    monkeypatch.setattr(pe, "_flat_fn_for", failing)
    with pytest.raises(RuntimeError, match="shard program failed"):
        pe.check_batch(pd, checks, now_us=NOW)
    assert _no_shard_threads()
    monkeypatch.undo()
    _assert_planes(pe.check_batch(pd, checks, now_us=NOW), want)


def test_kernel_layout_mismatch_raises():
    """A sharded FlatMeta needs the model axis, and the axis a sharded
    FlatMeta; a part-serve program needs the axis, and a routed one a
    part-serve FlatMeta."""
    import dataclasses

    w = WORLDS["sharded"]()
    plan = build_plan(w.p_cs)
    _a, meta, _f, _c = build_flat_arrays_sharded(
        w.p_snap, EngineConfig(**w.cfg), 2, plan=plan)
    with pytest.raises(ValueError):
        make_flat_fn(w.p_cs, plan, EngineConfig(), meta, (0,))
    flat = dataclasses.replace(meta, sharded=False)
    with pytest.raises(ValueError):
        make_flat_fn(w.p_cs, plan, EngineConfig(), flat, (0,),
                     axis=MODEL_AXIS, model_size=2)
    with pytest.raises(ValueError, match="model axis"):
        make_flat_fn(w.p_cs, plan, EngineConfig(),
                     dataclasses.replace(meta, sharded=False, part_serve=True),
                     (0,))
    with pytest.raises(ValueError, match="part_serve"):
        make_flat_fn(w.p_cs, plan, EngineConfig(), meta, (0,),
                     axis=MODEL_AXIS, model_size=2, routed=True)
    make_flat_fn(w.p_cs, plan, EngineConfig(),
                 dataclasses.replace(meta, part_serve=True), (0,),
                 axis=MODEL_AXIS, model_size=2, routed=True)


def test_placement_bytes_count_a_repeated_device_once():
    """Four shards on one device: the sharded tables are held once (views
    of one copy), the replicated ones once, and the resident total is
    the logical one; ``placement_split`` reads the mesh's own split.  On
    a 2 x 2 mesh of one device the data rows share those copies too."""
    w = WORLDS["docs"]()
    split = {}
    for shape in ((1, 4), (2, 2)):
        pe = ShardedEngine(w.p_cs, make_mesh(*shape, devices=CPU8),
                           EngineConfig(**w.cfg))
        pd = pe.prepare(w.p_snap)
        split[shape] = placement_split(pd)
        res = resident_bytes(pd.arrays)
        assert split[shape]["sharded"] > 0 and split[shape]["replicated"] > 0
        assert res == split[shape]["total"]
        assert metrics.default.gauge("snapshot.device_bytes") == res
    assert split[(1, 4)]["replicated"] == split[(2, 2)]["replicated"]
    assert set(pd.prepare_split) == {"build_s", "place_s"}
    a = pd.arrays["ehx"]
    # (2, 2): shard 1 is a view one shard's rows past shard 0, and data
    # row 1 holds the very same views
    assert a.at(0, 1).data_ptr() == a.at(0, 0).data_ptr() + (
        a.shape[0] // 2) * a.shape[1] * a.element_size()
    assert a.at(1, 1).data_ptr() == a.at(0, 1).data_ptr()
