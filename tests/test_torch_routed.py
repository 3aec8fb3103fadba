"""The port's partitioned serve against the reference's and its own
unsharded engine.

``ShardedEngine.prepare_partitioned`` places a ``partition_feed``
(serve="routed", FlatMeta.part_serve): the primary / fold point / T
tables split along the model axis, every other table whole on each
position.  A routable batch (folded permissions and bare relation
leaves, no wildcard edges, no T-probing slot) goes to the owner shard of
each query's root bucket on the host and runs there with no collective;
any other batch (or a mesh with more than one data row) takes the psum
path over the same tables.  The mesh is ``[torch.device("cpu")] * 8``,
the reference's 8 virtual CPU devices' counterpart; every output is int
or bool, so the tolerance is exact equality:

- routed and psum-fallback planes equal the reference ShardedEngine's
  (``prepare_partitioned`` on its own mesh) and the port's unsharded
  engine's, and ``_routable`` agrees with the reference's on every slot
  set tried;
- the split tables hold 1/M of their bytes a position, the rest whole;
- ``with_mesh(partitioned=True)`` serves checks, a write through the
  delta prepare (the fold stays armed), lookups on the host walker and
  the serving handle, all against the oracle; an armed
  ``prepare.partition`` fault is retried.
"""

import itertools

import numpy as np
import pytest
import torch

import test_torch_engine as TE
from test_fold_partition import ROUTED_SCHEMA, _routed_world
from test_prepare_parity import NOW, SCHEMA as WC_SCHEMA, _random_world

from gochugaru_tpu.engine.partition import partition_feed as j_feed
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.parallel import ShardedEngine as JSharded, make_mesh as j_make_mesh
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.snapshot import build_snapshot as j_build_snapshot

from gochugaru_tpu_torch import consistency, rel
from gochugaru_tpu_torch.caveats import compile_cel
from gochugaru_tpu_torch.client import new_evaluator, with_engine_config, with_mesh
from gochugaru_tpu_torch.engine import device as pdevice
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.flat import PART_SHARDED_KEYS
from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
from gochugaru_tpu_torch.engine.plan import EngineConfig
from gochugaru_tpu_torch.parallel import ShardedEngine, make_mesh
from gochugaru_tpu_torch.schema import compile_schema, parse_schema
from gochugaru_tpu_torch.store.interner import Interner
from gochugaru_tpu_torch.store.snapshot import build_snapshot
from gochugaru_tpu_torch.utils import faults, metrics, trace
from gochugaru_tpu_torch.utils.context import background

CPU8 = [torch.device("cpu")] * 8
N_REPOS = 200


def _mesh(data, model):
    return make_mesh(data, model, devices=CPU8)


class Routed:
    """The routed world in both packages, prepared partitioned."""

    def __init__(self):
        jrels = _routed_world(n_repos=N_REPOS)
        self.j_cs = j_compile(j_parse(ROUTED_SCHEMA))
        self.p_cs = compile_schema(parse_schema(ROUTED_SCHEMA))
        self.j_snap = j_build_snapshot(1, self.j_cs, JInterner(), jrels,
                                       epoch_us=NOW)
        self.rels = [TE._port_rel(r) for r in jrels]
        self.p_snap = build_snapshot(1, self.p_cs, Interner(), self.rels,
                                     epoch_us=NOW)
        self.cfg = EngineConfig.for_schema(self.p_cs)

    def port(self, shape):
        eng = ShardedEngine(self.p_cs, _mesh(*shape), self.cfg)
        return eng, eng.prepare_snapshot_partitioned(self.p_snap)

    def ref(self, M=4):
        from gochugaru_tpu.engine.partition import snapshot_raw_columns

        eng = JSharded(self.j_cs, j_make_mesh(1, M),
                       JConfig.for_schema(self.j_cs, pallas=False, spmm=False))
        part = j_feed(1, self.j_cs, self.j_snap.interner,
                      snapshot_raw_columns(self.j_snap, copy=True),
                      eng.config, M, contexts=self.j_snap.contexts,
                      epoch_us=NOW, plan=eng.plan, serve="routed")
        return eng, eng.prepare_partitioned(part)

    def batch(self, perms, seed, B=512, res_type="repo", n_res=N_REPOS,
              n_users=200):
        rng = np.random.default_rng(seed)
        itn = self.p_snap.interner
        slot = self.p_cs.slot_of_name
        q_res = np.array([itn.lookup(res_type, f"{res_type[0]}{rng.integers(n_res)}")
                          for _ in range(B)], np.int32)
        q_perm = rng.choice(np.array([slot[p] for p in perms], np.int32), B)
        q_subj = np.array([itn.lookup("user", f"u{rng.integers(n_users)}")
                           for _ in range(B)], np.int32)
        return q_res, q_perm, q_subj


@pytest.fixture(scope="module")
def world():
    return Routed()


def _same(a, b, what):
    for nm, x, y in zip("dpo", a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{what} plane {nm}"


def _routes():
    return metrics.default.snapshot().get("dispatch.route_s.count", 0)


BATCHES = {
    # folded permissions and a bare relation leaf: routable
    "routable": (("read", "admin", "reader"), "repo", N_REPOS, True),
    # a T-probing userset leaf mixed with a folded slot: psum fallback
    "t_slot": (("maintainer", "read"), "repo", N_REPOS, False),
    # the walked intersection: psum fallback
    "walked": (("both",), "audit", 40, False),
}


@pytest.mark.parametrize("kind", list(BATCHES))
def test_planes_match_reference_and_unsharded(world, kind):
    """1 × 4: the routed path (no collective) or the psum fallback, as
    the reference picks; planes equal the reference ShardedEngine's on
    its partitioned snapshot and the port's unsharded engine's."""
    perms, res_type, n_res, routable = BATCHES[kind]
    q = world.batch(perms, seed=len(kind), res_type=res_type, n_res=n_res,
                    n_users=60 if res_type == "audit" else 200)
    je, jd = world.ref()
    ref = je.check_columns(jd, *q, now_us=NOW)
    eng, ds = world.port((1, 4))
    assert ds.flat_meta.part_serve and pdevice._meta_from(jd.flat_meta) == ds.flat_meta
    slots = sorted({int(s) for s in q[1]})
    assert eng._routable(ds.flat_meta, slots) == je._routable(jd.flat_meta, slots) == routable
    r0 = _routes()
    K.reset_launches()
    got = eng.check_columns(ds, *q, now_us=NOW)
    assert not any(K.LAUNCHES.values())
    assert (_routes() - r0 == 1) == routable
    assert (eng.last_collectives["calls"] == 0) == routable
    _same(got, ref, f"{kind} vs reference")
    single = DeviceEngine(world.p_cs, world.cfg, device="cpu")
    _same(got, single.check_columns(single.prepare(world.p_snap), *q, now_us=NOW),
          f"{kind} vs unsharded")
    if kind != "walked":  # an intersection of two random users is rare
        assert 0 < int(got[0].sum()) < q[0].shape[0]


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (1, 8)])
def test_other_shapes_match_unsharded(world, shape):
    """Two data rows never route (the psum path over the part-serve
    tables); one row routes at M = 2 and 8.  A mixed batch over every
    slot of the schema runs in slot chunks past ``flat_max_slots``."""
    eng, ds = world.port(shape)
    single = DeviceEngine(world.p_cs, world.cfg, device="cpu")
    sd = single.prepare(world.p_snap)
    for perms in (("read", "admin", "reader"), ("maintainer", "read", "org")):
        q = world.batch(perms, seed=shape[1])
        r0 = _routes()
        _same(eng.check_columns(ds, *q, now_us=NOW),
              single.check_columns(sd, *q, now_us=NOW), f"{shape} {perms}")
        assert (_routes() > r0) == (shape[0] == 1 and perms[0] == "read")
    chunked = ShardedEngine(world.p_cs, _mesh(*shape),
                            EngineConfig.for_schema(world.p_cs, flat_max_slots=1))
    cds = chunked.prepare_snapshot_partitioned(world.p_snap)
    q = world.batch(("read", "admin", "reader"), seed=9)
    _same(chunked.check_columns(cds, *q, now_us=NOW),
          single.check_columns(sd, *q, now_us=NOW), f"{shape} chunked")


def test_routable_agrees_with_reference(world):
    """``_routable`` on every slot set of one and two slots of the
    routed world, and on a wildcard world (never routable)."""
    je, jd = world.ref()
    eng, ds = world.port((1, 4))
    slots = sorted(world.p_cs.slot_of_name.values())
    tried = 0
    for n in (1, 2):
        for ss in itertools.combinations(slots, n):
            assert eng._routable(ds.flat_meta, list(ss)) == je._routable(
                jd.flat_meta, list(ss)), ss
            tried += 1
    assert tried > 20
    w = TE.World(WC_SCHEMA, rels=_random_world(5, 1_500))
    pe = ShardedEngine(w.p_cs, _mesh(1, 4), EngineConfig.for_schema(w.p_cs))
    pd = pe.prepare_snapshot_partitioned(w.p_snap)
    assert pd.flat_meta.has_wc_edges
    assert not any(pe._routable(pd.flat_meta, [s])
                   for s in w.p_cs.slot_of_name.values())


def test_per_position_bytes(world):
    """The split tables hold 1/M of their bytes at each position (each
    its own block), every other table is whole at every position, and
    ``usx`` is whole."""
    eng, ds = world.port((1, 4))
    split = 0
    for k, v in ds.arrays.items():
        if k in PART_SHARDED_KEYS:
            assert v.sharded, k
            for j in range(4):
                assert v.at(0, j).nbytes * 4 == v.nbytes, k
            split += 1
        else:
            assert not v.sharded, k
            for j in range(4):
                assert v.at(0, j).nbytes == v.nbytes, k
    assert split == 6
    assert not ds.arrays["usx"].sharded
    assert ds.prepare_split["build_s"] > 0 and ds.prepare_split["place_s"] > 0


def _write_world(c, ctx):
    """The routed schema's client world: org o0's repos (admin u0),
    caveated readers, an intersection."""
    c.write_schema(ctx, ROUTED_SCHEMA)
    txn = rel.Txn()
    for r in range(48):
        txn.touch(rel.must_from_triple(f"repo:r{r}", "org", "org:o0"))
        txn.touch(rel.Relationship(
            resource_type="repo", resource_id=f"r{r}",
            resource_relation="reader", subject_type="user",
            subject_id=f"u{r % 30}", caveat_name="on_tuesday",
            caveat_context={"day": "tuesday" if r % 3 else "monday"}))
    txn.touch(rel.must_from_triple("org:o0", "admin", "user:u0"))
    txn.touch(rel.must_from_triple("org:o0", "member", "team:t1#member"))
    txn.touch(rel.must_from_triple("team:t1", "member", "user:u40"))
    txn.touch(rel.must_from_triple("repo:r1", "maintainer", "user:u5"))
    for a in range(8):
        txn.touch(rel.must_from_triple(f"audit:a{a}", "auditor", f"user:u{a}"))
        txn.touch(rel.must_from_triple(f"audit:a{a}", "owner", f"user:u{a % 4}"))
    return c.write(ctx, txn)


def _oracle(snap):
    programs = {n: compile_cel(n, c.params, c.expression)
                for n, c in snap.compiled.schema.caveats.items()}
    return SnapshotOracle(snap, programs, now_us=None)


def _oracle_rows(snap, rels):
    o = _oracle(snap)
    return [o.check(r.resource_type, r.resource_id, r.resource_relation,
                    r.subject_type, r.subject_id, r.subject_relation) == T
            for r in rels]


def _rels(rng, n):
    out = []
    for _ in range(n):
        if rng.random() < 0.2:
            out.append(rel.must_from_triple(
                f"audit:a{rng.integers(8)}", "both", f"user:u{rng.integers(8)}"))
        else:
            out.append(rel.must_from_triple(
                f"repo:r{rng.integers(48)}",
                str(rng.choice(["read", "admin", "reader"])),
                f"user:u{rng.integers(45)}"))
    return out


def test_partitioned_client_checks_write_and_fold(world):
    """``with_mesh(partitioned=True)``: checks agree with the oracle and
    route; a leaf write takes the delta prepare, the fold stays armed
    (no sticky downgrade), the next folded batch still routes, and its
    planes equal a full partitioned prepare of the tip."""
    c = new_evaluator(with_mesh(_mesh(1, 4), partitioned=True),
                      with_engine_config(EngineConfig()))
    ctx = background()
    rev1 = _write_world(c, ctx)
    rng = np.random.default_rng(4)
    rels = _rels(rng, 200)
    r0 = _routes()
    got = c.check(ctx, consistency.at_least(rev1), *rels)
    ds1 = c._dsnap_cache[max(c._dsnap_cache)]
    assert got == _oracle_rows(ds1.source_snapshot, rels)
    assert ds1.flat_meta.part_serve and ds1.flat_meta.fold_pairs
    assert ds1.fold_state is not None
    assert _routes() == r0  # the intersection made the batch unroutable
    folded = [r for r in rels if r.resource_type == "repo"]
    assert c.check(ctx, consistency.at_least(rev1), *folded) == _oracle_rows(
        ds1.source_snapshot, folded)
    assert _routes() > r0
    assert metrics.default.gauge("partition.owned_rows") > 0

    txn = rel.Txn()
    txn.touch(rel.must_from_triple("repo:r0", "maintainer", "user:u7"))
    rev2 = c.write(ctx, txn)
    r0 = _routes()
    after = c.check(ctx, consistency.at_least(rev2),
                    rel.must_from_triple("repo:r0", "read", "user:u7"),
                    rel.must_from_triple("repo:r1", "read", "user:u7"),
                    rel.must_from_triple("repo:r1", "read", "user:u0"))
    assert after == [True, False, True]
    ds2 = c._dsnap_cache[max(c._dsnap_cache)]
    assert ds2.flat_meta.delta is not None and not ds2.flat_meta.delta.pf_off
    assert ds2.fold_state is not None and ds2.flat_meta.part_serve
    for k, v in ds1.arrays.items():
        if v.sharded:
            assert ds2.arrays[k] is v, k
    ek = c._engine
    tip = ds2.source_snapshot
    full = ek.prepare_snapshot_partitioned(tip)
    q = (np.array([tip.interner.lookup("repo", f"r{i % 48}") for i in range(64)], np.int32),
         np.full(64, world.p_cs.slot_of_name["read"], np.int32),
         np.array([tip.interner.lookup("user", f"u{i % 45}") for i in range(64)], np.int32))
    _same(ek.check_columns(ds2, *q), ek.check_columns(full, *q), "delta vs full")
    assert _routes() > r0


def test_partitioned_client_lookups_serving_and_trace(world):
    """Lookups on a feed-partitioned snapshot run on the host walker
    (the feed declines the reverse index) and agree with the oracle; the
    serving handle's formed batches take the routed throughput path; the
    request trace carries the route event on the sharded.dispatch
    span."""
    c = new_evaluator(with_mesh(_mesh(1, 4), partitioned=True),
                      with_engine_config(EngineConfig()))
    ctx = background()
    rev = _write_world(c, ctx)
    cs = consistency.at_least(rev)
    c.check(ctx, cs, rel.must_from_triple("repo:r0", "read", "user:u0"))
    ds = c._dsnap_cache[max(c._dsnap_cache)]
    snap = ds.source_snapshot
    o = _oracle(snap)
    w0 = metrics.default.counter("lookups.walker")
    got = sorted(c.lookup_resources(ctx, cs, "repo#read", "user:u40"))
    want = sorted(f"r{r}" for r in range(48)
                  if o.check("repo", f"r{r}", "read", "user", "u40", "") == T)
    assert got == want and len(got) == 48
    subs = c.lookup_subjects(ctx, cs, "repo:r3", "read", "user")
    assert sorted(subs) == sorted(
        u for u in {f"u{i}" for i in range(45)}
        if o.check("repo", "r3", "read", "user", u, "") == T)
    assert metrics.default.counter("lookups.walker") > w0

    rng = np.random.default_rng(6)
    rels = [r for r in _rels(rng, 400) if r.resource_type == "repo"][:256]
    r0 = _routes()
    with c.with_serving() as h:
        served = h.check(ctx, *rels)
    assert served == _oracle_rows(snap, rels)
    assert _routes() > r0

    tr = trace.configure(sample_rate=1.0, slow_threshold_s=None, capacity=16)
    try:
        c.check(ctx, cs, *[rel.must_from_triple(f"repo:r{r}", "read", "user:u0")
                           for r in range(32)])
        traces = [t for t in tr.traces() if t["name"] == "check"]
    finally:
        trace.disable()
    routes = [e for t in traces for sp in t["spans"]
              if sp["name"] == "sharded.dispatch"
              for e in sp.get("events", ()) if e["name"] == "route"]
    assert routes and len(routes[0]["shard_batches"]) == 4
    assert sum(routes[0]["shard_batches"]) == 32
    assert routes[0]["exchange_bytes"] > 0


def test_partition_fault_is_retried():
    """An armed ``prepare.partition`` fault (the feed's site) is retried
    inside the client's envelope: the check answers, the fault fired."""
    c = new_evaluator(with_mesh(_mesh(1, 2), partitioned=True),
                      with_engine_config(EngineConfig()))
    ctx = background()
    rev = _write_world(c, ctx)
    before = metrics.default.counter("faults.injected.prepare.partition")
    with faults.armed("prepare.partition", times=1) as spec:
        got = c.check(ctx, consistency.at_least(rev),
                      rel.must_from_triple("repo:r2", "read", "user:u0"),
                      rel.must_from_triple("repo:r2", "admin", "user:u9"))
    assert got == [True, False]
    assert spec.fired == 1
    assert metrics.default.counter("faults.injected.prepare.partition") == before + 1


def test_with_mesh_partitioned_option():
    """``with_mesh(partitioned=True)`` no longer raises; the option rides
    the client as ``_mesh_partitioned`` (and is off without a mesh)."""
    c = new_evaluator(with_mesh(_mesh(1, 2), partitioned=True))
    assert c._mesh_partitioned
    assert not new_evaluator(with_mesh(_mesh(1, 2)))._mesh_partitioned
    assert not new_evaluator(device="cpu")._mesh_partitioned
