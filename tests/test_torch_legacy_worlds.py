"""The port's legacy two-phase check program against the reference's,
on its edge worlds: caps below a world's depth and fanout (the overflow
plane), a batch past ``flat_max_slots`` spilling from a flat engine, a
graph whose keys do not pack, a batch past the slots on a
delta-prepared snapshot, the chunked program, and the closure hop's
padding fault.  The worlds and helpers are tests/test_torch_legacy.py's;
its primitives and randomised ``use_flat=False`` worlds stay there, so
the two files run on two workers.  All outputs are bool: the tolerance
is exact equality.
"""

import random

import numpy as np
import pytest

from gochugaru_tpu import rel as jrel
from gochugaru_tpu.engine.lookup import (
    lookup_resources_device as j_lookup_resources_device,
    lookup_subjects_device as j_lookup_subjects_device,
)
from gochugaru_tpu.engine.oracle import SnapshotOracle as JSnapshotOracle, T
from gochugaru_tpu.store.delta import apply_delta as j_apply

from gochugaru_tpu_torch.engine import flat as pflat
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.lookup import (
    lookup_resources_device as p_lookup_resources_device,
    lookup_subjects_device as p_lookup_subjects_device,
)
from gochugaru_tpu_torch.engine.oracle import SnapshotOracle as PSnapshotOracle
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.delta import apply_delta as p_apply
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot as p_build
from gochugaru_tpu_torch.utils import metrics

from test_flat_engine import FEATURES, NOW, build_feature_world, make_checks
from test_torch_legacy import (
    World, _all_name_checks, _definite_rows_agree, _port_rel, _same,
)


def _deep_world():
    """Nested groups eight deep and a folder chain ten deep, readers
    through both."""
    rels = [jrel.must_from_triple("group:g0", "member", f"user:u{i}")
            for i in range(6)]
    for g in range(1, 9):
        rels.append(jrel.must_from_tuple(f"group:g{g}#member",
                                         f"group:g{g - 1}#member"))
    for f in range(1, 10):
        rels.append(jrel.must_from_triple(f"folder:f{f}", "parent",
                                          f"folder:f{f - 1}"))
    rels.append(jrel.must_from_tuple("folder:f0#owner", "group:g8#member"))
    for d in range(4):
        rels.append(jrel.must_from_triple(f"doc:d{d}", "folder", f"folder:f{3 * d}"))
        rels.append(jrel.must_from_tuple(f"doc:d{d}#reader", f"group:g{2 * d}#member"))
        rels.append(jrel.must_from_triple(f"doc:d{d}", "reader", f"user:u{d}"))
    checks = [jrel.must_from_triple(f"doc:d{d}", p, f"user:u{u}")
              for d in range(4) for p in ("read", "reader") for u in (0, 3, 7)]
    checks += [jrel.must_from_triple(f"folder:f{f}", "view", "user:u1")
               for f in range(10)]
    return rels, checks


@pytest.mark.parametrize("caps", [
    pytest.param(dict(closure_size=4, seed_cap=2, prop_cap=2, closure_hops=3),
                 id="closure"),
    pytest.param(dict(subgraph_nodes=3, arrow_fanout=2, us_leaf_cap=2),
                 id="subgraph"),
])
def test_overflow_worlds_match_reference(caps):
    """Caps below the world's depth and fanout: the overflow plane must
    flag the same rows as the reference's."""
    rels, checks = _deep_world()
    w = World(rels, checks, use_flat=False, **caps)
    ref = w.ref_planes()
    assert ref[2].any() and not ref[2].all()
    _same(ref, w.port_planes(), "own tables")
    _same(ref, w.port_on_reference_tables(), "reference tables")
    _definite_rows_agree(w, ref)


def test_slot_spill_matches_reference():
    """``flat_max_slots=4`` on a flat engine: a batch over FEATURES' ten
    names spills to the legacy program on both sides; a batch of four
    names stays flat."""
    rng = random.Random(7)
    rels = build_feature_world(rng, n_users=10, n_groups=5, n_folders=6, n_docs=10)
    checks = _all_name_checks(rng, 10, 5, 6, 10)
    w = World(rels, checks, flat_max_slots=4, flat_recursion=3, flat_max_width=32)
    assert w.jd.flat_meta is not None and w.pd.flat_meta is not None
    before = metrics.default.counter("checks.legacy")
    ref = w.ref_planes()
    _same(ref, w.port_planes(), "spill")
    assert metrics.default.counter("checks.legacy") == before + 1
    _definite_rows_agree(w, ref)
    # a legacy-only engine gives the same planes
    w2 = World(rels, checks, use_flat=False)
    _same(ref, w2.port_planes(), "use_flat=False")
    narrow = [c for c in checks if c.resource_relation in ("read", "reader", "view")]
    pn = w.pe.check_batch(w.pd, [_port_rel(c) for c in narrow], now_us=NOW)
    assert metrics.default.counter("checks.legacy") == before + 2
    _definite_rows_agree(w, pn, checks=narrow)


def test_unpackable_graph_serves_legacy_and_walker(monkeypatch):
    """A graph whose keys do not pack (the port's ``flat._node_radix``
    returns None) keeps ``flat_meta=None``: checks run on the legacy
    program and equal the reference's legacy planes; lookups take the
    host walker and answer as the reference does."""
    monkeypatch.setattr(pflat, "_node_radix", lambda snap, maps: None)
    rng = random.Random(5)
    rels = build_feature_world(rng, n_users=10, n_groups=5, n_folders=6, n_docs=10)
    checks = _all_name_checks(rng, 10, 5, 6, 10)
    w = World(rels, checks, use_flat=False)
    pe = PEngine(w.p_cs, PConfig.for_schema(w.p_cs), device="cpu")
    assert pe.config.use_flat
    pd = pe.prepare(w.p_snap)
    assert pd.flat_meta is None and pd.host_arrays is None
    ref = w.ref_planes()
    _same(ref, [np.asarray(x) for x in pe.check_batch(
        pd, [_port_rel(c) for c in checks], now_us=NOW)], "unpackable")
    j_or = lambda: JSnapshotOracle(w.j_snap, {}, now_us=NOW)  # noqa: E731
    p_or = lambda: PSnapshotOracle(w.p_snap, {}, now_us=NOW)  # noqa: E731
    walker = metrics.default.counter("lookups.walker")
    for u in ("u0", "u3", "u7"):
        assert p_lookup_resources_device(
            pe, pd, "doc", "read", "user", u, now_us=NOW, oracle_factory=p_or,
        ) == j_lookup_resources_device(
            w.je, w.jd, "doc", "read", "user", u, now_us=NOW, oracle_factory=j_or)
    for d in ("d0", "d4"):
        assert p_lookup_subjects_device(
            pe, pd, "doc", d, "read", "user", now_us=NOW, oracle_factory=p_or,
        ) == j_lookup_subjects_device(
            w.je, w.jd, "doc", d, "read", "user", now_us=NOW, oracle_factory=j_or)
    assert metrics.default.counter("lookups.walker") >= walker + 5


def test_delta_snapshot_batch_past_slots_reads_the_tip():
    """A write, then a batch past ``flat_max_slots`` on the
    delta-prepared snapshot.  The port builds that snapshot's legacy
    columns from its own (tip) snapshot, so its planes equal a full
    prepare's of the same revision, the reference's full prepare's, and
    the oracle's.

    The reference does not: its delta prepare carries ``host_arrays``
    from the base revision, and its legacy fallback reads them.  On this
    world (seed 4) its delta snapshot still grants ``doc:d1#reader@
    user:u7``, ``doc:d2#reader@user:u4`` and ``doc:d2#reader@user:u1``
    (deleted at revision 2) and denies ``doc:d2#reader@user:u5`` and
    ``doc:d1#banned@user:u2`` (added at revision 2); its full prepare of
    revision 2 answers all five as the oracle does."""
    rng = random.Random(4)
    rels = build_feature_world(rng, n_users=8, n_groups=4, n_folders=5, n_docs=8)
    readers = [r for r in rels if r.resource_relation == "reader"
               and r.subject_type == "user" and r.subject_id != "*"
               and not r.caveat_name and r.expiration is None]
    dels = readers[:3]
    adds = [jrel.must_from_triple("doc:d1", "banned", "user:u2"),
            jrel.must_from_triple("doc:d2", "reader", "user:u5")]
    checks = []
    for r in dels + adds:
        for name in ("read", "reader", "banned", "audit"):
            checks.append(jrel.must_from_triple(
                f"{r.resource_type}:{r.resource_id}", name, f"user:{r.subject_id}"))
    checks += _all_name_checks(rng, 8, 4, 5, 8, n=20)
    w = World(rels, checks)
    j_snap2 = j_apply(w.j_snap, 2, adds, dels, interner=w.j_int)
    p_snap2 = p_apply(w.p_snap, 2, [_port_rel(a) for a in adds],
                      [_port_rel(d) for d in dels], interner=w.p_int)
    pd2 = w.pe.prepare(p_snap2, prev=w.pd)
    assert pd2.delta_acc is not None and pd2.flat_meta.delta is not None
    before = metrics.default.counter("checks.legacy")
    got = w.port_planes(pd2)
    assert metrics.default.counter("checks.legacy") == before + 1
    full = w.port_planes(w.pe.prepare(p_snap2))
    ref_full = w.ref_planes(w.je.prepare(j_snap2))
    _same(full, got, "delta vs full prepare")
    _same(ref_full, got, "delta vs the reference's full prepare")
    oracle = w.oracle(j_snap2)
    d, p, ovf = got
    for i, c in enumerate(checks):
        want = oracle.check_relationship(c) == T
        assert (bool(d[i]) if not (ovf[i] or (p[i] and not d[i])) else want) == want, c
    assert pd2.legacy_cache is not None and pd2.arrays.get("e_rel") is None


def test_chunked_program_equals_one_chunk():
    """The byte budget only splits the batch: a budget of one row per
    chunk gives the planes of one chunk."""
    rng = random.Random(9)
    rels = build_feature_world(rng, n_users=10, n_groups=5, n_folders=6, n_docs=10)
    checks = [_port_rel(c) for c in make_checks(rng, 10, 10, n=40)]
    cs = p_compile(p_parse(FEATURES))
    snap = p_build(1, cs, PInterner(), [_port_rel(r) for r in rels], epoch_us=NOW)
    pe = PEngine(cs, PConfig.for_schema(cs, use_flat=False), device="cpu")
    pd = pe.prepare(snap)
    whole = pe.check_batch(pd, checks, now_us=NOW)
    pe.legacy.chunk_bytes = 1
    _same(whole, pe.check_batch(pd, checks, now_us=NOW), "chunked")


@pytest.mark.parametrize("n_nested", [17, 18])
def test_closure_hop_counts_padding_rows_as_parents(n_nested):
    """A fault of the reference that the port mirrors bit for bit: the
    closure hop's fanout test ``(hi - lo) > prop_cap`` also runs for the
    closure's sentinel slots, whose search range is the membership
    columns' sentinel padding.  With 17 nested-group rows the columns pad
    to 32, 15 padding rows > prop_cap 8, and every row of the batch
    overflows — even a subject with no membership at all; with 16 rows
    (no padding) none does."""
    rels = [jrel.must_from_triple("group:g0", "member", "user:u0")]
    for g in range(1, n_nested + 1):
        rels.append(jrel.must_from_tuple(f"group:g{g}#member",
                                         f"group:g{g - 1}#member"))
    rels.append(jrel.must_from_triple("doc:d0", "reader", "user:u1"))
    checks = [jrel.must_from_triple("doc:d0", "read", "user:u1"),
              jrel.must_from_triple("doc:d0", "read", "user:u2"),
              jrel.must_from_triple("group:g1", "member", "user:u0")]
    w = World(rels, checks, use_flat=False)
    assert w.j_snap.mp_subj.shape[0] == n_nested - 1
    ref = w.ref_planes()
    assert ref[2].all() == (n_nested == 18) and ref[0].tolist() == [True, False, True]
    _same(ref, w.port_planes(), "padding")
