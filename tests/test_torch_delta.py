"""The port's Watch-driven delta chain against the reference's.

Each chain runs twice from the same relationships and the same writes:
through the reference (``DeviceEngine(pallas=False)``, ``prepare(snap,
prev=...)``, ``flat_fn_and_args``) and through the port (``device="cpu"``,
its plain probe path).  At every revision the port must:

- take the incremental path exactly where the reference does, and bail
  to a full prepare exactly where the reference's ``_prepare_delta``
  returns None;
- build the reference's ``dl_*`` overlays, reshipped tables and FlatMeta
  (its DeltaMeta included), key for key and bit for bit;
- keep every base tensor of ``prev`` (same storage) except the keys the
  reference replaces;
- return the reference program's (definite, possible, overflow) planes
  bit for bit, over its own tables and over the reference's;
- agree with the host oracle on the definite rows.

All outputs are int or bool, so the tolerance is exact equality.  The
worlds are ``tests/test_delta_level.py``'s (its sharded ones left out)
and two of ``tests/test_fold_delta.py``'s, plus chains that despec a
packed table and append stored caveat contexts; the chain that serves
lookups is tests/test_torch_delta_lookups.py's.
"""

import dataclasses
import datetime as dt
import random

import numpy as np
import pytest

import jax.numpy as jnp

from gochugaru_tpu import rel as jrel
from gochugaru_tpu.engine.device import DeviceEngine as JEngine
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.delta import apply_delta as j_apply
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.snapshot import build_snapshot as j_build

from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.caveats import compile_cel
from gochugaru_tpu_torch.engine import device as pdevice
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.delta import apply_delta as p_apply
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot as p_build

from test_flat_engine import FEATURES, NOW, build_feature_world, make_checks

LAYOUTS = {"off_interleave": {}, "aligned": {"flat_aligned": True}}


def _port_rel(r):
    return prel.Relationship(
        **{f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    )


def _host(t, like_dtype=None):
    """A port tensor as the reference's host array (uint16 lanes are
    stored as int16 on the device)."""
    a = t.cpu().numpy()
    if like_dtype is not None and like_dtype == np.uint16:
        a = a.view(np.uint16)
    return a


class Chain:
    """One world in both packages, advanced revision by revision through
    both engines' ``prepare(snap, prev=...)``."""

    def __init__(self, schema, rels, **cfg):
        self.j_cs = j_compile(j_parse(schema))
        self.p_cs = p_compile(p_parse(schema))
        self.j_int, self.p_int = JInterner(), PInterner()
        self.j_snap = j_build(1, self.j_cs, self.j_int, rels, epoch_us=NOW)
        self.p_snap = p_build(1, self.p_cs, self.p_int,
                              [_port_rel(r) for r in rels], epoch_us=NOW)
        self.je = JEngine(self.j_cs, JConfig(pallas=False, spmm=False, **cfg))
        self.pe = PEngine(self.p_cs, PConfig(**cfg), device="cpu")
        self.jd = self.je.prepare(self.j_snap)
        self.pd = self.pe.prepare(self.p_snap)
        assert self.jd.flat_meta is not None and self.jd.flat_meta.blockslice
        self.compare_tables(None, None)
        self.revision = 1

    # -- one revision ----------------------------------------------------
    def step(self, adds, deletes=()):
        """Apply one write to both chains; returns True when the
        revision took the incremental path (on both)."""
        self.revision += 1
        rev = self.revision
        j_prev, p_prev = self.jd, self.pd
        self.j_snap = j_apply(self.j_snap, rev, list(adds), list(deletes),
                              interner=self.j_int)
        self.p_snap = p_apply(self.p_snap, rev, [_port_rel(a) for a in adds],
                              [_port_rel(d) for d in deletes],
                              interner=self.p_int)
        self.jd = self.je.prepare(self.j_snap, prev=j_prev)
        self.pd = self.pe.prepare(self.p_snap, prev=p_prev)
        inc = self.jd.delta_acc is not None
        assert (self.pd.delta_acc is not None) == inc, (
            f"rev {rev}: reference incremental={inc}, port differs")
        self.compare_tables(j_prev, p_prev)
        return inc

    def compare_tables(self, j_prev, p_prev):
        """FlatMeta (DeltaMeta included) and every table key for key; on
        an incremental revision also the storage the port shares with
        ``p_prev``."""
        jd, pd = self.jd, self.pd
        assert pdevice._meta_from(jd.flat_meta) == pd.flat_meta
        assert set(pd.arrays) == set(jd.arrays)
        for k, v in jd.arrays.items():
            want = np.asarray(v)
            got = _host(pd.arrays[k], want.dtype)
            assert got.dtype == want.dtype, k
            assert np.array_equal(got, want), k
        assert set(pd.specs) == {k for k, _ in pd.flat_meta.packed}
        if j_prev is None or jd.delta_acc is None:
            return
        for c in ("a_key", "g_key"):
            assert np.array_equal(pd.delta_acc[c], jd.delta_acc[c]), c
        for k, v in pd.arrays.items():
            kept = k in j_prev.arrays and jd.arrays[k] is j_prev.arrays[k]
            shared = (k in p_prev.arrays
                      and v.data_ptr() == p_prev.arrays[k].data_ptr())
            assert kept == shared, (
                f"{k}: the reference {'kept' if kept else 'replaced'} it")

    # -- answers ---------------------------------------------------------
    def planes(self, checks, sample=None):
        """The three planes, reference vs port (over the port's own
        tables and over the reference's), then sampled definite rows vs
        the host oracle."""
        je, jd, pe, pd = self.je, self.jd, self.pe, self.pd
        q, _u, qctx = je._lower_queries(self.j_snap, checks, jd.strings)
        fn, args = je.flat_fn_and_args(
            jd, q, qctx, jnp.int32(self.j_snap.now_rel32(NOW)), len(checks))
        ref = [np.asarray(x)[: len(checks)] for x in fn(*args)]
        p_checks = [_port_rel(c) for c in checks]
        got = pe.check_batch(pd, p_checks, now_us=NOW)
        np_arrays = {k: np.asarray(v) for k, v in jd.arrays.items()}
        on_ref = pe.check_batch(
            pe.snapshot_from_reference(self.p_snap, np_arrays, jd.flat_meta,
                                       jd.strings),
            p_checks, now_us=NOW)
        for name, r, a, b in zip("dpo", ref, got, on_ref):
            assert np.array_equal(r, a), f"plane {name}: port != reference"
            assert np.array_equal(r, b), f"plane {name} on reference tables"
        d, p, ovf = got
        programs = {n: compile_cel(n, c.params, c.expression)
                    for n, c in self.p_cs.schema.caveats.items()}
        oracle = SnapshotOracle(self.p_snap, programs, now_us=NOW)
        rows = range(len(checks)) if sample is None else sample
        for i in rows:
            c = p_checks[i]
            if not d[i] or ovf[i]:
                continue
            want = oracle.check(
                c.resource_type, c.resource_id, c.resource_relation,
                c.subject_type, c.subject_id, c.subject_relation,
                context=c.caveat_context or None, now_us=NOW) == T
            assert want, f"definite row {c} is not granted by the oracle"
        return got


def _feature_chain(seed=3, **cfg):
    rng = random.Random(seed)
    rels = build_feature_world(rng)
    cfg.setdefault("flat_recursion", 3)
    cfg.setdefault("flat_max_width", 32)
    return rng, rels, Chain(FEATURES, rels, **cfg)


def _used_groups(rels):
    return sorted({
        r.subject_id for r in rels
        if r.subject_type == "group" and r.subject_relation == "member"
    })


# ---------------------------------------------------------------------------
# tests/test_delta_level.py's worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_random_stream_matches_reference(layout):
    """Direct, userset, arrow, caveated and fresh-node adds and deletes
    of base and delta rows, chained over five revisions."""
    rng, rels, ch = _feature_chain(seed=3, **LAYOUTS[layout])
    py = random.Random(99)
    live = [r for r in rels if r.resource_type == "doc"
            and r.resource_relation in ("reader", "banned")]
    used = _used_groups(rels)
    for revision in range(2, 7):
        adds = []
        for i in range(6):
            kind = py.randrange(5)
            if kind == 0:
                r = jrel.must_from_triple(
                    f"doc:d{py.randrange(12)}", "reader", f"user:new{revision}_{i}")
            elif kind == 1:
                r = jrel.must_from_tuple(f"doc:d{py.randrange(10)}#reader",
                                         f"group:{py.choice(used)}#member")
            elif kind == 2:
                r = jrel.must_from_tuple(f"doc:fresh{revision}_{i}#folder",
                                         f"folder:f{py.randrange(6)}")
            elif kind == 3:
                r = jrel.must_from_triple(
                    f"doc:d{py.randrange(10)}", "reader", f"user:u{py.randrange(10)}"
                ).with_caveat("tier", {"min": py.randint(1, 9)})
            else:
                r = jrel.must_from_triple(
                    f"doc:d{py.randrange(10)}", "banned", f"user:u{py.randrange(10)}")
            adds.append(r)
        deletes = []
        if live and py.random() < 0.8:
            deletes.append(live.pop(py.randrange(len(live))))
        if revision > 3:
            deletes.append(jrel.must_from_triple(
                f"doc:d{py.randrange(12)}", "reader", f"user:new{revision-1}_0"))
        assert ch.step(adds, deletes), f"rev {revision} fell back"
        assert ch.pd.flat_meta.delta is not None
        ch.planes(make_checks(rng, 10, 12, n=40) + [
            jrel.must_from_triple(f"doc:d{py.randrange(12)}", "read",
                                  f"user:new{revision}_{i}")
            for i in range(3)
        ] + [
            jrel.must_from_triple(f"doc:{d.resource_id}", "read",
                                  f"user:{d.subject_id}")
            for d in deletes if d.subject_type == "user"
        ])


@pytest.mark.parametrize("fold", [True, False])
def test_arrow_retargets_and_adds(fold):
    """Arrow rows along a chain: base doc -> folder arrows deleted and
    re-pointed (dl_atb masks the base children) and fresh arrows added
    (dl_arr/dl_arx extend the children axis), checked on exactly those
    docs; with the fold off the walked arrow programs read them."""
    rng, rels, ch = _feature_chain(seed=6, flat_fold=fold)
    py = random.Random(12)
    arrows = [r for r in rels if r.resource_relation == "folder"]
    for revision in range(2, 6):
        adds, deletes, docs = [], [], set()
        for _ in range(2):
            old = arrows.pop(py.randrange(len(arrows)))
            deletes.append(old)
            adds.append(jrel.must_from_tuple(f"doc:{old.resource_id}#folder",
                                             f"folder:f{py.randrange(6)}"))
            docs.add(old.resource_id)
        adds.append(jrel.must_from_tuple(f"doc:d{py.randrange(10)}#folder",
                                         f"folder:f{py.randrange(6)}"))
        docs.add(adds[-1].resource_id)
        assert ch.step(adds, deletes), f"rev {revision} fell back"
        dm = ch.pd.flat_meta.delta
        assert dm.has_ar and dm.has_artomb
        ch.planes([
            jrel.must_from_triple(f"doc:{d}", "read", f"user:u{u}")
            for d in sorted(docs) for u in range(10)
        ] + make_checks(rng, 10, 10, n=20))


def test_base_userset_tombstone_voids_tindex():
    """Deleting a base userset grant under a T-covered slot: the dirty
    void (dl_td) and the forced KU pass with userset tombstones."""
    rng, rels, ch = _feature_chain(seed=11)
    meta = ch.pd.flat_meta
    names = {v: k for k, v in ch.p_cs.slot_of_name.items()}
    t_named = {names[s] for s in meta.t_slots} if meta.has_tindex else set()
    target = next(r for r in rels if r.subject_relation == "member"
                  and r.resource_type in ("doc", "folder")
                  and r.resource_relation in t_named)
    assert ch.step([], [target])
    dm = ch.pd.flat_meta.delta
    assert dm.has_ustomb and dm.t_dirty
    ch.planes(make_checks(rng, 10, 10, n=40) + [jrel.must_from_tuple(
        f"{target.resource_type}:{target.resource_id}#{target.resource_relation}",
        f"{target.subject_type}:{target.subject_id}#{target.subject_relation}",
    )])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_membership_add_advances_closure(layout):
    """A member edge into a used group advances the flattened closure in
    place and reships the closure tables (clx, ovfx) in the base layout."""
    rng, rels, ch = _feature_chain(seed=3, **LAYOUTS[layout])
    grant = jrel.must_from_tuple(f"group:{_used_groups(rels)[0]}#member",
                                 "user:u9")
    assert ch.step([grant])
    d, _p, _o = ch.planes([grant] + make_checks(rng, 10, 10, n=40))
    assert bool(d[0])


def test_membership_with_closure_delta_off_bails():
    """closure_delta=False: membership rows force a full prepare, on
    both sides."""
    rng, rels, ch = _feature_chain(seed=3, closure_delta=False)
    grant = jrel.must_from_tuple(f"group:{_used_groups(rels)[0]}#member",
                                 "user:u9")
    assert not ch.step([grant])
    assert ch.pd.flat_meta.delta is None
    assert bool(ch.planes([grant])[0][0])


def test_compaction_threshold_bails():
    """Accumulated rows beyond max(flat_delta_min_compact, E/8) fold into
    a fresh base on both sides."""
    rng, rels, ch = _feature_chain(seed=3, flat_delta_min_compact=4)
    adds = [jrel.must_from_triple(f"doc:d{i % 10}", "reader", f"user:bulk{i}")
            for i in range(64)]
    assert not ch.step(adds)
    assert bool(ch.planes([jrel.must_from_triple(
        "doc:d1", "read", "user:bulk1")])[0][0])


def test_empty_delta_stays_incremental():
    """An empty collapsed delta advances the revision incrementally with
    no delta level."""
    rng, rels, ch = _feature_chain(seed=3)
    assert ch.step([])
    assert ch.pd.revision == 2 and ch.pd.flat_meta.delta is None
    ch.planes(make_checks(rng, 10, 10, n=30))


_MINI = """
caveat tier(t int, min int) { t >= min }
definition user {}
definition group { relation member: user }
definition doc {
    relation reader: user | user:* | group#member | user with tier
    permission read = reader
}
"""


def test_touch_replaces_base_payload():
    """Re-touching a base row with a caveat tombstones the base copy: the
    definite grant turns conditional."""
    base = [
        jrel.must_from_triple("doc:d0", "reader", "user:u0"),
        jrel.must_from_triple("doc:d0", "reader", "user:u1").with_caveat(
            "tier", {"min": 3}),
    ]
    ch = Chain(_MINI, base)
    touched = jrel.must_from_triple("doc:d0", "reader", "user:u0").with_caveat(
        "tier", {"min": 5})
    assert ch.step([touched])
    assert ch.pd.flat_meta.delta.has_tombs
    d, p, _ = ch.planes([jrel.must_from_triple("doc:d0", "read", "user:u0")])
    assert not d[0] and p[0]


def test_wildcard_add_without_base_sites():
    """A wildcard subject the base never compiled sites for: both sides
    take the same path, revision after revision."""
    ch = Chain(_MINI, [jrel.must_from_triple("doc:d0", "reader", "user:u0")])
    assert not ch.pd.flat_meta.has_wc_edges
    ch.step([jrel.must_from_tuple("doc:d1#reader", "user:*")])
    ch.step([jrel.must_from_tuple("doc:d2#reader", "user:*")],
            [jrel.must_from_tuple("doc:d1#reader", "user:*")])
    d, _p, _o = ch.planes([jrel.must_from_triple("doc:d2", "read", "user:anyone")])
    assert bool(d[0])


def test_caveated_userset_add_without_column():
    """A caveated userset row whose base view has no caveat column: the
    same bail on both sides, then a conditional answer."""
    base = [
        jrel.must_from_tuple("group:g#member", "user:u0"),
        jrel.must_from_tuple("doc:d0#reader", "group:g#member"),
        jrel.must_from_triple("doc:d9", "reader", "user:u9").with_caveat(
            "tier", {"min": 2}),
    ]
    ch = Chain(_MINI, base)
    assert ch.pd.flat_meta.e_hascav and not ch.pd.flat_meta.us_hascav
    ch.step([jrel.must_from_tuple("doc:d1#reader", "group:g#member").with_caveat(
        "tier", {"min": 7})])
    d, p, _ = ch.planes([jrel.must_from_triple("doc:d1", "read", "user:u0")])
    assert not d[0] and p[0]


def test_long_chain_crosses_bands_then_compacts():
    """40 one-add revisions (fresh nodes past the radix headroom re-base
    the chain where the reference's does), then a burst past the
    compaction bound."""
    rng, rels, ch = _feature_chain(seed=3)
    py = random.Random(5)
    incr = 0
    for revision in range(2, 42):
        add = jrel.must_from_triple(f"doc:d{py.randrange(10)}", "reader",
                                    f"user:lc{revision}")
        deletes = []
        if revision % 5 == 0:
            deletes = [jrel.must_from_triple(
                f"doc:d{py.randrange(10)}", "reader", f"user:lc{revision - 1}")]
        incr += ch.step([add], deletes)
        if revision % 8 == 0:
            d, _p, _o = ch.planes([jrel.must_from_triple(
                f"doc:{add.resource_id}", "read", f"user:lc{revision}")])
            assert bool(d[0])
    assert incr >= 38, incr
    ch.planes(make_checks(rng, 10, 12, n=40))
    big = [jrel.must_from_triple(f"doc:d{i % 10}", "reader", f"user:burst{i}")
           for i in range(70_000)]
    assert not ch.step(big)
    assert ch.pd.flat_meta.delta is None
    assert bool(ch.planes([jrel.must_from_triple(
        "doc:d1", "read", "user:burst1")])[0][0])


# ---------------------------------------------------------------------------
# tests/test_fold_delta.py's worlds: the fold across a chain
# ---------------------------------------------------------------------------

DOCS = """
definition user {}
definition group { relation member: user | group#member }
definition folder {
    relation parent: folder
    relation viewer: user | group#member
    permission view = viewer + parent->view
}
definition document {
    relation folder: folder
    relation viewer: user | group#member
    permission view = viewer + folder->view
}
"""

_EXP = dt.datetime.fromtimestamp((NOW + 7_200_000_000) / 1e6, dt.timezone.utc)


def _docs_rels(rng):
    rels = []
    for i in range(6):
        if i % 3 != 2:
            rels.append(jrel.must_from_tuple(f"group:g{i}#member",
                                             f"group:g{i+1}#member"))
        for u in rng.sample(range(20), 2):
            rels.append(jrel.must_from_tuple(f"group:g{i}#member", f"user:u{u}"))
    for i in range(1, 12):
        rels.append(jrel.must_from_tuple(f"folder:f{i}#parent",
                                         f"folder:f{(i-1)//3}"))
    for i in range(12):
        rels.append(jrel.must_from_tuple(
            f"folder:f{i}#viewer",
            f"user:u{rng.randrange(20)}" if i % 2
            else f"group:g{rng.randrange(6)}#member"))
    rels.append(jrel.must_from_triple("document:d0", "viewer",
                                      "user:u0").with_expiration(_EXP))
    rels.append(jrel.must_from_triple("folder:f0", "viewer",
                                      "user:u1").with_expiration(_EXP))
    for d in range(30):
        rels.append(jrel.must_from_tuple(f"document:d{d}#folder",
                                         f"folder:f{rng.randrange(12)}"))
        if d % 3 == 0:
            rels.append(jrel.must_from_tuple(
                f"document:d{d}#viewer", f"group:g{rng.randrange(6)}#member"))
        if d % 4 == 0:
            rels.append(jrel.must_from_tuple(
                f"document:d{d}#viewer", f"user:u{rng.randrange(20)}"))
    return rels


def _docs_chain(seed, **cfg):
    rels = _docs_rels(random.Random(seed))
    cfg.setdefault("flat_recursion", 3)
    cfg.setdefault("flat_max_width", 32)
    ch = Chain(DOCS, rels, **cfg)
    assert ch.pd.flat_meta.fold_pairs and ch.pd.fold_state is not None
    return rels, ch


def _docs_checks(rng, n=60):
    return [
        jrel.must_from_triple(f"document:d{rng.randrange(30)}", "view",
                              f"user:u{rng.randrange(20)}")
        for _ in range(n)
    ] + [
        jrel.must_from_triple(f"folder:f{rng.randrange(12)}", "view",
                              f"user:u{rng.randrange(20)}")
        for _ in range(n // 2)
    ]


def test_fold_dirty_voids_and_overlays_across_chain():
    """Folded permissions keep answering from the pf probes across a
    chain: dirty voids (dl_pfd) and replacement rows (dl_pfe/dl_pfu),
    through viewer adds, userset adds, tombstones, arrow retargets and
    member edges that advance the closure (the csr view reships as a hash
    group table)."""
    rels, ch = _docs_chain(seed=5)
    py = random.Random(17)
    viewers = [r for r in rels
               if r.resource_relation == "viewer" and r.subject_type == "user"]
    arrows = [r for r in rels if r.resource_relation == "folder"]
    saw_dirty = saw_ovl = 0
    for revision in range(2, 14):
        adds, deletes = [], []
        kind = revision % 6
        if kind == 0:
            adds.append(jrel.must_from_triple(
                f"document:d{py.randrange(30)}", "viewer", f"user:nu{revision}"))
        elif kind == 1:
            adds.append(jrel.must_from_tuple(
                f"folder:f{py.randrange(12)}#viewer",
                f"group:g{py.randrange(6)}#member"))
        elif kind == 2 and viewers:
            deletes.append(viewers.pop(py.randrange(len(viewers))))
        elif kind == 3 and arrows:
            old = arrows.pop(py.randrange(len(arrows)))
            deletes.append(old)
            repl = jrel.must_from_tuple(f"document:{old.resource_id}#folder",
                                        f"folder:f{py.randrange(12)}")
            adds.append(repl)
            arrows.append(repl)
        elif kind == 4:
            adds.append(jrel.must_from_tuple(
                f"group:g{py.randrange(6)}#member", f"user:u{py.randrange(20)}"))
        else:
            adds.append(jrel.must_from_triple(
                f"document:d{py.randrange(30)}", "viewer",
                f"user:u{py.randrange(20)}").with_expiration(_EXP))
        assert ch.step(adds, deletes), f"rev {revision} fell back"
        dm = ch.pd.flat_meta.delta
        assert dm is not None and not dm.pf_off
        saw_dirty += dm.pf_dirty
        saw_ovl += dm.pf_ovl_e or dm.pf_ovl_u
        ch.planes(_docs_checks(py))
    assert saw_dirty >= 8 and saw_ovl >= 4
    assert not ch.pd.flat_meta.pf_s_direct  # the chain's hash csr view


def test_fold_dirty_cap_sticky_downgrade():
    """flat_fold_delta_dirty_cap=0: the chain stays incremental but
    downgrades folded pairs to their walked programs (sticky pf_off)."""
    rels, ch = _docs_chain(seed=13, flat_fold_delta_dirty_cap=0)
    assert ch.step([jrel.must_from_triple("document:d1", "viewer", "user:u1")])
    assert ch.pd.flat_meta.delta.pf_off
    ch.planes(_docs_checks(random.Random(2)))
    assert ch.step([jrel.must_from_triple("document:d2", "viewer", "user:u2")])
    assert ch.pd.flat_meta.delta.pf_off
    ch.planes(_docs_checks(random.Random(3)))


# ---------------------------------------------------------------------------
# the slice's own chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_despec_chain(layout):
    """An expiring member edge puts an until value outside the packed
    closure table's pinned dictionary: the reshipped clx is despec'd
    (its spec leaves FlatMeta.packed and DeviceSnapshot.specs), and the
    program reads it raw for the rest of the chain."""
    rels, ch = _docs_chain(seed=21, **LAYOUTS[layout])
    assert "clx" in dict(ch.pd.flat_meta.packed)
    exp = dt.datetime.fromtimestamp((NOW + 3_600_000_000) / 1e6, dt.timezone.utc)
    grant = jrel.must_from_tuple("group:g1#member", "user:u19").with_expiration(exp)
    assert ch.step([grant])
    assert "clx" not in dict(ch.pd.flat_meta.packed)
    assert "clx" not in ch.pd.specs
    py = random.Random(4)
    ch.planes(_docs_checks(py) + [jrel.must_from_triple(
        f"document:d{d}", "view", "user:u19") for d in range(30)])
    assert ch.step([jrel.must_from_tuple("group:g3#member", "user:u18")])
    ch.planes(_docs_checks(py))


CAVEAT_SCHEMA = """
caveat same_tenant(tenant string, want string) { tenant == want }
definition user {}
definition workspace {
    relation holder: user with same_tenant
    relation viewer: user
    permission access = holder + viewer
}
"""


def test_caveated_chain_appends_stored_contexts():
    """Caveated adds with fresh stored contexts re-encode the ectx_*
    tables in their headroom (same shapes), until the context bucket
    outgrows it and both sides bail to a full prepare."""
    rels = [
        jrel.must_from_triple(f"workspace:w{i}", "holder", f"user:u{i % 5}")
        .with_caveat("same_tenant", {"tenant": f"t{i % 3}"})
        for i in range(12)
    ] + [jrel.must_from_triple("workspace:w0", "viewer", "user:u9")]
    ch = Chain(CAVEAT_SCHEMA, rels)
    rows0 = int(ch.pd.arrays["ectx_vi"].shape[0])
    incr = []
    for revision in range(2, 8):
        adds = [
            jrel.must_from_triple(f"workspace:w{revision}{i}", "holder",
                                  f"user:u{i}")
            .with_caveat("same_tenant", {"tenant": f"fresh{revision}_{i}"})
            for i in range(3)
        ]
        incr.append(ch.step(adds))
        checks = [
            jrel.must_from_triple(a.resource_type + ":" + a.resource_id,
                                  "access", "user:" + a.subject_id)
            .with_caveat("", {"want": want})
            for a in adds for want in (a.caveat_context["tenant"], "other")
        ]
        d, p, _ = ch.planes(checks)
        assert list(d) == [True, False] * 3
    assert incr[0], "the first append fits the 2x headroom"
    assert not all(incr), "the context bucket is outgrown along the chain"
    assert int(ch.pd.arrays["ectx_vi"].shape[0]) > rows0
