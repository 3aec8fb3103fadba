"""The PyTorch port's flat bulk Check against the reference's XLA chain.

Each world is built twice from the same relationships — once by the
reference package (``gochugaru_tpu``) and once by the port
(``gochugaru_tpu_torch``) — and the port must reproduce, bit for bit:

- the reference's prepared arrays and FlatMeta from its own ``prepare``;
- the (definite, possible, overflow) planes of the reference's
  ``DeviceEngine(pallas=False).flat_fn_and_args`` program, both over the
  reference's arrays (``arrays_from_reference``) and over its own.

All outputs are int or bool, so the tolerance is exact equality.  The
port runs on the CPU here (its plain probe path); the card is held to the
same planes by ``chip_smoke.py``.
"""

import dataclasses
import datetime as dt
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as G
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.engine.device import DeviceEngine as JEngine
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store import snapshot as jsnap

from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.engine import device as pdevice
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store import snapshot as psnap

NOW = 1_700_000_000_000_000

# The port's CPU tests run thousands of torch operations on tensors of a
# few hundred elements, where the intra-op thread pool only spins: one of
# the slowest tests here took 137 s with torch's default pool and 38 s
# with one thread (and a ninth of the CPU time).  The test runner's
# workers each import every test module while collecting, so this one
# call holds for every test a worker runs.
torch.set_num_threads(1)


def _port_rel(r):
    return prel.Relationship(
        **{f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    )


class World:
    """One world in both packages: (schema text, relationships or
    columns) → compiled schemas, snapshots, and a query batch."""

    def __init__(self, schema, rels=None, columns=None, checks=None,
                 cols_q=None, cap=4096, **cfg):
        self.schema = schema
        self.j_cs = j_compile(j_parse(schema))
        self.p_cs = p_compile(p_parse(schema))
        if rels is not None:
            self.j_snap = jsnap.build_snapshot(
                1, self.j_cs, JInterner(), rels, epoch_us=NOW)
            self.p_snap = psnap.build_snapshot(
                1, self.p_cs, PInterner(), [_port_rel(r) for r in rels],
                epoch_us=NOW)
        else:
            self.j_snap = columns(jsnap.build_snapshot_from_columns, self.j_cs,
                                  JInterner())
            self.p_snap = columns(psnap.build_snapshot_from_columns, self.p_cs,
                                  PInterner())
        self.checks = checks
        self.cols_q = cols_q
        self.cfg = dict(cfg, closure_source_cap=cap)

    def j_engine(self):
        return JEngine(self.j_cs, JConfig(
            pallas=False, spmm=False, **self.cfg))

    def p_engine(self, **kw):
        return PEngine(self.p_cs, PConfig(**self.cfg, **kw), device="cpu")


def _ref_planes(w, je, jd):
    """The reference's planes from its flat program (XLA chain)."""
    if w.checks is not None:
        q, _u, qctx = je._lower_queries(w.j_snap, w.checks, jd.strings)
        B = len(w.checks)
    else:
        q_res, q_perm, q_subj = w.cols_q
        q, qctx = je._columns_preamble(
            jd, q_res, q_perm, q_subj, None, None, None, None)
        B = q_res.shape[0]
    fn, args = je.flat_fn_and_args(
        jd, q, qctx, jnp.int32(w.j_snap.now_rel32(NOW)), B)
    return [np.asarray(x)[:B] for x in fn(*args)]


def _port_planes(w, pe, pd):
    if w.checks is not None:
        return pe.check_batch(pd, [_port_rel(c) for c in w.checks], now_us=NOW)
    q_res, q_perm, q_subj = w.cols_q
    return pe.check_columns(pd, q_res, q_perm, q_subj, now_us=NOW)


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------


def _rbac_world(**cfg):
    _cs, _snap, _oracle, checks = G._world(n_checks=96)
    return World(G.SCHEMA, rels=_rbac_rels(), checks=checks, **cfg)


def _rbac_rels():
    """The graft world's relationships (its generator, replayed)."""
    rng = random.Random(7)
    n_users, n_teams, n_orgs, n_repos = 40, 6, 3, 20
    users = [f"user:u{i}" for i in range(n_users)]
    teams = [f"team:t{i}" for i in range(n_teams)]
    orgs = [f"org:o{i}" for i in range(n_orgs)]
    repos = [f"repo:r{i}" for i in range(n_repos)]
    triples = []
    for t in teams:
        for u in rng.sample(users, max(2, n_users // 5)):
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
    return [jrel.must_from_tuple(*t) for t in triples]


DOCS_SCHEMA = """
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


def _docs_world(n_users=60, n_groups=20, n_folders=40, n_docs=200, seed=23,
                **cfg):
    """The nested-groups docs world (benchmarks/bench3_docs.py's
    generator) at a small scale: depth-5 group chains, an arity-16
    folder forest, group and direct viewers."""

    def columns(build, cs, interner):
        rng = np.random.default_rng(seed)
        users = np.array([interner.node("user", f"u{i}") for i in range(n_users)], np.int64)
        groups = np.array([interner.node("group", f"g{i}") for i in range(n_groups)], np.int64)
        folders = np.array([interner.node("folder", f"f{i}") for i in range(n_folders)], np.int64)
        docs = np.array([interner.node("document", f"d{i}") for i in range(n_docs)], np.int64)
        slot = cs.slot_of_name
        member, parent, viewer, folder_rel = (
            slot["member"], slot["parent"], slot["viewer"], slot["folder"])
        res, rel, subj, srel = [], [], [], []

        def bulk(r, rl, s, sr):
            res.append(np.asarray(r, np.int64))
            rel.append(np.full(len(r), rl, np.int64))
            subj.append(np.asarray(s, np.int64))
            srel.append(np.full(len(r), sr, np.int64))

        chain = np.arange(n_groups - 1)
        deep = chain[(chain % 5) != 4]
        bulk(groups[deep], member, groups[deep + 1], member)
        gm = np.repeat(groups, 3)
        bulk(gm, member, rng.choice(users, gm.shape[0]), -1)
        f_idx = np.arange(1, n_folders)
        bulk(folders[f_idx], parent, folders[(f_idx - 1) // 16], -1)
        fv = rng.random(n_folders) < 0.5
        bulk(folders[fv], viewer, rng.choice(groups, int(fv.sum())), member)
        bulk(folders[~fv], viewer, rng.choice(users, int((~fv).sum())), -1)
        bulk(docs, folder_rel, rng.choice(folders, n_docs), -1)
        extra = rng.random(n_docs) < 0.2
        bulk(docs[extra], viewer, rng.choice(users, int(extra.sum())), -1)
        bulk(docs, viewer, rng.choice(groups, n_docs), member)
        return build(
            1, cs, interner, res=np.concatenate(res), rel=np.concatenate(rel),
            subj=np.concatenate(subj), srel=np.concatenate(srel), epoch_us=NOW,
        )

    w = World(DOCS_SCHEMA, columns=columns, **cfg)
    rng = np.random.default_rng(7)
    it = w.j_snap.interner
    docs = np.array([it.lookup("document", f"d{i}") for i in range(n_docs)])
    users = np.array([it.lookup("user", f"u{i}") for i in range(n_users)])
    B = 300
    w.cols_q = (
        rng.choice(docs, B).astype(np.int32),
        np.full(B, w.j_cs.slot_of_name["view"], np.int32),
        rng.choice(users, B).astype(np.int32),
    )
    return w


RANDOM_SCHEMA = """
definition user {}
definition team {
    relation member: user | team#member | user:*
    permission everyone = member
}
definition doc {
    relation reader: user | user:* | team#member | team#everyone
    relation writer: user | team#member
    permission edit = writer
    permission view = reader + edit
}
"""


CAVEAT_SCHEMA = (
    'caveat on_tuesday(day string) { day == "tuesday" }\n' + RANDOM_SCHEMA
)


def _random_rels(seed: int, n_edges: int, caveats: bool = False):
    """Direct / wildcard / userset subjects, expirations, team chains deep
    enough to overflow a small closure cap (tests/test_pallas.py's
    generator; its ``on_tuesday`` caveats, with and without a stored
    context, only with ``caveats``)."""
    rng = random.Random(seed)
    n_docs = max(n_edges // 8, 8)
    n_users = max(n_edges // 16, 8)
    n_teams = 32
    rels = []
    for t in range(1, n_teams):
        parent = t - 1 if t % 7 else rng.randrange(t)
        rels.append(jrel.Relationship(
            resource_type="team", resource_id=f"t{parent}",
            resource_relation="member",
            subject_type="team", subject_id=f"t{t}",
            subject_relation="member",
        ))
    for t in range(n_teams):
        rels.append(jrel.Relationship(
            resource_type="team", resource_id=f"t{t}",
            resource_relation="member",
            subject_type="user", subject_id=f"u{rng.randrange(n_users)}",
        ))
    rels.append(jrel.Relationship(
        resource_type="team", resource_id="t3", resource_relation="member",
        subject_type="user", subject_id="*",
    ))
    for _ in range(n_edges):
        d = f"d{rng.randrange(n_docs)}"
        kind = rng.random()
        kw = dict(resource_type="doc", resource_id=d,
                  resource_relation="reader" if rng.random() < 0.8 else "writer",
                  subject_type="user", subject_id=f"u{rng.randrange(n_users)}")
        if kind < 0.08:
            kw.update(subject_type="team",
                      subject_id=f"t{rng.randrange(n_teams)}",
                      subject_relation="member")
        elif kind < 0.11:
            kw.update(subject_type="team",
                      subject_id=f"t{rng.randrange(n_teams)}",
                      subject_relation="everyone")
            kw["resource_relation"] = "reader"
        elif kind < 0.13:
            kw.update(subject_id="*")
            kw["resource_relation"] = "reader"
        if caveats and rng.random() < 0.12:
            kw.update(caveat_name="on_tuesday",
                      caveat_context={"day": "tuesday"} if rng.random() < 0.5 else {})
        if rng.random() < 0.07:
            kw["expiration"] = dt.datetime.fromtimestamp(
                (NOW + rng.randrange(-10**9, 10**12)) / 1e6, tz=dt.timezone.utc,
            )
        rels.append(jrel.Relationship(**kw))
    # one live and one expired edge on a fixed pair, so expiry decides
    rels.append(jrel.Relationship(
        resource_type="doc", resource_id="d0", resource_relation="reader",
        subject_type="user", subject_id="u1",
        expiration=dt.datetime.fromtimestamp((NOW - 10**9) / 1e6, tz=dt.timezone.utc),
    ))
    return rels


def _random_checks(seed: int, n: int, caveats: bool = False):
    """Checks of the random world; with ``caveats`` 40% of them carry a
    request context (a day that passes or fails ``on_tuesday``)."""
    rng = random.Random(seed + 1)
    out = []
    for _ in range(n):
        subj = (f"team:t{rng.randrange(32)}#member" if rng.random() < 0.15
                else f"user:u{rng.randrange(12)}")
        q = jrel.must_from_triple(
            f"doc:d{rng.randrange(16)}", rng.choice(["view", "edit", "reader"]),
            subj,
        )
        if caveats and rng.random() < 0.4:
            q = q.with_caveat("", {"day": rng.choice(["tuesday", "friday"])})
        out.append(q)
    return out


def _random_world(cap=4096, caveats=False):
    return World(CAVEAT_SCHEMA if caveats else RANDOM_SCHEMA,
                 rels=_random_rels(5, 400, caveats),
                 checks=_random_checks(5, 160, caveats), cap=cap)


WORLDS = {
    "rbac": _rbac_world,
    # fold off: the walked programs (arrows, ancestor closures, the KU
    # userset path) answer instead of the permission-fold probe pair
    "rbac_walked": lambda: _rbac_world(flat_fold=False),
    "docs": _docs_world,
    "docs_walked": lambda: _docs_world(flat_fold=False),
    # a recursion budget below the folder depth: the folder hierarchy
    # flattens into ancestor-closure (rc) tables
    "docs_ancestor_closure": lambda: _docs_world(
        flat_fold=False, flat_recursion=1),
    "random_expiry_wildcards": _random_world,
    "closure_overflow": lambda: _random_world(cap=4),
    # the same world with tests/test_pallas.py's caveats back in: stored
    # contexts, request contexts, caveated userset and wildcard edges
    "random_caveats": lambda: _random_world(caveats=True),
    "closure_overflow_caveats": lambda: _random_world(cap=4, caveats=True),
}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    w = WORLDS[request.param]()
    je = w.j_engine()
    jd = je.prepare(w.j_snap)
    np_arrays = {k: np.asarray(v) for k, v in jd.arrays.items()}
    return w, je, jd, np_arrays


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_planes_on_reference_arrays(world):
    """arrays_from_reference: identical tables → identical planes."""
    w, je, jd, np_arrays = world
    ref = _ref_planes(w, je, jd)
    pe = w.p_engine()
    arrays, meta = pdevice.arrays_from_reference(np_arrays, jd.flat_meta,
                                                 device="cpu")
    assert set(arrays) == set(np_arrays)
    pd = pe.snapshot_from_reference(w.p_snap, np_arrays, jd.flat_meta,
                                    jd.strings)
    got = _port_planes(w, pe, pd)
    for name, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), name
    assert ref[0].any() and (~ref[0]).any()


REV_KEYS = ("rv_off", "rvx", "ra_off", "rax", "fw_off", "fwx")
REV_META = ("has_rev", "has_fw", "rv_cap", "ra_cap", "fw_cap", "packed",
            "packed_off")


def test_own_prepare_matches_reference(world):
    """The port's prepare builds the reference's arrays key for key and
    bit for bit, and the same FlatMeta — the reverse-CSR lookup tables
    (rv/ra/fw offsets and rows, packed like the rest) included."""
    w, je, jd, np_arrays = world
    pe = w.p_engine()
    arrays, meta = pe.prepare_host(w.p_snap)
    assert set(arrays) == set(np_arrays)
    assert set(REV_KEYS) <= set(arrays)
    for k, v in np_arrays.items():
        assert arrays[k].dtype == v.dtype, k
        assert np.array_equal(arrays[k], v), k
    jm = dataclasses.asdict(jd.flat_meta)
    pm = dataclasses.asdict(meta)
    assert pm == {k: jm[k] for k in pm}
    assert meta.has_rev and meta.has_fw
    for k in REV_META:
        assert pm[k] == jm[k], k
    packed = {k for k, _spec in meta.packed}
    assert {"rvx", "rax", "fwx"} <= packed


def test_planes_on_own_prepare(world):
    w, je, jd, _np_arrays = world
    ref = _ref_planes(w, je, jd)
    pe = w.p_engine()
    got = _port_planes(w, pe, pe.prepare(w.p_snap))
    for name, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), name


def test_unpacked_tables_give_the_same_planes(world):
    """flat_packed=False: full-width int32 tables, same planes."""
    w, je, jd, _np_arrays = world
    ref = _ref_planes(w, je, jd)
    pe = w.p_engine(flat_packed=False)
    pd = pe.prepare(w.p_snap)
    assert not pd.flat_meta.packed
    got = _port_planes(w, pe, pd)
    for name, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), name


def test_closure_overflow_world_flags_overflow():
    """The small closure cap really overflows, so the ``any``/ovfx sites
    carry traffic in the parity above."""
    w = _random_world(cap=4)
    pe = w.p_engine()
    pd = pe.prepare(w.p_snap)
    assert pd.flat_meta.has_ovf
    _d, _p, ovf = _port_planes(w, pe, pd)
    assert ovf.any()


def test_arrays_from_reference_default_device_raises_without_cuda(world):
    """arrays_from_reference resolves its device like every entry point:
    ``cuda`` unless the caller names one, and no silent CPU run."""
    import torch

    _w, _je, jd, np_arrays = world
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError):
        pdevice.arrays_from_reference(np_arrays, jd.flat_meta)
    arrays, _meta = pdevice.arrays_from_reference(np_arrays, jd.flat_meta,
                                                  device="cpu")
    assert all(t.device.type == "cpu" for t in arrays.values())
