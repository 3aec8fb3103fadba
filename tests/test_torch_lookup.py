"""The PyTorch port's lookups against the reference's looped frontier path.

The reference side is ``gochugaru_tpu`` with ``DeviceEngine(pallas=False,
spmm=False)``: the per-hop frontier of engine/spmv.py over the reverse-CSR
tables, its XLA ``_make_runs`` bisect, and the same exact filter.  Each
world is built in both packages from the same relationships (interned in
the same order, so node ids agree), and the port must reproduce, exactly:

- the ``runs`` probe (its plain twin here) against the reference's
  ``FrontierKernels._make_runs`` body on ``rvx``/``rax``/``fwx``, packed
  and int32, and on a synthetic table with one heavy bucket;
- the candidate blocks of the resource and subject frontiers, block for
  block, and each page and cursor of the paginated stream;
- the full answers of ``lookup_*_device`` and of the port's Client,
  against ``sorted(oracle.lookup_*)`` and the reference client.

All outputs are ints or id strings, so every comparison is exact
equality.  The CUDA kernel is held to the twin by ``test_torch_probe.py``
(``cuda`` marker) and ``chip_smoke.py``.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_engine as TE
from gochugaru_tpu import caveats as jcel, consistency as jcons, rel as jrel
from gochugaru_tpu.client import new_tpu_evaluator
from gochugaru_tpu.engine import lookup as jlookup
from gochugaru_tpu.engine import spmv as jspmv
from gochugaru_tpu.engine.oracle import Oracle as JOracle
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import caveats as pcel, consistency as pcons, rel as prel
from gochugaru_tpu_torch.client import new_evaluator
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine import lookup as plookup
from gochugaru_tpu_torch.engine import rev as prev
from gochugaru_tpu_torch.engine import spmv as pspmv
from gochugaru_tpu_torch.engine.device import to_device_tensor
from gochugaru_tpu_torch.engine.oracle import Oracle as POracle
from gochugaru_tpu_torch.engine.partition import _hash_cols
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils.context import background

NOW = TE.NOW

# the reference test_lookup.py fuzz world: recursion through parent,
# exclusion, intersection, wildcards, nested groups; its ``lim`` caveat
# on writer edges in CAVEAT_FUZZ_SCHEMA
FUZZ_SCHEMA = """
definition user {}
definition group {
    relation member: user | group#member | user:*
}
definition proj {
    relation parent: proj
    relation owner: user | group#member
    relation writer: user | group#member
    relation banned: user
    permission write = (owner + writer + parent->write) - banned
    permission manage = owner & writer
}
"""


CAVEAT_FUZZ_SCHEMA = 'caveat lim(v int, cap int) { v <= cap }\n' + (
    FUZZ_SCHEMA.replace("relation writer: user | group#member",
                        "relation writer: user | group#member | user with lim"))


def _fuzz_rels(seed, caveats=False):
    """The reference fuzz generator; with ``caveats`` 40% of the writer
    edges carry ``lim``, most with a stored context (tests/test_lookup.py
    draws it the same way)."""
    rng = random.Random(seed)
    users = [f"user:u{i}" for i in range(12)]
    groups = [f"group:g{i}" for i in range(5)]
    projs = [f"proj:p{i}" for i in range(8)]
    rels = []
    for g in groups:
        for u in rng.sample(users, 3):
            rels.append(jrel.must_from_tuple(f"{g}#member", u))
        if rng.random() < 0.5:
            rels.append(jrel.must_from_tuple(
                f"{g}#member", f"{rng.choice(groups)}#member"))
        if rng.random() < 0.3:
            rels.append(jrel.must_from_tuple(f"{g}#member", "user:*"))
    for p in projs:
        if rng.random() < 0.6:
            rels.append(jrel.must_from_tuple(f"{p}#parent", rng.choice(projs)))
        rels.append(jrel.must_from_tuple(f"{p}#owner", rng.choice(users)))
        if rng.random() < 0.7:
            rels.append(jrel.must_from_tuple(
                f"{p}#owner", f"{rng.choice(groups)}#member"))
        for u in rng.sample(users, 2):
            r = jrel.must_from_tuple(f"{p}#writer", u)
            if caveats and rng.random() < 0.4:
                r = r.with_caveat(
                    "lim",
                    {"v": rng.randint(0, 9), "cap": 5} if rng.random() < 0.7 else {},
                )
            rels.append(r)
        if rng.random() < 0.4:
            rels.append(jrel.must_from_tuple(f"{p}#banned", rng.choice(users)))
    return rels


class LWorld:
    """One world in both packages, prepared by both engines, with its
    lookup queries: resources ``(rtype, perm, stype, sid, srel)`` and
    subjects ``(rtype, rid, perm, stype, srel)``."""

    def __init__(self, w, res_q, subj_q, rels=None):
        self.w = w
        self.je = TE.JEngine(w.j_cs, JConfig(
            pallas=False, spmm=False, **w.cfg))
        self.jd = self.je.prepare(w.j_snap)
        # both sides on the looped per-hop path: the fused program's
        # parity with the reference's spmm=True is tests/test_torch_spmm.py
        self.pe = w.p_engine(spmm=False)
        self.pd = self.pe.prepare(w.p_snap)
        self.res_q = res_q
        self.subj_q = subj_q
        if rels is not None:
            # the schema's caveats compiled for each package's host CEL
            progs = [{n: mod.compile_cel(n, d.params, d.expression)
                      for n, d in cs.schema.caveats.items()}
                     for mod, cs in ((jcel, w.j_cs), (pcel, w.p_cs))]
            self.j_oracle = JOracle(w.j_cs, rels, progs[0], now_us=NOW)
            self.p_oracle = POracle(
                w.p_cs, [TE._port_rel(r) for r in rels], progs[1], now_us=NOW)
        else:
            from gochugaru_tpu.engine.oracle import SnapshotOracle as JS
            from gochugaru_tpu_torch.engine.oracle import SnapshotOracle as PS

            self.j_oracle = JS(w.j_snap, now_us=NOW)
            self.p_oracle = PS(w.p_snap, now_us=NOW)


def _rbac():
    rels = TE._rbac_rels()
    w = TE.World(TE.G.SCHEMA, rels=rels)
    res_q = [("repo", p, "user", f"u{i}", "") for i in range(0, 40, 5)
             for p in ("read", "admin")]
    res_q += [("repo", "read", "team", f"t{i}", "member") for i in range(6)]
    subj_q = [("repo", f"r{i}", p, "user", "") for i in range(0, 20, 3)
              for p in ("read", "admin")]
    subj_q += [("repo", f"r{i}", "read", "team", "member") for i in range(4)]
    return LWorld(w, res_q, subj_q, rels)


def _docs():
    w = TE._docs_world()
    res_q = [("document", "view", "user", f"u{i}", "") for i in range(0, 60, 6)]
    res_q += [("document", "view", "group", f"g{i}", "member")
              for i in range(0, 20, 4)]
    res_q += [("folder", "view", "user", f"u{i}", "") for i in range(0, 60, 15)]
    subj_q = [("document", f"d{i}", "view", "user", "") for i in range(0, 200, 23)]
    subj_q += [("document", f"d{i}", "view", "group", "member")
               for i in range(0, 200, 61)]
    return LWorld(w, res_q, subj_q)


def _overflow():
    rels = TE._random_rels(5, 400)
    w = TE.World(TE.RANDOM_SCHEMA, rels=rels, cap=4)
    res_q = [("doc", p, "user", f"u{i}", "") for i in range(0, 25, 4)
             for p in ("view", "edit")]
    res_q += [("doc", "view", "team", f"t{i}", "member") for i in (0, 3, 9)]
    res_q += [("doc", "view", "team", "t3", "everyone"),
              ("doc", "view", "user", "stranger", ""),
              ("doc", "view", "user", "*", "")]
    subj_q = [("doc", f"d{i}", p, "user", "") for i in range(0, 50, 7)
              for p in ("view", "edit")]
    subj_q += [("doc", f"d{i}", "view", "team", "member") for i in (0, 8)]
    return LWorld(w, res_q, subj_q, rels)


def _fuzz(seed, caveats=False):
    rels = _fuzz_rels(seed, caveats)
    w = TE.World(CAVEAT_FUZZ_SCHEMA if caveats else FUZZ_SCHEMA, rels=rels)
    res_q = [("proj", p, "user", f"u{i}", "") for i in range(0, 12, 2)
             for p in ("write", "manage")]
    res_q += [("proj", "write", "user", "stranger", "")]
    res_q += [("proj", "write", "group", f"g{i}", "member") for i in range(5)]
    subj_q = [("proj", f"p{i}", p, "user", "") for i in range(0, 8, 2)
              for p in ("write", "manage")]
    subj_q += [("proj", f"p{i}", "write", "group", "member") for i in (1, 5)]
    return LWorld(w, res_q, subj_q, rels)


def _own_perm_userset(cs, stype, srel):
    """True for a userset subject whose type declares permissions, in a
    schema with permission-valued usersets.  The reference's frontier and
    walker seed only the subject's own key, so a grant that reaches the
    subject through a permission of the subject NODE itself (team:t4#member
    and an edge to team:t4#everyone, everyone = member) is missed: a fault
    of the reference, which the port reproduces block for block (ROADMAP
    queue 3).  For these queries the answer is held to a subset of the
    oracle's (no false grant); every other query to equality."""
    if not srel or not cs.has_permission_usersets:
        return False
    return bool(cs.schema.definitions[stype].permissions)


def _assert_answer(cs, stype, srel, got, want):
    want = sorted(want)
    if _own_perm_userset(cs, stype, srel):
        assert set(got) <= set(want)
    else:
        assert got == want


WORLDS = {
    "rbac": _rbac,
    "docs": _docs,
    "overflow_wildcards_expiry": _overflow,
    "fuzz1": lambda: _fuzz(1),
    "fuzz2": lambda: _fuzz(2),
    "fuzz5": lambda: _fuzz(5),
    "fuzz1_caveats": lambda: _fuzz(1, caveats=True),
    "fuzz5_caveats": lambda: _fuzz(5, caveats=True),
}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def lw(request):
    return WORLDS[request.param]()


# ---------------------------------------------------------------------------
# the runs probe vs the reference's _make_runs body
# ---------------------------------------------------------------------------


def _run_keys(col0, seed, n=700):
    """Keys present in the view (many repeats), absent keys, and -1."""
    rng = np.random.default_rng(seed)
    present = col0[col0 >= 0]
    k = rng.choice(present, n) if present.size else np.zeros(n, np.int32)
    absent = rng.integers(0, int(col0.max()) + 50, n // 4)
    keys = np.concatenate([k, absent, [-1, -7, 0]]).astype(np.int32)
    out = np.full(1024 * ((keys.shape[0] + 1023) // 1024), -1, np.int32)
    out[: keys.shape[0]] = keys
    return out


def _ref_runs(fk, tbl_key, off_key, cap, w, arrs, keys):
    fn = fk._make_runs(tbl_key, off_key, cap, w)
    off_a = arrs.get(off_key + "_a", np.zeros(1, np.int32))
    lo, ln = fn(jnp.asarray(arrs[off_key]), jnp.asarray(off_a),
                jnp.asarray(arrs[tbl_key]), jnp.asarray(keys))
    return np.asarray(lo), np.asarray(ln)


def _port_runs(meta, tbl_key, off_key, cap, arrs, keys):
    pk, pko = dict(meta.packed), dict(meta.packed_off)
    shift = pko.get(off_key)
    lo, ln = K.fused_probe(
        (torch.from_numpy(keys),), to_device_tensor(arrs[off_key], "cpu"),
        to_device_tensor(arrs[tbl_key], "cpu"), cap=cap,
        spec=pk.get(tbl_key),
        off_a=(to_device_tensor(arrs[off_key + "_a"], "cpu")
               if shift is not None else None),
        ashift=shift, mode="runs",
    )
    assert lo.dtype == ln.dtype == torch.int32
    return lo.numpy(), ln.numpy()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "int32"])
@pytest.mark.parametrize("view", ["rv", "ra", "fw"])
def test_runs_twin_matches_reference_body(view, packed):
    """The twin == spmv.py ``_make_runs`` (XLA, pallas=False) on the docs
    world's prepared reverse tables, bit for bit."""
    w = TE._docs_world(flat_packed=packed)
    je = TE.JEngine(w.j_cs, JConfig(pallas=False, spmm=False, **w.cfg))
    jd = je.prepare(w.j_snap)
    arrs = {k: np.asarray(v) for k, v in jd.arrays.items()}
    meta = jd.flat_meta
    fk = jspmv.FrontierKernels(meta, je.config)
    tbl_key, off_key = f"{view}x", f"{view}_off"
    cap = {"rv": meta.rv_cap, "ra": meta.ra_cap, "fw": meta.fw_cap}[view]
    w_tbl = {"rv": fk.w_rv, "ra": fk.w_ra, "fw": fk.w_rv}[view]
    assert (tbl_key in dict(meta.packed)) == packed
    # column 0 of the view, decoded, for drawing present keys
    from gochugaru_tpu_torch.engine.packed import decode_block
    spec = dict(meta.packed).get(tbl_key)
    t = to_device_tensor(arrs[tbl_key], "cpu")
    col0 = (decode_block(t, spec) if spec else t)[:, 0].numpy()
    keys = _run_keys(col0, 3)
    want = _ref_runs(fk, tbl_key, off_key, cap, w_tbl, arrs, keys)
    got = _port_runs(meta, tbl_key, off_key, cap, arrs, keys)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert (want[1] > 1).any() and (want[1] == 0).any()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "int32"])
def test_runs_twin_on_a_heavy_bucket(packed):
    """A rev-style table with one key of 3,000 rows (bisect cap 4,096):
    the twin == the reference body, and each found run is exactly the
    key's rows."""
    from gochugaru_tpu_torch.engine import packed as PK

    rng = np.random.default_rng(11)
    k0 = np.concatenate([np.full(3000, 77, np.int32),
                         rng.integers(100, 5000, 20_000).astype(np.int32)])
    k1 = rng.integers(0, 1 << 20, k0.shape[0]).astype(np.int32)
    h = _hash_cols([k0])
    geom = prev.rev_geom(h, 1)
    off, tbl = prev.build_rev_full(h, [k0, k1], geom, 2)
    cap = prev.rev_meta_kw(geom, geom, None)["rv_cap"]
    assert cap >= 4096
    arrs = {"rv_off": off, "rvx": tbl}
    meta_kw = {}
    if packed:
        spec = PK.make_spec([PK.col_range(-1, 5000), PK.col_range(-1, 1 << 20)])
        res, anchor = PK.pack_off(off)
        arrs = {"rv_off": res, "rv_off_a": anchor,
                "rvx": PK.pack_rows(tbl, spec)}
        meta_kw = dict(packed=(("rvx", spec),),
                       packed_off=(("rv_off", PK.OFF_ANCHOR_SHIFT),))
    keys = _run_keys(k0, 4)
    keys[:5] = [77, 77, -1, 5001, 0]
    meta = SimpleNamespace(packed=meta_kw.get("packed", ()),
                           packed_off=meta_kw.get("packed_off", ()))
    # the reference's bisect body needs only these of a FrontierKernels
    fk = object.__new__(jspmv.FrontierKernels)
    fk._pk, fk._pko, fk._pls = dict(meta.packed), dict(meta.packed_off), False
    want = _ref_runs(fk, "rvx", "rv_off", cap, 2, arrs, keys)
    got = _port_runs(meta, "rvx", "rv_off", cap, arrs, keys)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    lo, ln = got
    assert ln[0] == 3000 and (tbl[lo[0]:lo[0] + ln[0], 0] == 77).all()
    assert ln[2] == 0 and lo[2] == 0
    present = keys >= 0
    assert np.array_equal(
        ln[present], np.bincount(k0, minlength=6000)[keys[present]])


def test_runs_rejects_two_key_columns():
    q = torch.zeros(4, dtype=torch.int32)
    off = torch.zeros(9, dtype=torch.int32)
    tbl = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.fused_probe((q, q), off, tbl, cap=4, mode="runs")


def test_runs_rows_read_trace():
    """``rows_read`` leaves the answer alone and traces only rows inside
    the key's bucket, at most 2·steps of them; a key < 0 reads none."""
    from gochugaru_tpu_torch.engine.hash import bucket_of
    from gochugaru_tpu_torch.engine.kernels.plain import runs_plain

    rng = np.random.default_rng(12)
    k0 = np.concatenate([np.full(700, 9, np.int32),
                         rng.integers(10, 900, 5_000).astype(np.int32)])
    h = _hash_cols([k0])
    geom = prev.rev_geom(h, 1)
    off, tbl = prev.build_rev_full(h, [k0], geom, 1)
    cap = prev.rev_meta_kw(geom, geom, None)["rv_cap"]
    off, tbl = torch.from_numpy(off), torch.from_numpy(tbl)
    steps = max(cap.bit_length(), 1)
    for key in (9, 11, 901):
        q = torch.tensor([key], dtype=torch.int32)
        rows = []
        got = runs_plain(q, off, tbl, cap=cap, rows_read=rows)
        want = runs_plain(q, off, tbl, cap=cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        b = int(bucket_of([q], int(off.shape[0]) - 1)[0])
        rows = torch.cat(rows)
        assert 0 < rows.numel() <= 2 * steps or int(off[b + 1] - off[b]) == 0
        assert ((rows >= off[b]) & (rows < off[b + 1])).all()
    rows = []
    runs_plain(torch.tensor([-1], dtype=torch.int32), off, tbl, cap=cap,
               rows_read=rows)
    assert torch.cat(rows).numel() == 0


# ---------------------------------------------------------------------------
# candidate streams, pages and full answers vs the reference (spmm=False)
# ---------------------------------------------------------------------------


def _blocks(it):
    return [np.asarray(b, np.int64) for b in it]


def test_prepared_reverse_tables_match(lw):
    """Both engines serve lookups from identical reverse tables."""
    for k in ("rv_off", "rvx", "ra_off", "rax", "fw_off", "fwx"):
        assert np.array_equal(lw.pd.arrays[k].numpy(),
                              np.asarray(lw.jd.arrays[k]).view(
                                  lw.pd.arrays[k].numpy().dtype)), k
    assert pspmv.frontier_ok(lw.pe, lw.pd)
    assert jspmv.frontier_ok(lw.je, lw.jd)


def test_resource_candidate_blocks_match_reference(lw):
    jst = jspmv.state_for(lw.je, lw.jd)
    pst = pspmv.state_for(lw.pe, lw.pd)
    assert jst._spmm is None  # the reference's looped per-hop path
    n_nonempty = 0
    for q in lw.res_q:
        jr = jlookup._resolve_resources(lw.jd, *q)
        pr = plookup._resolve_resources(lw.pd, *q)
        assert jr == pr, q
        if jr is None:
            continue
        rtid, _perm, srel, subj, wc = jr
        want = _blocks(jst.resource_candidates(rtid, subj, srel, wc, NOW))
        got = _blocks(pst.resource_candidates(rtid, subj, srel, wc, NOW))
        assert len(got) == len(want), q
        for a, b in zip(got, want):
            assert np.array_equal(a, b), q
        n_nonempty += bool(want)
    assert n_nonempty


def test_subject_candidate_blocks_match_reference(lw):
    jst = jspmv.state_for(lw.je, lw.jd)
    pst = pspmv.state_for(lw.pe, lw.pd)
    n_nonempty = 0
    for q in lw.subj_q:
        jr = jlookup._resolve_subjects(lw.jd, *q)
        pr = plookup._resolve_subjects(lw.pd, *q)
        assert jr == pr, q
        if jr is None:
            continue
        res, _perm, srel, stid, wc = jr
        want = _blocks(jst.subject_candidates(res, stid, srel, wc, NOW))
        got = _blocks(pst.subject_candidates(res, stid, srel, wc, NOW))
        assert len(got) == len(want), q
        for a, b in zip(got, want):
            assert np.array_equal(a, b), q
        n_nonempty += bool(want)
    assert n_nonempty


def _walk_pages(page_fn, engine, dsnap, q, oracle, page_size):
    pages, cursor = [], None
    while True:
        ids, cursor = page_fn(engine, dsnap, *q, page_size=page_size,
                              cursor=cursor, now_us=NOW,
                              oracle_factory=lambda: oracle)
        pages.append((ids, cursor.encode() if cursor is not None else None))
        if cursor is None:
            return pages


@pytest.mark.parametrize("kind", ["resources", "subjects"])
def test_pages_and_cursors_match_reference(lw, kind):
    """Every page and every encoded cursor equals the reference's; the
    pages concatenate to the full answer with no duplicates."""
    qs = lw.res_q if kind == "resources" else lw.subj_q
    jfn = getattr(jlookup, f"lookup_{kind}_page")
    pfn = getattr(plookup, f"lookup_{kind}_page")
    n_multi = 0
    for q in qs[::2]:
        want = _walk_pages(jfn, lw.je, lw.jd, q, lw.j_oracle, 3)
        got = _walk_pages(pfn, lw.pe, lw.pd, q, lw.p_oracle, 3)
        assert got == want, q
        ids = [i for page, _c in got for i in page]
        assert len(ids) == len(set(ids))
        n_multi += len(got) > 1
    assert n_multi


def test_cursor_resume_after_eviction_recomputes_exactly(lw):
    """A cursor whose live stream was evicted resumes by recompute-and-
    skip: the same remaining pages as an uninterrupted walk."""
    q = max(lw.res_q, key=lambda q: len(list(lw.p_oracle.lookup_resources(*q))))
    first, cur = plookup.lookup_resources_page(
        lw.pe, lw.pd, *q, page_size=2, now_us=NOW,
        oracle_factory=lambda: lw.p_oracle)
    assert cur is not None
    lw.pd.__dict__.pop("_lookup_streams", None)
    rest = []
    while cur is not None:
        ids, cur = plookup.lookup_resources_page(
            lw.pe, lw.pd, *q, page_size=2, cursor=cur,
            oracle_factory=lambda: lw.p_oracle)
        rest.extend(ids)
    assert sorted(first + rest) == sorted(lw.p_oracle.lookup_resources(*q))


def test_device_lookups_match_oracle_and_reference(lw):
    cs = lw.w.p_cs
    for q in lw.res_q:
        got = plookup.lookup_resources_device(
            lw.pe, lw.pd, *q, now_us=NOW, oracle_factory=lambda: lw.p_oracle)
        _assert_answer(cs, q[2], q[4], got, lw.p_oracle.lookup_resources(*q))
        assert got == jlookup.lookup_resources_device(
            lw.je, lw.jd, *q, now_us=NOW,
            oracle_factory=lambda: lw.j_oracle), q
    for q in lw.subj_q:
        got = plookup.lookup_subjects_device(
            lw.pe, lw.pd, *q, now_us=NOW, oracle_factory=lambda: lw.p_oracle)
        _assert_answer(cs, q[3], q[4], got, lw.p_oracle.lookup_subjects(*q))
        assert got == jlookup.lookup_subjects_device(
            lw.je, lw.jd, *q, now_us=NOW,
            oracle_factory=lambda: lw.j_oracle), q


def test_host_walker_matches_reference(lw):
    """The walker (the serving path without the reverse index, and
    chip_smoke.py's full-size yardstick) == the reference's walker."""
    for q in lw.res_q:
        r = plookup._resolve_resources(lw.pd, *q)
        if r is None:
            continue
        _rt, _p, srel, subj, wc = r
        assert np.array_equal(
            plookup._walk_resource_candidates(lw.w.p_snap, subj, srel, wc),
            jlookup._walk_resource_candidates(lw.w.j_snap, subj, srel, wc)), q
    for q in lw.subj_q:
        r = plookup._resolve_subjects(lw.pd, *q)
        if r is None:
            continue
        res, _p, srel, stid, wc = r
        assert np.array_equal(
            plookup._walk_subject_candidates(lw.w.p_snap, res, stid, srel, wc),
            jlookup._walk_subject_candidates(lw.w.j_snap, res, stid, srel, wc),
        ), q


def test_rev_index_off_serves_from_the_walker():
    """flat_rev_index=False builds no reverse tables; lookups take the
    host walker and give the same answers."""
    lw = _rbac()
    pe = lw.w.p_engine(flat_rev_index=False)
    pd = pe.prepare(lw.w.p_snap)
    assert not pd.flat_meta.has_rev and "rvx" not in pd.arrays
    assert not pspmv.frontier_ok(pe, pd)
    for q in lw.res_q[:6]:
        assert plookup.lookup_resources_device(
            pe, pd, *q, now_us=NOW, oracle_factory=lambda: lw.p_oracle,
        ) == sorted(lw.p_oracle.lookup_resources(*q))


# ---------------------------------------------------------------------------
# the Client
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lclients():
    rels = TE._random_rels(9, 300)
    pc = new_evaluator(device="cpu")
    jc = new_tpu_evaluator()
    for c, mod, ctx, rs in (
        (pc, prel, background(), [TE._port_rel(r) for r in rels]),
        (jc, jrel, j_background(), rels),
    ):
        c.write_schema(ctx, TE.RANDOM_SCHEMA)
        txn = mod.Txn()
        for r in rs:
            txn.touch(r)
        c.write(ctx, txn)
    return pc, jc


def _client_queries():
    res = [("doc#view", f"user:u{i}") for i in (0, 2, 5, 11)]
    res += [("doc#edit", "user:u3"), ("doc#view", "team:t4#member"),
            ("doc#view", "team:t3#everyone")]
    subj = [(f"doc:d{i}", "view", "user") for i in (0, 3, 17)]
    subj += [("doc:d1", "edit", "user"), ("doc:d2", "view", "team#member")]
    return res, subj


def test_client_lookups_match_reference_client_and_oracle(lclients):
    pc, jc = lclients
    res_q, subj_q = _client_queries()
    snap = jc.store.snapshot_for(jcons.full())
    oracle = jc._oracle_for(snap)
    for perm, subj in res_q:
        got = list(pc.lookup_resources(background(), pcons.full(), perm, subj))
        ref = sorted(jc.lookup_resources(j_background(), jcons.full(), perm, subj))
        rt, p = perm.split("#")
        st, rest = subj.split(":")
        sid, _, srel = rest.partition("#")
        assert got == ref
        _assert_answer(snap.compiled, st, srel, got,
                       oracle.lookup_resources(rt, p, st, sid, srel))
    for res, perm, subj in subj_q:
        got = list(pc.lookup_subjects(background(), pcons.full(), res, perm, subj))
        ref = sorted(jc.lookup_subjects(j_background(), jcons.full(), res, perm, subj))
        rt, rid = res.split(":")
        st, _, srel = subj.partition("#")
        assert got == ref
        _assert_answer(snap.compiled, st, srel, got,
                       oracle.lookup_subjects(rt, rid, perm, st, srel))
    assert any(list(pc.lookup_resources(background(), pcons.full(), p, s))
               for p, s in res_q)


@pytest.mark.parametrize("kind", ["resources", "subjects"])
def test_client_paged_walk_matches_oracle(lclients, kind):
    """A cursor walk through the Client: pages concatenate to the
    oracle's full answer, no duplicates, cursors opaque strings."""
    pc, jc = lclients
    res_q, subj_q = _client_queries()
    snap = jc.store.snapshot_for(jcons.full())
    oracle = jc._oracle_for(snap)
    for args in (res_q if kind == "resources" else subj_q):
        fn = getattr(pc, f"lookup_{kind}_page")
        ids, cursor, n_pages = [], None, 0
        while True:
            page = fn(background(), pcons.full(), *args, page_size=4,
                      cursor=cursor)
            ids.extend(page.ids)
            n_pages += 1
            cursor = page.cursor
            if cursor is None:
                break
            assert isinstance(cursor, str)
        if kind == "resources":
            rt, p = args[0].split("#")
            st, rest = args[1].split(":")
            sid, _, srel = rest.partition("#")
            want = oracle.lookup_resources(rt, p, st, sid, srel)
        else:
            rt, rid = args[0].split(":")
            st, _, srel = args[2].partition("#")
            want = oracle.lookup_subjects(rt, rid, args[1], st, srel)
        assert len(ids) == len(set(ids))
        _assert_answer(snap.compiled, st, srel, sorted(ids), want)


def test_lookup_dispatch_faults_retry_transparently(lclients):
    """An injected transient fault at the lookup hop dispatch classifies
    as retriable and the envelope re-runs the lookup, as the
    reference's client does."""
    pc, jc = lclients
    want = list(pc.lookup_resources(background(), pcons.full(), "doc#view",
                                    "user:u2"))
    with pfaults.armed("lookup.dispatch", times=2) as spec:
        got = list(pc.lookup_resources(background(), pcons.full(),
                                       "doc#view", "user:u2"))
    assert got == want and want
    assert spec.fired == 2
    with pfaults.armed("lookup.dispatch", times=1) as spec:
        page = pc.lookup_subjects_page(background(), pcons.full(), "doc:d3",
                                       "view", "user", page_size=1000)
    assert spec.fired == 1
    assert sorted(page.ids) == list(pc.lookup_subjects(
        background(), pcons.full(), "doc:d3", "view", "user"))
    assert page.cursor is None
