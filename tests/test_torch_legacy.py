"""The port's legacy two-phase check program against the reference's.

The reference serves a batch on its legacy program (``_make_check_fn``,
an XLA program vmapped per subject and per query) wherever its flat
program cannot: ``EngineConfig(use_flat=False)``, a batch with more
distinct permissions than ``flat_max_slots``, a graph whose dense keys do
not pack into int32.  The port (engine/legacy.py) must return the same
(definite, possible, overflow) planes bit for bit, overflow plane
included, over its own prepared tables and over the reference's
(``snapshot_from_reference`` with ``flat_meta=None``).  All outputs are
bool, so the tolerance is exact equality.  The worlds are small (the
reference's legacy program takes ~10 s to compile on the CPU) and come
from seeded generators; the port runs on the CPU here.  The edge worlds
(overflow caps, slot spill, unpackable graphs, delta snapshots, chunks,
the closure hop's padding) are tests/test_torch_legacy_worlds.py's.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from gochugaru_tpu import rel as jrel
from gochugaru_tpu.caveats import compile_cel as j_compile_cel
from gochugaru_tpu.engine.device import DeviceEngine as JEngine
from gochugaru_tpu.engine.oracle import SnapshotOracle as JSnapshotOracle, T
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.snapshot import build_snapshot as j_build

import chip_smoke
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.engine import legacy as L
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot as p_build
from gochugaru_tpu_torch.utils import metrics

from test_flat_engine import FEATURES, NOW, build_feature_world, make_checks

#: every name of FEATURES: a batch over all of them is past flat_max_slots
FEATURE_NAMES = ("member", "admin", "parent", "owner", "view", "folder",
                 "reader", "banned", "read", "audit")


def _port_rel(r):
    return prel.Relationship(
        **{f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    )


def _all_name_checks(rng, n_users, n_groups, n_folders, n_docs, n=40):
    """Checks over every name of FEATURES (10 distinct slots)."""
    targets = {
        "member": "group", "admin": "group", "parent": "folder",
        "owner": "folder", "view": "folder", "folder": "doc",
        "reader": "doc", "banned": "doc", "read": "doc", "audit": "doc",
    }
    size = {"group": n_groups, "folder": n_folders, "doc": n_docs}
    pre = {"group": "g", "folder": "f", "doc": "d"}
    out = []
    for i in range(n):
        name = FEATURE_NAMES[i % len(FEATURE_NAMES)]
        t = targets[name]
        res = f"{t}:{pre[t]}{rng.randrange(size[t])}"
        if name == "parent":
            subj = f"folder:f{rng.randrange(n_folders)}"
        elif name == "folder":
            subj = f"folder:f{rng.randrange(n_folders)}"
        else:
            subj = f"user:u{rng.randrange(n_users + 1)}"
        q = jrel.must_from_triple(res, name, subj)
        if name in ("reader", "read") and rng.random() < 0.5:
            q = q.with_caveat("", {"t": rng.randint(0, 10)})
        out.append(q)
    out.append(jrel.must_from_tuple("doc:d0#read", "group:g1#member"))
    return out


class World:
    """One world in both packages, prepared by both engines."""

    def __init__(self, rels, checks, schema=FEATURES, **cfg):
        self.rels, self.checks = rels, checks
        self.j_cs = j_compile(j_parse(schema))
        self.p_cs = p_compile(p_parse(schema))
        self.j_int, self.p_int = JInterner(), PInterner()
        self.j_snap = j_build(1, self.j_cs, self.j_int, rels, epoch_us=NOW)
        self.p_snap = p_build(1, self.p_cs, self.p_int,
                              [_port_rel(r) for r in rels], epoch_us=NOW)
        self.je = JEngine(self.j_cs, JConfig.for_schema(
            self.j_cs, pallas=False, spmm=False, **cfg))
        self.pe = PEngine(self.p_cs, PConfig.for_schema(self.p_cs, **cfg),
                          device="cpu")
        self.jd = self.je.prepare(self.j_snap)
        self.pd = self.pe.prepare(self.p_snap)

    def ref_planes(self, jd=None):
        jd = jd or self.jd
        return [np.asarray(x) for x in
                self.je.check_batch(jd, self.checks, now_us=NOW)]

    def port_planes(self, pd=None):
        pd = pd or self.pd
        return [np.asarray(x) for x in self.pe.check_batch(
            pd, [_port_rel(c) for c in self.checks], now_us=NOW)]

    def port_on_reference_tables(self):
        """The port's program over the reference's raw columns."""
        assert self.jd.flat_meta is None
        pd = self.pe.snapshot_from_reference(
            self.p_snap, {k: np.asarray(v) for k, v in self.jd.arrays.items()},
            None, self.jd.strings)
        return self.port_planes(pd)

    def oracle(self, snap=None):
        progs = {n: j_compile_cel(n, d.params, d.expression)
                 for n, d in self.j_cs.schema.caveats.items()}
        return JSnapshotOracle(snap or self.j_snap, progs, now_us=NOW)


def _same(ref, got, what=""):
    for nm, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), (
            f"{what} plane {nm}: rows {np.nonzero(a != b)[0][:12]}")


def _definite_rows_agree(w, planes, snap=None, checks=None):
    """Rows the program settles itself agree with the host oracle."""
    oracle = w.oracle(snap)
    d, p, ovf = planes
    for i, c in enumerate(checks or w.checks):
        if ovf[i] or (p[i] and not d[i]):
            continue
        assert bool(d[i]) == (oracle.check_relationship(c) == T), c


# ---------------------------------------------------------------------------
# the program's pieces against their sequential definitions
# ---------------------------------------------------------------------------


def _scan_assign(nodes, count, cands, N):
    """The reference's ``lax.scan(assign, ...)``, one candidate at a time."""
    nodes = list(nodes)
    slots, ovf = [], False
    for c in cands:
        valid = c >= 0
        found = valid and c in nodes
        if not valid:
            slots.append(-1)
            continue
        if found:
            slots.append(nodes.index(c))
            continue
        if count < N:
            nodes[count] = c
            slots.append(count)
            count += 1
        else:
            slots.append(-1)
            ovf = True
    return slots, nodes, count, ovf


@pytest.mark.parametrize("seed", range(6))
def test_assign_matches_the_sequential_scan(seed):
    rng = np.random.default_rng(seed)
    N, M, Bq = 5, 24, 64
    nodes = np.full((Bq, N), -1, np.int32)
    count = rng.integers(0, N + 1, Bq)
    for b in range(Bq):
        nodes[b, :count[b]] = rng.choice(40, count[b], replace=False)
    cands = rng.integers(-3, 12 + 6 * seed, (Bq, M)).astype(np.int32)
    slot, got_nodes, got_count, ovf = L.LegacyProgram._assign(
        torch.from_numpy(nodes), torch.from_numpy(count),
        torch.from_numpy(cands), N)
    for b in range(Bq):
        s, n, c, o = _scan_assign(nodes[b].tolist(), int(count[b]),
                                  cands[b].tolist(), N)
        assert slot[b].tolist() == s
        assert got_nodes[b].tolist() == n
        assert int(got_count[b]) == c and bool(ovf[b]) == o


def _bisect(cols, q, side):
    """The reference's ``_lex_search`` for one query row."""
    n = len(cols[0])
    lo, hi = 0, n
    for _ in range(max(1, (n - 1).bit_length() + 1)):
        if lo >= hi:
            break
        mid = min((lo + hi) // 2, n - 1)
        row = tuple(c[mid] for c in cols)
        go = row < tuple(q) or (side == "right" and row == tuple(q))
        lo, hi = (mid + 1, hi) if go else (lo, mid)
    return lo


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n", [8, 13, 64])
def test_lex_search_and_pack2_match_the_bisect(side, n):
    rng = np.random.default_rng(n)
    rows = sorted({tuple(int(x) for x in rng.integers(-2, 5, 4)) for _ in range(n)})
    rows += [(L.I32_MAX,) * 4] * (n - len(rows) + 3)
    cols = [np.array([r[i] for r in rows], np.int32) for i in range(4)]
    qs = rng.integers(-3, 6, (50, 4)).astype(np.int32)
    qs[:5] = L.I32_MAX
    t = [torch.from_numpy(c) for c in cols]
    hi, lo = L.pack2(t[0], t[1]), L.pack2(t[2], t[3])
    qt = torch.from_numpy(qs)
    got = L.lex_search((hi, lo), (L.pack2(qt[:, 0], qt[:, 1]),
                                  L.pack2(qt[:, 2], qt[:, 3])), side)
    got2 = torch.searchsorted(hi, L.pack2(qt[:, 0], qt[:, 1]), side=side)
    for i, q in enumerate(qs.tolist()):
        assert int(got[i]) == _bisect(cols, q, side)
        assert int(got2[i]) == _bisect(cols[:2], q[:2], side)


@pytest.mark.parametrize("C", [3, 8, 40])
def test_dedup_truncate_matches_the_two_key_sort(C):
    rng = np.random.default_rng(C)
    n = rng.integers(-1, 6, (7, 30)).astype(np.int32)
    r = rng.integers(0, 4, (7, 30)).astype(np.int32)
    n[rng.random((7, 30)) < 0.3] = L.I32_MAX
    keys, ovf = L.dedup_truncate(L.pack2(torch.from_numpy(n), torch.from_numpy(r)), C)
    for b in range(7):
        pairs = sorted({(a, c) for a, c in zip(n[b].tolist(), r[b].tolist())
                        if a < L.I32_MAX})
        want = pairs[:C] + [(L.I32_MAX, L.I32_MAX)] * (C - min(C, len(pairs)))
        got = [(int(k) // 2**32, int(k) % 2**32 - 2**31) for k in keys[b]]
        assert got == want and bool(ovf[b]) == (len(pairs) > C)


# ---------------------------------------------------------------------------
# EngineConfig.for_schema
# ---------------------------------------------------------------------------

SMOKE_SCHEMAS = sorted(k for k in vars(chip_smoke) if k.endswith("_SCHEMA"))


@pytest.mark.parametrize("name", SMOKE_SCHEMAS + ["FEATURES"])
def test_for_schema_matches_reference(name):
    text = FEATURES if name == "FEATURES" else getattr(chip_smoke, name)
    ref = JConfig.for_schema(j_compile(j_parse(text)))
    got = PConfig.for_schema(p_compile(p_parse(text)))
    # flat_aligned is the one field whose default differs by design (the
    # reference's None turns it on on a TPU backend; the port's is off)
    fields = [f.name for f in dataclasses.fields(PConfig)
              if hasattr(ref, f.name) and f.name != "flat_aligned"]
    assert {f: getattr(got, f) for f in fields} == {
        f: getattr(ref, f) for f in fields}
    assert PEngine(p_compile(p_parse(text)), device="cpu").config == got


# ---------------------------------------------------------------------------
# planes against the reference's legacy program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_use_flat_false_planes_match_reference(seed):
    """Randomised feature worlds (nested groups, wildcards, expiry,
    exclusion, intersection, caveats with request contexts) on
    ``use_flat=False`` engines: no flat tables, every batch legacy."""
    rng = random.Random(seed)
    rels = build_feature_world(rng, n_users=12, n_groups=6, n_folders=8, n_docs=12)
    checks = make_checks(rng, 12, 12, n=60)
    w = World(rels, checks, use_flat=False)
    assert w.pd.flat_meta is None and w.pd.specs == {}
    before = metrics.default.counter("checks.legacy")
    ref = w.ref_planes()
    _same(ref, w.port_planes(), "own tables")
    _same(ref, w.port_on_reference_tables(), "reference tables")
    assert metrics.default.counter("checks.legacy") >= before + 2
    _definite_rows_agree(w, ref)
    # the columnar entry over the same lowered queries
    q, _u, _qctx = w.je._lower_queries(w.j_snap, checks, w.jd.strings)
    plain = [i for i, c in enumerate(checks) if not c.caveat_context]
    cols = [q[k][plain] for k in ("q_res", "q_perm", "q_subj", "q_srel", "q_wc")]
    want = w.je.check_columns(w.jd, *cols[:3], q_srel=cols[3], q_wc=cols[4],
                              now_us=NOW)
    got = w.pe.check_columns(w.pd, *cols[:3], q_srel=cols[3], q_wc=cols[4],
                             now_us=NOW)
    _same([np.asarray(x) for x in want], got, "check_columns")
