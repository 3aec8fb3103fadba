"""The port's Client against the reference's ``new_tpu_evaluator`` and the
host oracle, plus the port's boundaries: no JAX and no reference imports,
a CUDA default that raises without a card, and NotImplementedError for
what later slices port (a caveated schema is no longer one of them)."""

import ast
import datetime as dt
import os
import random

import pytest
import torch

import gochugaru_tpu.client as jclient
from gochugaru_tpu import consistency as jcons, rel as jrel
from gochugaru_tpu.engine.oracle import Oracle, T
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.utils.context import background as j_background

import gochugaru_tpu_torch
from gochugaru_tpu_torch import consistency as pcons, rel as prel
from gochugaru_tpu_torch.client import new_evaluator, with_engine_config
from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig
from gochugaru_tpu_torch.schema import compile_schema, parse_schema
from gochugaru_tpu_torch.utils.context import background

NOW_S = 1_700_000_000

SCHEMA = """
definition user {}
definition team {
    relation member: user | team#member
}
definition org {
    relation admin: user
    relation member: user | team#member
}
definition repo {
    relation org: org
    relation maintainer: user | team#member
    relation reader: user | user:*
    relation banned: user
    permission admin = org->admin + maintainer
    permission read = (reader + admin + org->member) - banned
}
"""


def _triples(seed, n_repos=24):
    rng = random.Random(seed)
    users = [f"user:u{i}" for i in range(30)]
    out = []
    for t in range(5):
        for u in rng.sample(users, 5):
            out.append((f"team:t{t}", "member", u, None))
    out.append(("team:t0", "member", "team:t1#member", None))
    for o in range(3):
        out.append((f"org:o{o}", "admin", rng.choice(users), None))
        out.append((f"org:o{o}", "member", f"team:t{rng.randrange(5)}#member", None))
    for r in range(n_repos):
        out.append((f"repo:r{r}", "org", f"org:o{rng.randrange(3)}", None))
        out.append((f"repo:r{r}", "maintainer", f"team:t{rng.randrange(5)}#member", None))
        for u in rng.sample(users, 2):
            # a few readers expire: one in the past, one far ahead
            exp = rng.choice([None, None, NOW_S - 3600, NOW_S + 10**8])
            out.append((f"repo:r{r}", "reader", u, exp))
        if r % 5 == 0:
            out.append((f"repo:r{r}", "banned", rng.choice(users), None))
    out.append(("repo:r3", "reader", "user:*", None))
    return out


def _rels(mod, triples):
    rels = []
    for res, relname, subj, exp in triples:
        r = mod.must_from_triple(res, relname, subj)
        if exp is not None:
            r = mod.Relationship(**{
                **r.__dict__,
                "expiration": dt.datetime.fromtimestamp(exp, tz=dt.timezone.utc),
            })
        rels.append(r)
    return rels


def _checks(mod, seed, n=120):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        subj = (f"team:t{rng.randrange(5)}#member" if rng.random() < 0.1
                else f"user:u{rng.randrange(30)}")
        out.append(mod.must_from_triple(
            f"repo:r{rng.randrange(26)}", rng.choice(["read", "admin", "reader"]),
            subj))
    return out


def _write_all(client, mod, ctx, triples, half):
    rels = _rels(mod, triples)
    client.write_schema(ctx, SCHEMA)
    txn = mod.Txn()
    for r in rels[:half]:
        txn.create(r)
    rev1 = client.write(ctx, txn)
    client.import_relationships(ctx, rels[half:])
    txn = mod.Txn()
    txn.touch(rels[0])
    rev2 = client.write(ctx, txn)
    return rev1, rev2


@pytest.fixture(scope="module")
def clients():
    triples = _triples(3)
    half = len(triples) // 2
    pc = new_evaluator(device="cpu")
    jc = jclient.new_tpu_evaluator()
    p_revs = _write_all(pc, prel, background(), triples, half)
    j_revs = _write_all(jc, jrel, j_background(), triples, half)
    assert p_revs == j_revs
    oracle = Oracle(j_compile(j_parse(SCHEMA)), _rels(jrel, triples))
    return pc, jc, p_revs, oracle


@pytest.mark.parametrize("strategy", ["full", "at_least", "min_latency", "snapshot"])
def test_verdicts_match_reference_client_and_oracle(clients, strategy):
    pc, jc, (rev1, rev2), oracle = clients
    p_cs = {"full": pcons.full(), "at_least": pcons.at_least(rev2),
            "min_latency": pcons.min_latency(), "snapshot": pcons.snapshot(rev2)}[strategy]
    j_cs = {"full": jcons.full(), "at_least": jcons.at_least(rev2),
            "min_latency": jcons.min_latency(), "snapshot": jcons.snapshot(rev2)}[strategy]
    p_checks, j_checks = _checks(prel, 9), _checks(jrel, 9)
    got = pc.check(background(), p_cs, *p_checks)
    ref = jc.check(j_background(), j_cs, *j_checks)
    want = [oracle.check_relationship(r) == T for r in j_checks]
    assert got == ref == want
    assert any(got) and not all(got)


def test_check_one_all_any(clients):
    pc, _jc, _revs, oracle = clients
    ctx = background()
    checks = _checks(prel, 21, n=12)
    want = [oracle.check_relationship(r) == T for r in _checks(jrel, 21, n=12)]
    assert pc.check_one(ctx, pcons.full(), checks[0]) == want[0]
    assert pc.check_all(ctx, pcons.full(), *checks) == all(want)
    assert pc.check_any(ctx, pcons.full(), *checks) == any(want)
    assert pc.read_schema(ctx)[0].strip() == SCHEMA.strip()


def test_expired_reader_denied_and_wildcard_granted(clients):
    pc, _jc, _revs, _oracle = clients
    ctx = background()
    expired = [t for t in _triples(3) if t[3] == NOW_S - 3600]
    assert expired
    res, relname, subj, _ = expired[0]
    assert not pc.check_one(ctx, pcons.full(), prel.must_from_triple(res, relname, subj))
    assert pc.check_one(ctx, pcons.full(), prel.must_from_triple("repo:r3", "reader", "user:u29"))


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------


def _port_sources():
    root = os.path.dirname(gochugaru_tpu_torch.__file__)
    for dp, _dn, fn in os.walk(root):
        for f in fn:
            if f.endswith(".py"):
                yield os.path.join(dp, f)
    yield os.path.join(os.path.dirname(root), "chip_smoke.py")


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "gochugaru_tpu"):
                    bad.append(f"{path}:{node.lineno} {n}")
    assert not bad, bad


def test_default_device_raises_without_cuda():
    cs = compile_schema(parse_schema(SCHEMA))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError):
        DeviceEngine(cs)
    with pytest.raises(RuntimeError):
        new_evaluator()
    with pytest.raises(RuntimeError):
        DeviceEngine(cs, EngineConfig(kernels=True), device="cpu")


def test_later_slices_raise_not_implemented():
    # a caveated schema is served since the CEL VM slice: it builds,
    # prepares and answers (tests/test_torch_caveats.py holds its planes
    # to the reference's)
    caveated = compile_schema(parse_schema("""
        caveat on_tuesday(day string) { day == "tuesday" }
        definition user {}
        definition doc { relation reader: user with on_tuesday }
    """))
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot

    eng = DeviceEngine(caveated, device="cpu")
    assert not eng.caveat_plan.host_only[caveated.caveat_ids["on_tuesday"]]
    snap = build_snapshot(1, caveated, Interner(), [
        prel.must_from_triple("doc:d1", "reader", "user:u1").with_caveat(
            "on_tuesday", {})], epoch_us=NOW_S * 10**6)
    ds = eng.prepare(snap)
    checks = [prel.must_from_triple("doc:d1", "reader", "user:u1").with_caveat(
        "", {"day": day}) for day in ("tuesday", "friday")]
    checks.append(prel.must_from_triple("doc:d1", "reader", "user:u1"))
    d, p, ovf = eng.check_batch(ds, checks, now_us=NOW_S * 10**6)
    assert d.tolist() == [True, False, False]
    assert p.tolist() == [True, False, True] and not ovf.any()
    # the scattered layout is served since its slice: it builds and
    # answers as the blockslice engine does (tests/test_torch_scattered.py
    # holds its planes to the reference's)
    cs = compile_schema(parse_schema(SCHEMA))
    snap = build_snapshot(1, cs, Interner(), _rels(prel, _triples(3)),
                          epoch_us=NOW_S * 10**6)
    checks = _checks(prel, 9)
    planes = {}
    for bs in (True, False):
        eng = DeviceEngine(cs, EngineConfig(flat_blockslice=bs), device="cpu")
        ds = eng.prepare(snap)
        assert ds.flat_meta.blockslice == bs
        planes[bs] = eng.check_batch(ds, checks, now_us=NOW_S * 10**6)
    for a, b in zip(planes[True], planes[False]):
        assert a.tolist() == b.tolist()
    assert planes[False][0].any() and not planes[False][0].all()


def test_batch_wider_than_flat_max_slots_raises(clients):
    """A batch with more distinct permissions than ``flat_max_slots`` no
    longer raises: it runs on the legacy two-phase program, as the
    reference's does, and answers as the reference client does."""
    from gochugaru_tpu_torch.utils import metrics

    pc, jc, _revs, _oracle = clients
    pc2 = new_evaluator(with_engine_config(EngineConfig(flat_max_slots=1)),
                        device="cpu", )
    pc2._store = pc.store
    checks = [("repo:r1", p, f"user:u{u}") for p in ("read", "admin")
              for u in range(6)]
    before = metrics.default.counter("checks.legacy")
    got = pc2.check(background(), pcons.full(),
                    *[prel.must_from_triple(*t) for t in checks])
    assert metrics.default.counter("checks.legacy") > before
    assert got == jc.check(j_background(), jcons.full(),
                           *[jrel.must_from_triple(*t) for t in checks])


def test_write_then_check_takes_the_delta_path():
    """Client.write → check at the new revision: the port's engine
    prepares it with ``prev=`` (the previous revision's snapshot from the
    client's LRU), so the snapshot carries a delta level, and its
    verdicts equal the reference client's on the same writes."""
    from gochugaru_tpu_torch.store.store import parse_revision

    triples = _triples(5)
    pc = new_evaluator(device="cpu")
    jc = jclient.new_tpu_evaluator()
    p_ctx, j_ctx = background(), j_background()
    _write_all(pc, prel, p_ctx, triples, len(triples) // 2)
    _write_all(jc, jrel, j_ctx, triples, len(triples) // 2)
    p_checks, j_checks = _checks(prel, 13), _checks(jrel, 13)
    assert (pc.check(p_ctx, pcons.full(), *p_checks)
            == jc.check(j_ctx, jcons.full(), *j_checks))
    writes = [
        ([("repo:r1", "reader", "user:u29", None)], []),
        ([("repo:r2", "maintainer", "team:t3#member", None),
          ("team:t2", "member", "user:u28", None)],
         [("repo:r3", "reader", "user:*", None)]),
        ([("repo:r4", "banned", "user:u28", None)], []),
    ]
    for adds, deletes in writes:
        revs = []
        for client, mod, ctx in ((pc, prel, p_ctx), (jc, jrel, j_ctx)):
            txn = mod.Txn()
            for r in _rels(mod, adds):
                txn.touch(r)
            for r in _rels(mod, deletes):
                txn.delete(r)
            revs.append(client.write(ctx, txn))
        p_rev, j_rev = revs
        assert p_rev == j_rev
        extra = [("repo:r1", "read", "user:u29"), ("repo:r2", "read", "user:u28"),
                 ("repo:r3", "read", "user:u0"), ("repo:r4", "read", "user:u28")]
        got = pc.check(p_ctx, pcons.at_least(p_rev), *p_checks,
                       *[prel.must_from_triple(*t) for t in extra])
        ref = jc.check(j_ctx, jcons.at_least(j_rev), *j_checks,
                       *[jrel.must_from_triple(*t) for t in extra])
        assert got == ref
        ds = pc._dsnap_cache[parse_revision(p_rev)]
        assert ds.flat_meta.delta is not None and ds.delta_acc is not None
        assert jc._dsnap_cache[parse_revision(j_rev)].flat_meta.delta is not None
