"""The port's remaining host-side client names against the reference's:
``with_store`` (one store between a writer and checkers),
``with_host_only_evaluation`` (every check and lookup on the host oracle,
no engine, no device) and the reference's constructors with their Go
aliases.

The same seeded world (tests/test_torch_explain_cuda.py) goes through the
reference (JAX on the CPU, as its own tests run it) and the port on
``cpu``.  Verdicts are bools and lookup answers id lists: the tolerance is
exact equality.
"""

import pytest

from gochugaru_tpu import consistency as jcons
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import (
    new_tpu_evaluator as j_new, with_host_only_evaluation as j_host_only,
    with_store as j_with_store,
)
from gochugaru_tpu.store.store import Store as JStore
from gochugaru_tpu.utils.context import background as j_background

import gochugaru_tpu_torch as P
from gochugaru_tpu_torch import client as pclient
from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.engine import kernels as pK
from gochugaru_tpu_torch.store.store import Store as PStore
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils.context import background as p_background
from test_torch_explain_cuda import SCHEMA, _world_checks, _world_txn

#: (rel, consistency, new, with_store, host-only option, Store, background,
#: extra constructor kwargs)
PKG = {
    "reference": (jrel, jcons, j_new, j_with_store, j_host_only, JStore,
                  j_background, {}),
    "port": (prel, pcons, pclient.new_evaluator, pclient.with_store,
             pclient.with_host_only_evaluation, PStore, p_background,
             {"device": "cpu"}),
}


def _lookups(c, cons, ctx):
    """Every lookup shape of the world: resources of four users, subjects
    of four docs, and a resources walk in pages of three."""
    cs = cons.full()
    res = {u: sorted(c.lookup_resources(ctx, cs, "doc#read", f"user:u{u}"))
           for u in (0, 3, 7, 11)}
    subj = {d: sorted(c.lookup_subjects(ctx, cs, f"doc:d{d}", "read", "user"))
            for d in (0, 1, 5, 9)}
    pages, cur = [], None
    while True:
        page = c.lookup_resources_page(ctx, cs, "folder#view", "user:u3",
                                       page_size=3, cursor=cur)
        pages.extend(page.ids)
        cur = page.cursor
        if cur is None:
            break
    sub_pages, cur = [], None
    while True:
        page = c.lookup_subjects_page(ctx, cs, "doc:d2", "read", "user",
                                      page_size=4, cursor=cur)
        sub_pages.extend(page.ids)
        cur = page.cursor
        if cur is None:
            break
    return res, subj, sorted(pages), sorted(sub_pages)


@pytest.mark.parametrize("seed", [7, 19])
def test_with_store_writer_and_checker(seed):
    """A writer client and a checker client over one store: the checker
    sees every write (no write of its own), as the reference's pair
    does; a host-only checker on the same store agrees."""
    out = {}
    for pkg in PKG:
        rel, cons, new, with_store, host_only, Store, bg, kw = PKG[pkg]
        store = Store()
        writer = new(with_store(store), **kw)
        checker = new(with_store(store), **kw)
        oracle = new(with_store(store), host_only(), **kw)
        assert writer.store is store and checker.store is store
        ctx = bg()
        writer.write_schema(ctx, SCHEMA)
        txn, rng = _world_txn(rel, seed)
        writer.write(ctx, txn)
        checks = _world_checks(rel, rng, 40)
        got = checker.check(ctx, cons.full(), *checks)
        assert oracle.check(ctx, cons.full(), *checks) == got
        # a second write through the writer moves the checker's answers
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:d0", "reader", "user:u23"))
        rev = writer.write(ctx, txn)
        late = checker.check_one(ctx, cons.at_least(rev), rel.must_from_triple(
            "doc:d0", "reader", "user:u23"))
        assert late
        out[pkg] = (got, _lookups(checker, cons, ctx))
    assert out["port"] == out["reference"]


def test_host_only_equals_engine_and_reference(monkeypatch):
    """A host-only client answers checks, ``explain``, lookups and pages
    as the port's engine client and the reference's host-only client do,
    builds no DeviceEngine, resolves no device and launches nothing,
    also under the latency mode, the verdict cache and a serving
    handle."""
    out = {}
    for pkg, opts in (("reference", "host"), ("port", "host"),
                      ("port", "engine")):
        rel, cons, new, _ws, host_only, _S, bg, kw = PKG[pkg]
        if pkg == "port" and opts == "host":
            def no_engine(*a, **k):
                raise AssertionError("a host-only client built an engine")

            monkeypatch.setattr(pclient, "DeviceEngine", no_engine)
            c = new(host_only(), pclient.with_latency_mode(),
                    pclient.with_verdict_cache(), device="cuda")
            assert c.device is None
        else:
            monkeypatch.undo()
            c = new(*((host_only(),) if opts == "host" else ()), **kw)
        ctx = bg()
        c.write_schema(ctx, SCHEMA)
        txn, rng = _world_txn(rel, 31)
        c.write(ctx, txn)
        checks = _world_checks(rel, rng, 40)
        pK.reset_launches()
        verdicts = c.check(ctx, cons.full(), *checks)
        cached = c.check(ctx, cons.min_latency(), *checks)
        assert cached == verdicts
        explained = c.check(ctx, cons.full(), *checks[:10], explain=True)
        assert [e.allowed for e in explained] == verdicts[:10]
        with c.with_serving(cs=cons.full()) as h:
            assert h.check(bg(), *checks) == verdicts
        out[(pkg, opts)] = (verdicts, _lookups(c, cons, ctx))
        if pkg == "port" and opts == "host":
            assert c._engine is None
            assert not any(pK.LAUNCHES.values())
            assert pmetrics.default.counter("checks.oracle") > 0
            assert all("witness" not in e.explanation for e in explained)
    assert out[("port", "host")] == out[("reference", "host")]
    assert out[("port", "host")] == out[("port", "engine")]


CONSTRUCTORS = ["new_evaluator", "new_tpu_evaluator", "new_with_opts",
                "new_plaintext", "new_system_tls", "NewTPUEvaluator",
                "NewWithOpts", "NewPlaintext", "NewSystemTLS"]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructors_and_aliases(name):
    """Every constructor of the reference, and its Go alias, exists in the
    port (the package exports the snake_case names), takes options and
    ``device=``, and returns a working port Client."""
    ctor = getattr(pclient, name)
    if not name.startswith("New"):
        assert getattr(P, name) is ctor
    args = ("127.0.0.1:50051", "key") if "plaintext" in name.lower() or (
        "tls" in name.lower()) else ()
    c = ctor(*args, pclient.with_overlap_required(), device="cpu")
    assert isinstance(c, P.Client)
    ctx = pcons.with_overlap_key(p_background(), "k")
    c.write_schema(ctx, SCHEMA)
    txn = prel.Txn()
    txn.touch(prel.must_from_triple("doc:x", "reader", "user:u"))
    c.write(ctx, txn)
    assert c.check_one(ctx, pcons.full(),
                       prel.must_from_triple("doc:x", "read", "user:u"))
    with pytest.raises(P.client.OverlapKeyMissingError):
        c.check_one(p_background(), pcons.full(),
                    prel.must_from_triple("doc:x", "read", "user:u"))
