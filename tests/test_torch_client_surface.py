"""The port Client's read, delete, Watch, export/import, check_iter and
overlap-guard surface against the reference Client's.

Both clients run the same writes on the CPU, and every call must return
what the reference's returns: the same relationships (compared by their
canonical strings, in order where the reference orders them), the same
revisions, the same update streams, the same errors.  The cases follow
``tests/test_client.py``, ``tests/test_columnar_client.py`` and
``tests/test_import_columns.py``.
"""

import threading
import time

import numpy as np
import pytest

import gochugaru_tpu.client as jclient
from gochugaru_tpu import consistency as jcons, rel as jrel
from gochugaru_tpu.utils import faults as jfaults, metrics as jmetrics
from gochugaru_tpu.utils.context import background as j_background
from gochugaru_tpu.utils.errors import (
    OverlapKeyMissingError as JOverlapKeyMissingError,
    PartialDeletionError as JPartialDeletionError,
)

import gochugaru_tpu_torch.client as pclient
from gochugaru_tpu_torch import consistency as pcons, rel as prel
from gochugaru_tpu_torch.store.store import parse_revision
from gochugaru_tpu_torch.utils import faults as pfaults, metrics as pmetrics
from gochugaru_tpu_torch.utils.context import background as p_background
from gochugaru_tpu_torch.utils.errors import (
    OverlapKeyMissingError, PartialDeletionError,
)

SCHEMA = """
definition user {}
definition team { relation member: user | team#member }
definition doc {
    relation writer: user
    relation reader: user | user:* | team#member
    relation banned: user
    permission edit = writer
    permission view = (reader + edit) - banned
}
definition folder { relation viewer: user }
"""


class Side:
    """One client with its package's modules."""

    def __init__(self, mod, cons, ctx, client, faults, metrics):
        self.mod, self.cons, self.ctx, self.c = mod, cons, ctx, client
        self.faults, self.metrics = faults, metrics


def _sides(*opts_names):
    """A (port, reference) pair of fresh clients with SCHEMA written."""
    p_opts = [getattr(pclient, n)() for n in opts_names]
    j_opts = [getattr(jclient, n)() for n in opts_names]
    p = Side(prel, pcons, p_background(),
             pclient.new_evaluator(*p_opts, device="cpu"), pfaults, pmetrics)
    j = Side(jrel, jcons, j_background(),
             jclient.new_tpu_evaluator(*j_opts), jfaults, jmetrics)
    for s in (p, j):
        s.c.write_schema(s.ctx, SCHEMA)
    return p, j


def _triples():
    out = []
    for t in range(3):
        for u in range(t, 9, 3):
            out.append((f"team:t{t}", "member", f"user:u{u}"))
    out.append(("team:t0", "member", "team:t1#member"))
    for d in range(12):
        out.append((f"doc:d{d}", "reader", f"user:u{d % 7}"))
        out.append((f"doc:d{d}", "writer", f"user:u{(d + 3) % 9}"))
        if d % 4 == 0:
            out.append((f"doc:d{d}", "reader", f"team:t{d % 3}#member"))
        if d % 5 == 0:
            out.append((f"doc:d{d}", "banned", f"user:u{d % 9}"))
    out.append(("doc:d11", "reader", "user:*"))
    out += [(f"folder:f{f}", "viewer", f"user:u{f}") for f in range(4)]
    return out


def _write(s, triples, touch=False):
    txn = s.mod.Txn()
    for t in triples:
        r = s.mod.must_from_triple(*t)
        (txn.touch if touch else txn.create)(r)
    return s.c.write(s.ctx, txn)


def _both(p, j, fn):
    """``fn(side)`` on both sides."""
    return fn(p), fn(j)


def _strs(rs):
    return [str(r) for r in rs]


def _checks(mod, n=48):
    out = []
    for i in range(n):
        perm = ("view", "edit", "reader", "banned")[i % 4]
        out.append(mod.must_from_triple(f"doc:d{i % 13}", perm, f"user:u{i % 10}"))
    return out


@pytest.fixture()
def loaded():
    p, j = _sides()
    revs = _both(p, j, lambda s: _write(s, _triples()))
    assert revs[0] == revs[1]
    return p, j


FILTERS = [
    ("doc", "", "", None),
    ("doc", "d4", "", None),
    ("doc", "", "reader", None),
    ("doc", "", "reader", ("team", "", "member")),
    ("team", "", "", ("user", "u3", "")),
    ("folder", "", "viewer", ("user", "", "")),
    ("doc", "d11", "reader", ("user", "*", "")),
]


def _filter(mod, spec):
    rt, rid, rl, sf = spec
    f = mod.new_filter(rt, rid, rl)
    if sf is not None:
        f = f.with_subject_filter(*sf)
    return f


@pytest.mark.parametrize("spec", FILTERS, ids=lambda s: "-".join(
    x if isinstance(x, str) else "+".join(x) for x in s if x))
def test_read_relationships_per_filter(loaded, spec):
    p, j = loaded
    got, want = _both(p, j, lambda s: _strs(s.c.read_relationships(
        s.ctx, s.cons.full(), _filter(s.mod, spec))))
    assert got == want and got
    # the same rows as the export at head, filtered
    rev = p.c.read_schema(p.ctx)[1]
    p.c.check(p.ctx, p.cons.full(), *_checks(p.mod, 4))
    f = _filter(p.mod, spec)
    exported = [r for r in p.c.export_relationships(p.ctx, rev) if f.matches(r)]
    assert sorted(_strs(exported)) == sorted(got)


def test_delete_atomic_and_delete(loaded):
    p, j = loaded
    # a PreconditionedFilter, then a bare Filter (wrapped like the reference)
    revs = _both(p, j, lambda s: s.c.delete_atomic(s.ctx, s.mod.new_preconditioned_filter(
        s.mod.new_filter("doc", "d0", ""))))
    assert revs[0] == revs[1]
    revs = _both(p, j, lambda s: s.c.delete_atomic(
        s.ctx, s.mod.new_filter("doc", "", "banned")))
    assert revs[0] == revs[1]
    got, want = _both(p, j, lambda s: _strs(s.c.read_relationships(
        s.ctx, s.cons.full(), s.mod.new_filter("doc", "", ""))))
    assert got == want and not any("d0#" in x or "#banned" in x for x in got)
    # a failed precondition deletes nothing, on both
    for s in (p, j):
        pf = s.mod.new_preconditioned_filter(s.mod.new_filter("doc", "d1", ""))
        pf.must_match(s.mod.new_filter("doc", "nope", ""))
        with pytest.raises(Exception) as e:
            s.c.delete_atomic(s.ctx, pf)
        assert type(e.value).__name__ == "PreconditionFailedError"
    # batched delete of everything matching
    _both(p, j, lambda s: s.c.delete(s.ctx, s.mod.new_filter("doc", "", "reader")))
    got, want = _both(p, j, lambda s: _strs(s.c.read_relationships(
        s.ctx, s.cons.full(), s.mod.new_filter("doc", "", ""))))
    assert got == want and not any("#reader@" in x for x in got)
    for s in (p, j):
        with pytest.raises(TypeError):
            s.c.delete_atomic(s.ctx, "doc:d1")
    assert p.c.check(p.ctx, p.cons.full(), *_checks(p.mod)) == j.c.check(
        j.ctx, j.cons.full(), *_checks(j.mod))


def test_partial_deletion_raises(loaded, monkeypatch):
    """A store that reports an incomplete delete makes delete_atomic raise
    PartialDeletionError on both clients."""
    p, j = loaded
    for s, err in ((p, PartialDeletionError), (j, JPartialDeletionError)):
        store = s.c.store
        monkeypatch.setattr(store, "delete_by_filter",
                            lambda pf, limit=0: ("gtz1.99", False))
        with pytest.raises(err):
            s.c.delete_atomic(s.ctx, s.mod.new_filter("doc", "d1", ""))


def test_delete_then_check_takes_the_delta_path(loaded):
    """After a delete, the next check prepares the new revision
    incrementally from the cached one, and answers as the reference."""
    p, j = loaded
    _both(p, j, lambda s: s.c.check(s.ctx, s.cons.full(), *_checks(s.mod)))
    revs = _both(p, j, lambda s: s.c.delete_atomic(
        s.ctx, s.mod.new_filter("doc", "d2", "")))
    got, want = _both(p, j, lambda s: s.c.check(
        s.ctx, s.cons.at_least(revs[0]), *_checks(s.mod)))
    assert got == want
    ds = p.c._dsnap_cache[parse_revision(revs[0])]
    assert ds.flat_meta.delta is not None and ds.delta_acc is not None
    _both(p, j, lambda s: s.c.delete(s.ctx, s.mod.new_filter("team", "t1", "")))
    got, want = _both(p, j, lambda s: s.c.check(
        s.ctx, s.cons.full(), *_checks(s.mod)))
    assert got == want


def _stream(s, f, rev, n):
    """The first ``n`` updates after ``rev`` (fewer if the stream goes
    quiet for 20 s: its context times out and ends it)."""
    out = []
    wctx = s.ctx.with_timeout(20)
    for u in s.c.updates_since_revision(wctx, f, rev):
        out.append((int(u.update_type), str(u.relationship)))
        if len(out) >= n:
            break
    wctx.cancel()
    return out


def _writes(s):
    """Three writes after the fixture's: a delete, touches, a create."""
    txn = s.mod.Txn()
    txn.delete(s.mod.must_from_triple("doc:d3", "reader", "user:u3"))
    txn.touch(s.mod.must_from_triple("folder:f9", "viewer", "user:u1"))
    s.c.write(s.ctx, txn)
    _write(s, [("doc:d3", "writer", "user:u8"), ("team:t2", "member", "user:u0")],
           touch=True)
    s.c.delete_atomic(s.ctx, s.mod.new_filter("doc", "d5", "writer"))
    _write(s, [("doc:d20", "reader", "user:u1")])


UPDATE_FILTERS = {
    "all": lambda m: m.UpdateFilter(),
    "object_types": lambda m: m.UpdateFilter(object_types=["doc"]),
    "relationship_filters": lambda m: m.UpdateFilter(relationship_filters=[
        m.new_filter("doc", "", "writer"), m.new_filter("folder", "", "")]),
}
UPDATE_COUNTS = {"all": 6, "object_types": 4, "relationship_filters": 3}


@pytest.mark.parametrize("name", list(UPDATE_FILTERS))
def test_updates_since_revision_streams(loaded, name):
    p, j = loaded
    rev0 = p.c.read_schema(p.ctx)[1]
    _both(p, j, _writes)
    got, want = _both(p, j, lambda s: _stream(
        s, UPDATE_FILTERS[name](s.mod), rev0, UPDATE_COUNTS[name]))
    assert got == want and len(got) == UPDATE_COUNTS[name]


def test_updates_filter_fields_are_mutually_exclusive(loaded):
    for s in loaded:
        f = s.mod.UpdateFilter(object_types=["doc"], relationship_filters=[
            s.mod.new_filter("doc", "", "")])
        with pytest.raises(ValueError):
            next(s.c.updates(s.ctx, f))


def test_updates_resume_exactly_once_on_stream_faults(loaded):
    """Armed ``watch.stream`` faults break the stream twice; it resumes
    from its cursor with nothing lost or repeated, and counts each
    resume in ``watch.resumes``."""
    p, j = loaded
    rev0 = p.c.read_schema(p.ctx)[1]
    _both(p, j, _writes)
    clean = _stream(p, UPDATE_FILTERS["all"](p.mod), rev0, 6)
    assert len(clean) == 6
    for s in (p, j):
        before = s.metrics.default.counter("watch.resumes")
        with s.faults.armed("watch.stream", times=2, after=1):
            got = _stream(s, UPDATE_FILTERS["all"](s.mod), rev0, 6)
        assert got == clean
        assert s.metrics.default.counter("watch.resumes") == before + 2


def test_updates_from_head_skips_history(loaded):
    """``updates`` subscribes at the head: only later writes arrive."""
    results = []
    for s in loaded:
        seen = []
        wctx = s.ctx.with_timeout(20)

        def consume(s=s, seen=seen, wctx=wctx):
            for u in s.c.updates(wctx, s.mod.UpdateFilter()):
                seen.append((int(u.update_type), str(u.relationship)))
                if len(seen) >= 2:
                    return

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.2)
        txn = s.mod.Txn()
        txn.delete(s.mod.must_from_triple("doc:d1", "reader", "user:u1"))
        s.c.write(s.ctx, txn)
        _write(s, [("doc:d30", "reader", "user:u2")], touch=True)
        t.join(timeout=10)
        assert not t.is_alive()
        wctx.cancel()
        assert list(s.c.updates(wctx, s.mod.UpdateFilter())) == []
        results.append(seen)
    assert results[0] == results[1] and len(results[0]) == 2


def test_export_import_relationships_round_trip(loaded):
    p, j = loaded
    rev = p.c.read_schema(p.ctx)[1]
    _both(p, j, lambda s: s.c.check(s.ctx, s.cons.full(), *_checks(s.mod, 4)))
    got, want = _both(p, j, lambda s: _strs(s.c.export_relationships(s.ctx, rev)))
    assert got == want
    fresh = pclient.new_evaluator(device="cpu")
    fresh.write_schema(p.ctx, SCHEMA)
    fresh.import_relationships(p.ctx, p.c.export_relationships(p.ctx, rev))
    fresh.import_relationships(p.ctx, iter(list(p.c.export_relationships(p.ctx, rev))))
    assert fresh.check(p.ctx, pcons.full(), *_checks(prel)) == j.c.check(
        j.ctx, jcons.full(), *_checks(jrel))


def test_column_export_import_round_trip():
    p, j = _sides()
    for s in (p, j):
        s.c.import_relationship_columns(
            s.ctx, resource_type="doc", resource_ids=[f"d{i}" for i in range(60)],
            resource_relation="reader", subject_type="user",
            subject_ids=[f"u{i % 7}" for i in range(60)])
        s.c.import_relationship_columns(
            s.ctx, resource_type="doc", resource_ids=["d1", "d2"],
            resource_relation="reader", subject_type="team",
            subject_ids=["t0", "t1"], subject_relation="member")
        # a re-import of existing rows touches them
        s.c.import_relationship_columns(
            s.ctx, resource_type="doc", resource_ids=["d1"],
            resource_relation="reader", subject_type="user", subject_ids=["u1"])
    rev = p.c.read_schema(p.ctx)[1]
    got, want = _both(p, j, lambda s: list(s.c.export_relationship_columns(s.ctx, rev)))
    assert got == want
    rows = sum(len(ch["resource_ids"]) for ch in got)
    assert rows == 62
    fresh = pclient.new_evaluator(device="cpu")
    fresh.write_schema(p.ctx, SCHEMA)
    # rows of a chunk may mix shapes: restore one shape a call
    shapes = {}
    for ch in got:
        for i in range(len(ch["resource_ids"])):
            key = (ch["resource_types"][i], ch["resource_relations"][i],
                   ch["subject_types"][i], ch["subject_relations"][i])
            ids = shapes.setdefault(key, ([], []))
            ids[0].append(ch["resource_ids"][i])
            ids[1].append(ch["subject_ids"][i])
    assert len(shapes) == 2
    for (rt, rl, st, sr), (rids, sids) in shapes.items():
        fresh.import_relationship_columns(
            p.ctx, resource_type=rt, resource_ids=rids, resource_relation=rl,
            subject_type=st, subject_ids=sids, subject_relation=sr)
    assert fresh.check(p.ctx, pcons.full(), *_checks(prel)) == j.c.check(
        j.ctx, jcons.full(), *_checks(jrel))


def test_id_column_export_import_round_trip():
    p, j = _sides()
    for s in (p, j):
        itn = s.c.store.interner
        docs = itn.node_batch("doc", [f"d{i}" for i in range(40)])
        users = itn.node_batch("user", [f"u{i}" for i in range(6)])
        teams = itn.node_batch("team", ["t0"])
        s.c.import_relationship_id_columns(
            s.ctx, resource_ids=np.repeat(docs, 2), resource_relation="reader",
            subject_ids=np.tile(users[:2], 40))
        s.c.import_relationship_id_columns(
            s.ctx, resource_ids=teams, resource_relation="member",
            subject_ids=users[3:4])
        s.c.import_relationship_id_columns(
            s.ctx, resource_ids=docs[5:6], resource_relation="reader",
            subject_ids=teams, subject_relation="member")
    rev = p.c.read_schema(p.ctx)[1]
    got, want = _both(p, j, lambda s: list(s.c.export_relationship_id_columns(s.ctx, rev)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    # restore into the same store: the TOUCH fallback, a no-op
    for ch in got:
        p.c.import_relationship_id_columns(
            p.ctx, resource_ids=ch["res"], resource_relation=ch["resource_relation"],
            subject_ids=ch["subj"], subject_relation=ch["subject_relation"])
    assert p.c.check(p.ctx, pcons.full(), *_checks(prel)) == j.c.check(
        j.ctx, jcons.full(), *_checks(jrel))


@pytest.mark.parametrize("chunk", [1, 5, 1000])
def test_check_iter_chunks(loaded, chunk):
    p, j = loaded
    before = pmetrics.default.counter("checks.requested")
    got, want = _both(p, j, lambda s: list(s.c.check_iter(
        s.ctx, s.cons.full(), iter(_checks(s.mod, 12)), chunk_size=chunk)))
    assert got == want == p.c.check(p.ctx, pcons.full(), *_checks(prel, 12))
    assert pmetrics.default.counter("checks.requested") == before + 24


def _head(s):
    return s.c.read_schema(s.ctx)[1]


OVERLAP_CASES = {
    "check": lambda s: s.c.check_one(s.ctx, s.cons.full(), s.mod.must_from_triple(
        "doc:d1", "view", "user:u1")),
    "read": lambda s: next(s.c.read_relationships(
        s.ctx, s.cons.full(), s.mod.new_filter("doc", "", "")), None),
    "export": lambda s: next(s.c.export_relationships(s.ctx, _head(s)), None),
    "export_columns": lambda s: next(s.c.export_relationship_columns(
        s.ctx, _head(s)), None),
    "export_id_columns": lambda s: next(s.c.export_relationship_id_columns(
        s.ctx, _head(s)), None),
    "import_columns": lambda s: s.c.import_relationship_columns(
        s.ctx, resource_type="doc", resource_ids=["x"], resource_relation="reader",
        subject_type="user", subject_ids=["y"]),
    "import_id_columns": lambda s: s.c.import_relationship_id_columns(
        s.ctx, resource_ids=np.zeros(0, np.int32), resource_relation="reader",
        subject_ids=np.zeros(0, np.int32)),
    "delete_atomic": lambda s: s.c.delete_atomic(s.ctx, s.mod.new_filter("doc", "", "")),
    "delete": lambda s: s.c.delete(s.ctx, s.mod.new_filter("doc", "", "")),
    # a keyed subscription sees no write: its context ends it
    "updates": lambda s: next(iter(s.c.updates(
        s.ctx.with_timeout(0.3), s.mod.UpdateFilter())), None),
    "lookup_resources": lambda s: next(s.c.lookup_resources(
        s.ctx, s.cons.full(), "doc#view", "user:u1"), None),
    "lookup_subjects": lambda s: next(s.c.lookup_subjects(
        s.ctx, s.cons.full(), "doc:d1", "view", "user"), None),
    "lookup_resources_page": lambda s: s.c.lookup_resources_page(
        s.ctx, s.cons.full(), "doc#view", "user:u1"),
    "check_iter": lambda s: list(s.c.check_iter(s.ctx, s.cons.full(), [
        s.mod.must_from_triple("doc:d1", "view", "user:u1")])),
}


@pytest.mark.parametrize("case", list(OVERLAP_CASES))
def test_overlap_required_guards_the_same_methods(case):
    p, j = _sides("with_overlap_required")
    for s, err in ((p, OverlapKeyMissingError), (j, JOverlapKeyMissingError)):
        with pytest.raises(err):
            OVERLAP_CASES[case](s)
        # writes and schema calls are exempt; a keyed context passes
        _write(s, [("doc:d1", "reader", "user:u1")], touch=True)
        s.ctx = s.cons.with_overlap_key(s.ctx, "k")
        OVERLAP_CASES[case](s)
