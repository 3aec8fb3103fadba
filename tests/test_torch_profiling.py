"""``with_profiling`` on the port and the profiler hooks of its
``utils/trace.py``: one ``torch.profiler`` trace file a check dispatch on
``cpu`` with the ``checks.device_time_s`` timer counting them, nothing
traced from the serving path, ``profiler_session`` setting and restoring
the ``GOCHUGARU_TRACE_DIR`` marker as the reference's does, and
``annotate_dispatch`` ranges in a profile.  The card's case (the trace
holds the ``block`` kernel's launches) is
tests/test_torch_profiling_cuda.py.

The checks' answers are held to the reference's host oracle on the same
world: exact equality."""

import json
import os

import numpy as np
import pytest
import torch

from gochugaru_tpu import consistency as jcons
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import new_tpu_evaluator as j_new
from gochugaru_tpu.client import with_host_only_evaluation as j_host_only
from gochugaru_tpu.utils import trace as jtrace
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import (
    new_evaluator, with_latency_mode, with_profiling,
)
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils import trace as ptrace
from gochugaru_tpu_torch.utils.context import background as p_background

SCHEMA = """
definition user {}
definition team { relation member: user }
definition doc {
    relation reader: user | team#member
    relation banned: user
    permission read = reader - banned
}
"""


def _world(new, rel, background, *opts, seed=3):
    c = new(*opts)
    ctx = background()
    c.write_schema(ctx, SCHEMA)
    rng = np.random.default_rng(seed)
    txn = rel.Txn()
    for t in range(4):
        for u in rng.choice(20, 4, replace=False):
            txn.touch(rel.must_from_triple(f"team:t{t}", "member", f"user:u{u}"))
    for d in range(30):
        txn.touch(rel.must_from_tuple(f"doc:d{d}#reader",
                                      f"team:t{rng.integers(4)}#member"))
        txn.touch(rel.must_from_triple(f"doc:d{d}", "reader",
                                       f"user:u{rng.integers(20)}"))
        if rng.random() < 0.3:
            txn.touch(rel.must_from_triple(f"doc:d{d}", "banned",
                                           f"user:u{rng.integers(20)}"))
    c.write(ctx, txn)
    return c, ctx


def _checks(rel, seed, n=40):
    rng = np.random.default_rng(seed)
    return [rel.must_from_triple(f"doc:d{rng.integers(30)}", "read",
                                 f"user:u{rng.integers(20)}") for _ in range(n)]


@pytest.fixture
def oracle():
    c, ctx = _world(j_new, jrel, j_background, j_host_only())
    return lambda seed: c.check(ctx, jcons.full(), *_checks(jrel, seed))


def _trace_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pt.trace.json"))


def test_one_trace_file_per_dispatch(tmp_path, oracle):
    c, ctx = _world(lambda *o: new_evaluator(*o, device="cpu"), prel,
                    p_background, with_profiling(str(tmp_path)))
    n0 = pmetrics.default.snapshot().get("checks.device_time_s.count", 0)
    for seed in (1, 2, 3):
        assert c.check(ctx, pcons.full(), *_checks(prel, seed)) == oracle(seed)
    files = _trace_files(tmp_path)
    assert len(files) == 3
    assert pmetrics.default.snapshot()["checks.device_time_s.count"] - n0 == 3
    for f in files:
        with open(tmp_path / f) as fh:
            events = json.load(fh)["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("gochugaru:") for n in names), f
    # the marker is not left behind
    assert not ptrace.profiler_active()


def test_the_serving_path_stays_unprofiled(tmp_path, oracle):
    c, ctx = _world(lambda *o: new_evaluator(*o, device="cpu"), prel,
                    p_background, with_latency_mode(),
                    with_profiling(str(tmp_path)))
    with c.with_serving(pcons.full()) as h:
        assert h.check(ctx, *_checks(prel, 4)) == oracle(4)
        snap = c.store.snapshot_for(pcons.full())
        it = snap.interner
        q_res = np.array([it.lookup("doc", f"d{i}") for i in range(8)], np.int32)
        q_subj = np.array([it.lookup("user", f"u{i}") for i in range(8)], np.int32)
        q_perm = np.full(8, snap.compiled.slot_of_name["read"], np.int32)
        h.check_columns(ctx, q_res, q_perm, q_subj)
    assert _trace_files(tmp_path) == []
    assert c.check(ctx, pcons.full(), *_checks(prel, 5)) == oracle(5)
    assert len(_trace_files(tmp_path)) == 1


def _session_script(tr, base):
    """The marker through nested sessions, from an unset and a set
    environment."""
    seen = []
    os.environ.pop("GOCHUGARU_TRACE_DIR", None)
    tr.refresh_profiler()
    seen.append((tr.profiler_active(), os.environ.get("GOCHUGARU_TRACE_DIR")))
    with tr.profiler_session(str(base / "a")):
        seen.append((tr.profiler_active(), os.environ["GOCHUGARU_TRACE_DIR"]))
        with tr.profiler_session(str(base / "b")):
            seen.append((tr.profiler_active(), os.environ["GOCHUGARU_TRACE_DIR"]))
        seen.append((tr.profiler_active(), os.environ["GOCHUGARU_TRACE_DIR"]))
    seen.append((tr.profiler_active(), os.environ.get("GOCHUGARU_TRACE_DIR")))
    os.environ["GOCHUGARU_TRACE_DIR"] = str(base / "env")
    seen.append((tr.refresh_profiler(), tr.profiler_active()))
    with tr.profiler_session(str(base / "c")):
        pass
    seen.append((tr.profiler_active(), os.environ.get("GOCHUGARU_TRACE_DIR")))
    os.environ.pop("GOCHUGARU_TRACE_DIR", None)
    tr.refresh_profiler()
    return [tuple(str(v).replace(str(base), "<base>") for v in s) for s in seen]


def test_profiler_session_sets_and_restores_the_marker(tmp_path, monkeypatch):
    monkeypatch.delenv("GOCHUGARU_TRACE_DIR", raising=False)
    got = _session_script(ptrace, tmp_path)
    want = _session_script(jtrace, tmp_path)
    assert got == want
    assert got[2] == ("True", "<base>/b") and got[4] == ("False", "None")
    assert got[-1] == ("True", "<base>/env")


def test_annotate_dispatch_ranges_under_a_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tr = ptrace.configure(sample_rate=1.0, slow_threshold_s=None)
    try:
        sp = ptrace.root_span("check")
        assert ptrace.annotate_dispatch(sp) is ptrace._NULL_CTX
        assert ptrace.annotate_dispatch(ptrace.NOOP) is ptrace._NULL_CTX
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ptrace.annotate_dispatch(sp):
                torch.ones(8).sum()
            with ptrace.annotate_dispatch(ptrace.NOOP):
                torch.ones(8).sum()
        names = {e.name for e in prof.events()}
        assert f"gochugaru:{sp.trace_id}" in names
        assert "gochugaru:untraced" in names
        sp.end()
        # a session marker alone (no torch.profiler recording) also
        # emits the range, so an outer harness's profile carries it
        with ptrace.profiler_session(str(tmp_path)):
            assert ptrace.annotate_dispatch(ptrace.NOOP) is not ptrace._NULL_CTX
        assert tr.traces()
    finally:
        ptrace.disable()
