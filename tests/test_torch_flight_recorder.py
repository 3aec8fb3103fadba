"""The port's flight recorder (utils/trace.py, copied from the reference
package) against the reference's on the same scripted operations: the
always-on ring, the spike detector, per-trigger cooldown, the ring frozen
at trigger time, pruning of old bundles, and the bundles themselves,
equal line by line once incident ids, trace ids and timestamps are
masked.  Then the port's client wiring: a breaker trip on a port client
lands a bundle with the failing dispatches' traces, and two telemetry
clients share one SLO engine and one recorder.

Every recorder runs on an injected clock and is read after ``flush()``,
which waits for its capture threads.  Where a capture's grace matters
(the ring frozen at the trigger, the failing request that finishes after
it), the grace sleep is held until the test releases it: no test depends
on the host's speed.
The operations are drawn from numpy seeds; the tolerance is exact
equality."""

import json
import os
import threading
import time
import types

import numpy as np
import pytest

from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils import trace as jtrace
from gochugaru_tpu.utils.admission import CircuitBreaker as JBreaker
from gochugaru_tpu.utils.admission import DispatchGate as JGate
from gochugaru_tpu.utils.errors import ShedError as JShed

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import (
    new_evaluator, with_admission_control, with_latency_mode, with_telemetry,
)
from gochugaru_tpu_torch.utils import faults as pfaults
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils import slo as pslo
from gochugaru_tpu_torch.utils import trace as ptrace
from gochugaru_tpu_torch.utils.admission import AdmissionConfig as PAdmissionConfig
from gochugaru_tpu_torch.utils.admission import CircuitBreaker as PBreaker
from gochugaru_tpu_torch.utils.admission import DispatchGate as PGate
from gochugaru_tpu_torch.utils.context import background as p_background
from gochugaru_tpu_torch.utils.errors import ShedError as PShed

#: side -> (trace module, metrics module, breaker, gate, shed error)
SIDES = {
    "reference": (jtrace, jmetrics, JBreaker, JGate, JShed),
    "port": (ptrace, pmetrics, PBreaker, PGate, PShed),
}

#: keys whose values are ids, trace ids or clock readings
MASKED = {"id", "trace_id", "trace_ids", "unix_s", "start_unix_s",
          "duration_s", "t0_s", "dur_s", "t_s", "path"}


@pytest.fixture(autouse=True)
def _hygiene():
    """Both packages' tracers, recorders, SLO engines and fault
    registries are process-global: none leaks into the next test."""
    for tr in (jtrace, ptrace):
        tr.disable()
    pfaults.reset()
    yield
    for tr in (jtrace, ptrace):
        tr.disable()
    pfaults.reset()
    pslo.install_engine(None)


def _mask(x):
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in MASKED:
                out[k] = "*"
            elif k == "exemplars":
                out[k] = [None if e is None else ["*", e[1], "*"] for e in v]
            else:
                out[k] = _mask(v)
        return out
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def _bundle_lines(rec, iid):
    return [_mask(json.loads(ln)) for ln in rec.bundle(iid).splitlines()]


def _both(script, *args, **kw):
    """``script`` run on each package with a fresh registry and a fresh
    tracer and recorder on one injected clock: (port, reference)."""
    out = {}
    for side, (tr, M, *rest) in SIDES.items():
        m = M.Metrics()
        clock = [0.0]
        out[side] = script(tr, m, clock, *rest, *args, **kw)
        tr.disable()
    return out["port"], out["reference"]


def _recorder(tr, m, clock, **kw):
    kw.setdefault("grace_s", 0.0)
    kw.setdefault("cooldown_s", 0.0)
    return tr.install_recorder(tr.FlightRecorder(
        registry=m, clock=lambda: clock[0], **kw))


def _spans(tr, rng, n, name="req"):
    """``n`` seeded root traces, each with a child and a few events."""
    for i in range(n):
        with tr.root_span(name, i=i, batch=int(rng.integers(1, 512))) as sp:
            ch = sp.child("dispatch", tier=int(rng.integers(0, 4)))
            for e in range(int(rng.integers(0, 3))):
                ch.event("stage", k=e)
            if rng.random() < 0.3:
                ch.set_attr("error", "UnavailableError")
            ch.end()


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------

def _ring(tr, m, clock, *_sides, sample_rate, capacity, n, seed):
    tracer = tr.configure(sample_rate=sample_rate, slow_threshold_s=None,
                          registry=m, seed=seed)
    rec = _recorder(tr, m, clock, capacity=capacity)
    _spans(tr, np.random.default_rng(seed), n)
    return (_mask(rec.traces()), _mask(tracer.traces()),
            m.counter("trace.kept"), m.counter("trace.flight_kept"))


@pytest.mark.parametrize("sample_rate,capacity,n,seed", [
    (0.0, 4, 10, 1), (1.0, 4, 10, 2), (0.0, 16, 9, 3), (1.0, 3, 3, 4),
])
def test_ring_retains_like_the_reference(sample_rate, capacity, n, seed):
    """The ring keeps the last ``capacity`` roots at full fidelity
    whatever the head sample says (flight-only trees at rate 0), and the
    export ring stays head-sampled."""
    got, want = _both(_ring, sample_rate=sample_rate, capacity=capacity,
                      n=n, seed=seed)
    assert got == want
    flight, export = got[0], got[1]
    assert len(flight) == min(n, capacity)
    assert all(len(t["spans"]) == 2 for t in flight)
    assert len(export) == (n if sample_rate else 0)


def _slow_flight_only(tr, m, clock, *_sides):
    tracer = tr.configure(sample_rate=0.0, slow_threshold_s=0.0, registry=m)
    _recorder(tr, m, clock)
    sp = tr.root_span("check", batch=1)
    sp.child("dispatch").end()
    sp.end()
    return _mask(tracer.traces()), m.counter("trace.tail_kept")


def test_flight_only_slow_trace_exports_its_full_tree():
    got, want = _both(_slow_flight_only)
    assert got == want
    kept, n = got
    assert n == 1 and len(kept) == 1 and len(kept[0]["spans"]) == 2
    assert kept[0]["tail_kept"] is True and kept[0]["flight_only"] is True


def test_no_recorder_keeps_the_unsampled_path_noop():
    ptrace.configure(sample_rate=0.0, slow_threshold_s=None)
    n0 = ptrace.spans_created()
    assert ptrace.root_span("check") is ptrace.NOOP
    assert ptrace.spans_created() == n0


# ---------------------------------------------------------------------------
# the trigger bus
# ---------------------------------------------------------------------------

def _spikes(tr, m, clock, *_sides, seed):
    """Notes of three kinds at seeded clock steps, against a threshold
    of 5 in a 1 s window."""
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m)
    rec = _recorder(tr, m, clock, spike_threshold=5, spike_window_s=1.0)
    rng = np.random.default_rng(seed)
    fired = []
    for _ in range(120):
        clock[0] += float(rng.choice([0.01, 0.05, 0.3, 1.5]))
        kind = str(rng.choice(["shed", "retry", "shed"]))
        fired.append(rec.note(kind) is not None)
    rec.flush()
    return (fired, _mask(rec.incident_index()),
            m.counter("incidents.triggered"), m.counter("incidents.captured"))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_spike_detector_like_the_reference(seed):
    got, want = _both(_spikes, seed=seed)
    assert got == want
    assert any(got[0]), "no spike in the scripted burst"
    assert all(i["trigger"].endswith(".spike") for i in got[1])


def _cooldown(tr, m, clock, *_sides, seed):
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m)
    rec = _recorder(tr, m, clock, cooldown_s=30.0)
    rng = np.random.default_rng(seed)
    fired = []
    for _ in range(40):
        clock[0] += float(rng.choice([0.5, 4.0, 31.0]))
        name = str(rng.choice(["breaker.trip", "slo.burn", "latency.retrace"]))
        fired.append(rec.trigger(name, step=len(fired)) is not None)
    rec.flush()
    return (fired, m.counter("incidents.suppressed"),
            m.counter("incidents.captured"), _mask(rec.incident_index()))


@pytest.mark.parametrize("seed", [8, 9])
def test_cooldown_rate_limits_like_the_reference(seed):
    got, want = _both(_cooldown, seed=seed)
    assert got == want
    fired, suppressed, captured, _ = got
    assert suppressed == fired.count(False) > 0
    assert captured == fired.count(True)


def _held_grace(monkeypatch, tr):
    """Hold every capture thread of ``tr``'s recorders in its grace sleep
    until the returned event is set: the roots that finish meanwhile are
    in the bundle whatever the host's speed, which a wall-clock grace
    cannot promise."""
    gate = threading.Event()
    monkeypatch.setattr(tr, "time", types.SimpleNamespace(
        time=time.time, monotonic=time.monotonic,
        perf_counter=time.perf_counter, sleep=lambda _s: gate.wait(10.0)))
    return gate


def _frozen(tr, m, clock, *_sides, monkeypatch):
    """A trigger whose capture thread is held in its grace sleep while
    100 more roots finish: the 8 roots retained AT the trigger are the
    bundle's evidence, the ring's newest roots ride after them."""
    gate = _held_grace(monkeypatch, tr)
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m)
    rec = _recorder(tr, m, clock, capacity=8, grace_s=1.0)
    for i in range(8):
        tr.root_span("pre", i=i).end()
    iid = rec.trigger("breaker.trip")
    for i in range(100):
        tr.root_span("post", i=i).end()
    gate.set()
    rec.flush()
    monkeypatch.undo()
    return _bundle_lines(rec, iid)


def test_ring_frozen_at_trigger_like_the_reference(monkeypatch):
    got, want = _both(_frozen, monkeypatch=monkeypatch)
    assert got == want
    names = [ln["name"] for ln in got if ln["kind"] == "trace"]
    assert names == ["pre"] * 8 + ["post"] * 8
    assert [ln["spans"][0]["attrs"]["i"] for ln in got
            if ln["kind"] == "trace" and ln["name"] == "post"] == list(range(92, 100))


def _pruning(tr, m, clock, *_sides, d):
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m)
    os.makedirs(d)
    rec = _recorder(tr, m, clock, incident_dir=d, max_incidents=2,
                    keep_bundles=2)
    ids = []
    for i in range(5):
        ids.append(rec.trigger(f"t{i}"))
        rec.flush()
    files = sorted(os.listdir(d))
    return ([f.split("-", 2)[2] for f in files],
            [rec.bundle(i) is not None for i in ids])


def test_pruning_like_the_reference(tmp_path):
    got = _pruning(ptrace, pmetrics.Metrics(), [0.0], d=str(tmp_path / "p"))
    ptrace.disable()
    want = _pruning(jtrace, jmetrics.Metrics(), [0.0], d=str(tmp_path / "j"))
    assert got == want
    # two files kept on disk, two bundles in memory: the newest ones
    assert got[0] == ["t3.jsonl", "t4.jsonl"]
    assert got[1] == [False, False, False, True, True]


def _bundle(tr, m, clock, *_sides, seed, d):
    """A bundle with every kind of line: traces (one with an error
    attr), counters, gauges, timers, a histogram with exemplars, context
    providers (one broken)."""
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m, seed=seed)
    rec = _recorder(tr, m, clock, incident_dir=d)
    rec.add_context("cost_model", lambda: {"overall_s": 0.001})
    rec.add_context("broken", lambda: 1 / 0)
    rng = np.random.default_rng(seed)
    for k in range(12):
        m.inc(f"c{k % 4}", int(rng.integers(1, 9)))
        m.observe("checks.dispatch", float(rng.integers(1, 50)) / 1e3)
        m.set_gauge("breaker.state", float(rng.integers(0, 3)))
        m.observe_hist("serve.request_latency", float(rng.integers(1, 200)) / 1e3,
                       (0.01, 0.1), trace_id=f"tid-{k}")
    _spans(tr, rng, 5, name="check")
    iid = tr.trigger_incident("breaker.trip", consecutive=3)
    rec.flush()
    files = os.listdir(d)
    with open(os.path.join(d, files[0])) as f:
        assert f.read() == rec.bundle(iid)
    return _bundle_lines(rec, iid), len(files)


@pytest.mark.parametrize("seed", [10, 11])
def test_bundle_equals_the_reference_line_by_line(seed, tmp_path):
    got = _bundle(ptrace, pmetrics.Metrics(), [0.0], seed=seed,
                  d=str(tmp_path / "p"))
    ptrace.disable()
    want = _bundle(jtrace, jmetrics.Metrics(), [0.0], seed=seed,
                   d=str(tmp_path / "j"))
    assert got == want
    lines, nfiles = got
    assert nfiles == 1
    head = lines[0]
    assert head["kind"] == "incident" and head["trigger"] == "breaker.trip"
    assert head["info"] == {"consecutive": 3}
    assert head["context"]["broken"] == {"provider_error": "ZeroDivisionError"}
    assert [ln["kind"] for ln in lines] == (
        ["incident"] + ["trace"] * 5 + ["metrics", "hists"])


# ---------------------------------------------------------------------------
# anomaly sites
# ---------------------------------------------------------------------------

def _sites(tr, m, clock, Breaker, Gate, Shed):
    """A breaker trip and a shed burst through the copied admission
    classes fire the same incidents."""
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m)
    rec = _recorder(tr, m, clock, spike_threshold=8)
    br = Breaker(threshold=2, cooldown_s=10.0, registry=m)
    br.record_failure()
    br.record_failure()
    gate = Gate(max_inflight=1, registry=m)
    with gate.admit():
        for _ in range(8):
            with pytest.raises(Shed):
                with gate.admit():
                    pass
    rec.flush()
    return _mask(rec.incident_index())


def test_breaker_and_shed_sites_fire_like_the_reference():
    got, want = _both(_sites)
    assert got == want
    assert [(i["trigger"], i["info"]) for i in got] == [
        ("breaker.trip", {"consecutive": 2, "threshold": 2}),
        ("shed.spike", {"count": 8, "window_s": 1.0}),
    ]


# ---------------------------------------------------------------------------
# the port's client wiring
# ---------------------------------------------------------------------------

SCHEMA = """
definition user {}
definition doc { relation reader: user  permission read = reader }
"""


def _doc_client(*opts):
    c = new_evaluator(with_latency_mode(), *opts, device="cpu")
    ctx = p_background()
    c.write_schema(ctx, SCHEMA)
    txn = prel.Txn()
    for i in range(16):
        txn.create(prel.must_from_triple(f"doc:d{i}", "reader", f"user:u{i}"))
    c.write(ctx, txn)
    rs = [prel.must_from_triple(f"doc:d{i}", "read", f"user:u{i}")
          for i in range(8)]
    return c, ctx, rs


def test_breaker_trip_on_a_port_client_lands_a_bundle(tmp_path, monkeypatch):
    """Faults on the latency dispatch site trip the breaker mid-request;
    the retry envelope still answers, and the bundle (on disk and at
    ``/debug/incidents/<id>``) names the trip and holds the failing
    dispatches' traces and the client's admission and perf context."""
    import urllib.request

    # the failing request ends after the trip: hold the capture for it
    gate = _held_grace(monkeypatch, ptrace)
    c, ctx, rs = _doc_client(
        with_admission_control(PAdmissionConfig(
            breaker_threshold=2, breaker_cooldown_s=60.0)),
        with_telemetry(port=0, incident_dir=str(tmp_path)),
    )
    try:
        assert ptrace.enabled() and ptrace.recorder() is c.recorder
        assert c.slo is not None and c.telemetry is not None
        assert c.check(ctx, pcons.full(), *rs) == [True] * 8
        trips = pmetrics.default.counter("breaker.trips")
        pfaults.arm("latency.dispatch", times=2)
        assert c.check(ctx, pcons.full(), *rs) == [True] * 8
        assert pmetrics.default.counter("breaker.trips") == trips + 1
        gate.set()
        c.recorder.flush()
        hits = [f for f in os.listdir(tmp_path) if "breaker.trip" in f]
        assert len(hits) == 1
        text = (tmp_path / hits[0]).read_text()
        lines = [json.loads(ln) for ln in text.splitlines()]
        head = lines[0]
        assert head["trigger"] == "breaker.trip"
        failing = [t["trace_id"] for t in lines if t["kind"] == "trace"
                   and any("error" in (sp.get("attrs") or {})
                           for sp in t["spans"])]
        assert failing and set(failing) <= set(head["trace_ids"])
        ctx_keys = head["context"]
        adm = next(k for k in ctx_keys if k.startswith("admission"))
        assert ctx_keys[adm]["breaker_state"] == 2
        assert any(k.startswith("perf") for k in ctx_keys)
        iid = head["id"]
        with urllib.request.urlopen(
                f"{c.telemetry.url}/debug/incidents/{iid}") as r:
            assert r.read().decode() == text
    finally:
        c.telemetry.close()


def _shared_wiring(new, with_telemetry_, slo, M, base):
    c1 = new(with_telemetry_(port=0, incident_dir=str(base / "a")))
    c2 = new(with_telemetry_(port=0, incident_dir=str(base / "b")))
    out = {}
    try:
        out["one_engine"] = c1.slo is c2.slo is slo.get_engine()
        out["one_recorder"] = c1.recorder is c2.recorder
        out["dir"] = os.path.basename(c2.recorder.incident_dir)
        out["admission_keys"] = sorted(
            k for k in c1.recorder._context if k.startswith("admission"))
        eng = c1.slo
        c3 = new(with_telemetry_(port=0, slos=()))
        try:
            out["disabled"] = c3.slo is None and slo.get_engine() is None
            out["stopped"] = eng._stop.is_set()
            out["slo_gauges"] = sorted(
                k for k in M.default._gauges if k.startswith("slo."))
        finally:
            c3.telemetry.close()
    finally:
        slo.install_engine(None)
        c1.telemetry.close()
        c2.telemetry.close()
    return out


def test_telemetry_clients_share_one_engine_and_the_latest_dir(tmp_path):
    from gochugaru_tpu.client import new_tpu_evaluator as j_new
    from gochugaru_tpu.client import with_telemetry as j_with_telemetry
    from gochugaru_tpu.utils import slo as jslo

    got = _shared_wiring(lambda *o: new_evaluator(*o, device="cpu"),
                         with_telemetry, pslo, pmetrics, tmp_path / "p")
    want = _shared_wiring(j_new, j_with_telemetry, jslo, jmetrics,
                          tmp_path / "j")
    assert got == want
    assert got["one_engine"] and got["one_recorder"] and got["disabled"]
    assert got["dir"] == "b" and len(got["admission_keys"]) == 2
    assert got["stopped"] and got["slo_gauges"] == []
