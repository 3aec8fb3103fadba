"""The port's SLO engine (utils/slo.py) and telemetry export
(utils/telemetry.py), both copied from the reference package, against
the reference's on the same operations: burn reports and ``slo.*`` gauges
at the same fake ticks (breach edges firing the same incidents),
Prometheus and OpenMetrics text for the same registry operations, every
endpoint of both telemetry servers on port 0, and ``/healthz`` degrading
with the same reasons.

The operations are drawn from numpy seeds and every clock is injected:
the tolerance is exact equality, with trace ids and wall-clock stamps
masked."""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils import slo as jslo
from gochugaru_tpu.utils import telemetry as jtel
from gochugaru_tpu.utils import trace as jtrace

from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils import slo as pslo
from gochugaru_tpu_torch.utils import telemetry as ptel
from gochugaru_tpu_torch.utils import trace as ptrace

#: side -> (slo, telemetry, trace, metrics)
SIDES = {
    "reference": (jslo, jtel, jtrace, jmetrics),
    "port": (pslo, ptel, ptrace, pmetrics),
}
MASKED = {"id", "trace_id", "trace_ids", "unix_s", "start_unix_s",
          "duration_s", "t0_s", "dur_s", "t_s", "uptime_s", "incident_dir",
          "path"}


@pytest.fixture(autouse=True)
def _hygiene():
    for _s, _t, tr, _m in SIDES.values():
        tr.disable()
    yield
    for s, _t, tr, _m in SIDES.values():
        tr.disable()
        s.install_engine(None)


def _mask(x):
    if isinstance(x, dict):
        return {k: "*" if k in MASKED else
                [None if e is None else [e[0], e[1], "*"] for e in v]
                if k == "exemplars" else _mask(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def _slos(S):
    return [
        S.latency_slo("req", "t_s", objective_ms=10.0),
        S.latency_slo("tight", "u_s", objective_ms=2.0, quantile=99.9),
        S.ratio_slo("shed", bad=("sheds",), total=("reqs",), budget=0.05),
    ]


def _burn_script(S, tr, M, seed, ticks):
    """Seeded traffic in three regimes (clean, a shed storm, recovery)
    over ``ticks`` fake seconds: every report, the gauges, the incidents
    the breach edges fired."""
    m = M.Metrics()
    clock = [0.0]
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m)
    rec = tr.install_recorder(tr.FlightRecorder(
        cooldown_s=0.0, grace_s=0.0, registry=m, clock=lambda: clock[0]))
    eng = S.SLOEngine(slos=_slos(S), windows=(10.0, 60.0), burn_threshold=2.0,
                      tick_s=1.0, registry=m, clock=lambda: clock[0],
                      start=False)
    rng = np.random.default_rng(seed)
    reports = []
    for t in range(ticks):
        clock[0] += 1.0
        storm = ticks // 3 <= t < 2 * ticks // 3
        n = int(rng.integers(50, 150))
        m.inc("reqs", n)
        m.inc("sheds", int(rng.integers(n // 4, n // 2)) if storm
              else int(rng.integers(0, 3)))
        for _ in range(int(rng.integers(1, 6))):
            m.observe("t_s", float(rng.choice([0.001, 0.004, 0.02, 0.3])))
            m.observe("u_s", float(rng.choice([0.001, 0.003])))
        reports.append(_mask(eng.tick()))
    rec.flush()
    gauges = {k: v for k, v in m.typed_snapshot()[1].items()
              if k.startswith("slo.")}
    out = (reports, gauges, _mask(rec.incident_index()),
           m.counter("slo.breaches"), _mask(eng.report()))
    eng.close()
    return out


@pytest.mark.parametrize("seed,ticks", [(1, 150), (2, 210)])
def test_burn_reports_equal_the_reference_tick_by_tick(seed, ticks):
    got = _burn_script(pslo, ptrace, pmetrics, seed, ticks)
    ptrace.disable()
    want = _burn_script(jslo, jtrace, jmetrics, seed, ticks)
    assert got == want
    reports, gauges, incidents, breaches, _ = got
    assert breaches >= 1 and len(incidents) == breaches
    assert all(i["trigger"] == "slo.burn" for i in incidents)
    assert gauges["slo.shed.burn_10s"] >= 0.0


def test_constructors_and_default_slos_equal_the_reference():
    assert [s.__dict__ for s in pslo.default_slos()] == [
        s.__dict__ for s in jslo.default_slos()]
    for S in (pslo, jslo):
        with pytest.raises(ValueError):
            S.latency_slo("a", "t_s", objective_ms=1.0, quantile=100.0)
        with pytest.raises(ValueError):
            S.ratio_slo("b", bad=("x",), total=("y",), budget=0.0)


# ---------------------------------------------------------------------------
# exposition text
# ---------------------------------------------------------------------------

def _fill(M, seed):
    """The same registry operations on a fresh registry of either
    package: counters, gauges, timers (with thresholds) and histograms
    with exemplars."""
    m = M.Metrics()
    rng = np.random.default_rng(seed)
    for k in range(60):
        m.inc(f"checks.c{k % 5}", int(rng.integers(1, 100)))
        m.set_gauge(f"serve.g{k % 3}", float(rng.integers(0, 1000)) / 7)
        m.observe(f"latency.t{k % 2}_s", float(rng.integers(1, 5000)) / 1e5)
        m.observe_hist("serve.request_latency",
                       float(rng.integers(1, 300)) / 1e3,
                       (0.005, 0.05, 0.1, 0.25), trace_id=f"tid-{k}")
    return m


#: an exemplar's trailing wall-clock stamp
_EXEMPLAR_TS = re.compile(r'(# \{trace_id="[^"]*"\} \S+) \S+')


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_text_equals_the_reference(seed, openmetrics):
    got = ptel.render_prometheus(_fill(pmetrics, seed), openmetrics=openmetrics)
    want = jtel.render_prometheus(_fill(jmetrics, seed), openmetrics=openmetrics)
    if openmetrics:
        got, want = (_EXEMPLAR_TS.sub(r"\1 *", t) for t in (got, want))
        assert got.endswith("# EOF\n") and 'trace_id="tid-' in got
    assert got == want


# ---------------------------------------------------------------------------
# both servers, every endpoint
# ---------------------------------------------------------------------------

def _get(url, accept=None):
    req = urllib.request.Request(url)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _serve_all(S, T, tr, M, seed, tmp):
    """One server over a filled registry, a seeded tracer ring, an SLO
    engine and a recorder holding one incident: every endpoint's answer,
    masked."""
    m = _fill(M, seed)
    clock = [0.0]
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m, seed=seed)
    rec = tr.install_recorder(tr.FlightRecorder(
        cooldown_s=0.0, grace_s=0.0, registry=m, clock=lambda: clock[0],
        incident_dir=str(tmp)))
    for i in range(3):
        with tr.root_span("check", i=i) as sp:
            sp.child("dispatch").end()
    iid = rec.trigger("breaker.trip", consecutive=2)
    rec.flush()
    eng = S.SLOEngine(slos=_slos(S), registry=m, clock=lambda: clock[0],
                      start=False)
    srv = T.TelemetryServer(port=0, registry=m, slo=eng, recorder=rec)
    out = {}
    try:
        assert srv.port > 0
        for path in ("/metrics", "/metrics?openmetrics=1", "/slo",
                     "/healthz", "/debug/incidents", "/decisions", "/tune",
                     "/nope", f"/debug/incidents/{iid}",
                     "/debug/incidents/missing"):
            code, ctype, body = _get(srv.url + path)
            if "ndjson" in (ctype or ""):
                body = [_mask(json.loads(ln)) for ln in body.splitlines()]
            elif ctype and "json" in ctype and code == 200:
                body = _mask(json.loads(body))
            else:
                body = _EXEMPLAR_TS.sub(r"\1 *", body)
            out[path.replace(iid, "<id>")] = (code, ctype, body)
        out["accept"] = _get(srv.url + "/metrics",
                             "application/openmetrics-text")[1]
        code, ctype, body = _get(srv.url + "/traces")
        out["/traces"] = (code, ctype,
                          [_mask(json.loads(ln)) for ln in body.splitlines()])
        code, ctype, body = _get(srv.url + "/perf")
        out["/perf"] = (code, ctype, sorted(json.loads(body)))
    finally:
        srv.close()
        eng.close()
        tr.disable()
    return out


def test_every_endpoint_answers_like_the_reference(tmp_path):
    got = _serve_all(pslo, ptel, ptrace, pmetrics, 5, tmp_path / "p")
    want = _serve_all(jslo, jtel, jtrace, jmetrics, 5, tmp_path / "j")
    # the /perf report's sections registered by other subsystems differ
    # between the packages' processes (utils/perf.py _EXTRA_REPORT): the
    # core keys are held in tests/test_torch_perf_report.py
    got.pop("/perf"), want.pop("/perf")
    assert got == want
    assert got["/nope"][0] == 404 and got["/debug/incidents/missing"][0] == 404
    assert got["/debug/incidents/<id>"][2][0]["trigger"] == "breaker.trip"
    assert got["/healthz"][2]["status"] == "degraded"
    assert len(got["/traces"][2]) == 3
    assert got["accept"].startswith("application/openmetrics-text")


def _readiness(S, T, tr, M):
    """The reasons /healthz gives through a breaker walk, an SLO breach
    and a recent incident."""
    m = M.Metrics()
    clock = [0.0]
    seen = [T.readiness_report(m)]
    m.set_gauge("breaker.state", 2.0)
    seen.append(T.readiness_report(m))
    m.set_gauge("breaker.state", 1.0)
    seen.append(T.readiness_report(m))
    m.set_gauge("breaker.state", 0.0)
    eng = S.SLOEngine(
        slos=[S.ratio_slo("shed", bad=("sheds",), total=("reqs",), budget=0.05)],
        windows=(10.0, 60.0), registry=m, clock=lambda: clock[0], start=False)
    for _ in range(70):
        clock[0] += 1.0
        m.inc("reqs", 100)
        m.inc("sheds", 30)
        eng.tick()
    seen.append(T.readiness_report(m, slo=eng))
    tr.configure(sample_rate=1.0, slow_threshold_s=None, registry=m)
    rec = tr.install_recorder(tr.FlightRecorder(
        cooldown_s=0.0, grace_s=0.0, registry=m))
    rec.trigger("breaker.trip")
    rec.flush()
    seen.append(T.readiness_report(m, recorder=rec))
    eng.close()
    # a closed engine is not live status: the global one (none) answers
    seen.append(T.readiness_report(m, slo=eng))
    tr.disable()
    return [_mask(r) for r in seen]


def test_healthz_degrades_with_the_reference_reasons():
    got = _readiness(pslo, ptel, ptrace, pmetrics)
    want = _readiness(jslo, jtel, jtrace, jmetrics)
    assert got == want
    assert [r["reasons"] for r in got] == [
        [], ["breaker_open"], ["breaker_half_open"], ["slo_burn:shed"],
        ["recent_incidents:1"], []]
