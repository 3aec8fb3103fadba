"""Telemetry export: Prometheus/OpenMetrics rendering of the live
Metrics registry, JSONL trace dump, SLO burn report, incident bundles,
and a stdlib HTTP daemon serving all of it.

The bench suite measures offline (Graphulo discipline, arXiv:1609.08642);
a serving process for millions of users must expose the SAME numbers
live.  This module is deliberately dependency-free: ``http.server`` on a
daemon thread, the exposition formats by hand — the container bakes no
prometheus_client, and the formats are a few dozen lines of code.

Surface:

- ``render_prometheus(registry)`` — counters as ``counter``, gauges as
  ``gauge``, timer rings as ``summary`` quantile series (p50/p90/p99/
  p999 via the shared ``metrics.nearest_rank``) plus ``_count``/``_sum``,
  fixed-bucket histograms as cumulative ``le`` series.  With
  ``openmetrics=True`` the output is OpenMetrics 1.0 text instead:
  histogram buckets carry **exemplars** — the last trace id that landed
  in the bucket (``Metrics.observe_hist(trace_id=…)``) — so a fat tail
  bucket links directly to a recorded trace; terminated by ``# EOF``.
  The HTTP handler negotiates via the Accept header (scrapers ask for
  ``application/openmetrics-text``) or a ``?openmetrics=1`` query.
- ``render_traces(tracer)`` — the tracer ring as JSONL.
- ``TelemetryServer`` — ``/metrics`` (exposition text), ``/traces``
  (JSONL), ``/slo`` (burn-rate report, utils/slo.py), ``/tune``
  (self-tuning posture: live knob values, frozen knobs, ``tune.*``
  trajectory counters when an OnlineController is attached), ``/perf``
  (the
  performance-attribution ledger, utils/perf.py: cost_analysis
  entries, gathered-bytes model, pad waste, measured roofline,
  wall-time ledger — ``?compile=1``/``?bench=1`` opt into the
  expensive captures), ``/debug/incidents`` (flight-recorder bundle
  index; ``/debug/incidents/<id>`` serves one bundle as JSONL),
  ``/healthz`` (readiness report: breaker state, admission in-flight,
  serve queue depth, SLO status — degraded states say why instead of a
  flat ok).  Bound to localhost by default; ``port=0`` picks an
  ephemeral port (read ``.port`` back).
- ``client.with_telemetry(port=..., incident_dir=...)`` (client.py)
  starts one per client.  ``/tune`` answers ``enabled: false`` with the
  ``tune.*`` counters until a controller is attached.

Copied from the reference package (host-only).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional

from . import metrics as _metrics
from . import trace as _trace

#: every exported series is namespaced (dots/dashes → underscores after)
PROM_PREFIX = "gochugaru_"

CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: quantile-label values for the timer summaries, paired with the
#: shared snapshot percentiles (50 → "0.5", 99.9 → "0.999")
_QUANTILE_LABELS = tuple(
    (q, format(q / 100.0, "g")) for q in _metrics.SNAPSHOT_QUANTILES
)


def prom_name(name: str, suffix: str = "") -> str:
    """'checks.dispatch' → 'gochugaru_checks_dispatch<suffix>'."""
    return PROM_PREFIX + _NAME_RE.sub("_", name) + suffix


def _fmt(v: float) -> str:
    # Prometheus wants plain decimal/scientific; repr of a float is fine
    return repr(float(v))


def _exemplar(ex) -> str:
    """One OpenMetrics exemplar suffix: ``# {trace_id="…"} value ts``.
    Exemplars are only legal in OpenMetrics text, only on histogram
    ``_bucket`` lines — the 0.0.4 renderer never calls this."""
    tid, value, ts = ex
    return f' # {{trace_id="{tid}"}} {_fmt(value)} {round(ts, 3)}'


def render_prometheus(
    registry: Optional[_metrics.Metrics] = None, *, openmetrics: bool = False
) -> str:
    """The registry as exposition text.  Counters/gauges map directly;
    each timer ring becomes a summary — quantile series from the SAME
    nearest-rank math ``Metrics.snapshot`` publishes, so the scraped p99
    and the in-process p99 cannot disagree.  ``openmetrics=True``
    switches dialect: TYPE lines name the metric family without the
    ``_total`` suffix, ``le`` labels are canonical floats, histogram
    buckets carry trace-id exemplars, and the text ends with ``# EOF``."""
    m = registry or _metrics.default
    counters, gauges, timers = m.typed_snapshot()
    hists = m.hist_snapshot()
    lines: List[str] = []
    for name in sorted(counters):
        pn = prom_name(name)
        # OpenMetrics: the TYPE line names the family, samples add _total;
        # 0.0.4 scrapers expect the TYPE line to match the sample name
        lines.append(f"# TYPE {pn if openmetrics else pn + '_total'} counter")
        lines.append(f"{pn}_total {_fmt(counters[name])}")
    for name in sorted(gauges):
        pn = prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(gauges[name])}")
    for name in sorted(timers):
        n, total, samples = timers[name]
        base = _NAME_RE.sub("_", name)
        # timer names already end in '_s' by convention; normalize the
        # exported unit suffix to _seconds either way
        base = base[:-2] if base.endswith("_s") else base
        pn = PROM_PREFIX + base + "_seconds"
        lines.append(f"# TYPE {pn} summary")
        if samples:
            for q, label in _QUANTILE_LABELS:
                lines.append(
                    f'{pn}{{quantile="{label}"}} '
                    f"{_fmt(_metrics.nearest_rank(samples, q))}"
                )
        lines.append(f"{pn}_count {n}")
        lines.append(f"{pn}_sum {_fmt(total)}")
    for name in sorted(hists):
        buckets, counts, n, total, exemplars = hists[name]
        pn = prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for i, (b, c) in enumerate(zip(buckets, counts)):
            cum += c
            le = _fmt(b) if openmetrics else format(b, "g")
            ex = exemplars[i] if openmetrics else None
            lines.append(
                f'{pn}_bucket{{le="{le}"}} {cum}'
                + (_exemplar(ex) if ex is not None else "")
            )
        ex = exemplars[-1] if openmetrics else None
        lines.append(
            f'{pn}_bucket{{le="+Inf"}} {n}'
            + (_exemplar(ex) if ex is not None else "")
        )
        lines.append(f"{pn}_count {n}")
        lines.append(f"{pn}_sum {_fmt(total)}")
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_traces(tracer: Optional[_trace.Tracer] = None) -> str:
    """The tracer's finished-trace ring as JSONL ('' when tracing is
    disabled or nothing was kept)."""
    tr = tracer if tracer is not None else _trace.get()
    if tr is None:
        return ""
    return tr.dump_jsonl()


def _live_slo(slo):
    """The engine whose verdict is CURRENT: the given one while it is
    open, else the process-global engine (the bound engine may have been
    closed — disabled or replaced — after its holder captured it; a
    frozen report must not pose as live status).  One rule shared by
    ``/slo`` and ``readiness_report`` so the two cannot disagree about
    which engine is live."""
    if slo is not None and getattr(slo, "closed", False):
        from . import slo as _slo_mod

        return _slo_mod.get_engine()
    return slo


#: how long after an incident /healthz keeps naming it a degradation
#: reason — long enough for a poller to notice, short enough that one
#: transient blip doesn't keep a recovered process drained (breaker and
#: SLO state cover LIVE anomalies; this reason covers recent history)
RECENT_INCIDENT_S = 60.0


def readiness_report(
    registry: Optional[_metrics.Metrics] = None,
    slo=None,
    recorder: Optional[_trace.FlightRecorder] = None,
    uptime_s: float = 0.0,
    recent_incident_s: float = RECENT_INCIDENT_S,
) -> dict:
    """The ``/healthz`` payload: liveness grown into readiness.  A bare
    200 says a thread is alive; an operator (and the serve smoke's load
    balancer stand-in) needs "is this process actually fit to take
    traffic" — breaker state, in-flight admission, serve queue depth,
    and the SLO engine's verdict.  Degraded states answer
    ``"status": "degraded"`` with machine-readable reasons instead of a
    flat ok (still HTTP 200: degraded-but-alive is a routing decision
    for the caller, not an error)."""
    m = registry or _metrics.default
    slo = _live_slo(slo)
    breaker = m.gauge("breaker.state", 0.0)
    reasons: List[str] = []
    if breaker == 2.0:
        reasons.append("breaker_open")
    elif breaker == 1.0:
        reasons.append("breaker_half_open")
    slo_status = None
    if slo is not None:
        rep = slo.report()
        slo_status = {
            "healthy": bool(rep.get("healthy", True)),
            "breached": list(rep.get("breached", ())),
        }
        for name in slo_status["breached"]:
            reasons.append(f"slo_burn:{name}")
    incidents = None
    if recorder is not None:
        idx = recorder.incident_index()
        incidents = len(idx)
        recent = [
            mi for mi in idx
            if time.time() - mi.get("unix_s", 0.0) < recent_incident_s
        ]
        if recent:
            reasons.append(f"recent_incidents:{len(recent)}")
    return {
        "status": "degraded" if reasons else "ok",
        "reasons": reasons,
        "uptime_s": round(uptime_s, 3),
        "tracing": _trace.enabled(),
        "breaker_state": int(breaker),
        "admission_inflight": int(m.gauge("admission.inflight", 0.0)),
        "serve_queue_depth": int(m.gauge("serve.queue_depth", 0.0)),
        "slo": slo_status,
        "incidents": incidents,
    }


class TelemetryServer:
    """``/metrics`` + ``/traces`` + ``/slo`` + ``/perf`` +
    ``/debug/incidents`` + ``/healthz`` on a daemon thread.

    Read-only by construction: the handlers render from the registry,
    the tracer ring, the SLO engine's cached report, and the recorder's
    bundle store, never mutate them — safe to point a scraper at a
    serving process.  ``close()`` shuts the listener down; the client
    never calls it implicitly (a dropped Client must not tear telemetry
    out from under a scraper mid-poll; the daemon thread dies with the
    process)."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[_metrics.Metrics] = None,
        tracer: Optional[_trace.Tracer] = None,
        slo=None,
        recorder: Optional[_trace.FlightRecorder] = None,
        controller=None,
    ) -> None:
        self._registry = registry or _metrics.default
        self._tracer = tracer  # None → follow the global tracer live
        self._slo = slo
        self._recorder = recorder  # None → follow the global recorder live
        self._controller = controller  # tune.OnlineController, optional
        self._t0 = time.monotonic()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # silence per-request noise
                pass

            def _reply(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                path, _, query = self.path.partition("?")
                try:
                    if path == "/metrics":
                        from urllib.parse import parse_qs

                        om = parse_qs(query).get("openmetrics") == ["1"] or (
                            "application/openmetrics-text"
                            in (self.headers.get("Accept") or "")
                        )
                        self._reply(
                            200,
                            render_prometheus(
                                outer._registry, openmetrics=om
                            ),
                            CONTENT_TYPE_OPENMETRICS if om
                            else CONTENT_TYPE_PROM,
                        )
                    elif path == "/traces":
                        self._reply(
                            200, render_traces(outer._tracer),
                            "application/x-ndjson; charset=utf-8",
                        )
                    elif path == "/perf":
                        from urllib.parse import parse_qs

                        from . import perf as _perf

                        q = parse_qs(query)
                        # ?compile=1 realizes pending cost thunks;
                        # ?bench=1 runs the bandwidth microbench when no
                        # cached verdict exists — both explicit: a
                        # scrape must never surprise a serving process
                        # with a full-bandwidth burn
                        self._reply(
                            200,
                            json.dumps(
                                _perf.render_report(
                                    outer._registry,
                                    realize=q.get("compile") == ["1"],
                                    bench=q.get("bench") == ["1"],
                                ),
                                default=repr,
                            ),
                            "application/json",
                        )
                    elif path == "/decisions":
                        from urllib.parse import parse_qs

                        from . import decisions as _decisions

                        q = parse_qs(query)
                        try:
                            n = max(0, int(q.get("n", ["256"])[0]))
                        except ValueError:
                            n = 256
                        log = _decisions.get()
                        head = {
                            "kind": "summary",
                            "enabled": log is not None,
                            "verdicts": outer._registry.counters_prefixed(
                                "check.verdicts."
                            ),
                        }
                        if log is not None:
                            head["stats"] = log.stats()
                        lines = [json.dumps(head, default=repr)]
                        if log is not None:
                            lines.extend(
                                json.dumps(e, default=repr)
                                for e in log.tail(n)
                            )
                        self._reply(
                            200, "\n".join(lines) + "\n",
                            "application/x-ndjson; charset=utf-8",
                        )
                    elif path == "/slo":
                        slo = _live_slo(outer._slo)
                        body = (
                            {"enabled": False} if slo is None
                            else {"enabled": True, **slo.report()}
                        )
                        self._reply(
                            200, json.dumps(body), "application/json"
                        )
                    elif path == "/debug/incidents":
                        rec = outer._recorder or _trace.recorder()
                        idx = (
                            rec.incident_index() if rec is not None else []
                        )
                        self._reply(
                            200,
                            json.dumps({
                                "incident_dir": (
                                    rec.incident_dir
                                    if rec is not None else None
                                ),
                                "incidents": idx,
                            }),
                            "application/json",
                        )
                    elif path.startswith("/debug/incidents/"):
                        rec = outer._recorder or _trace.recorder()
                        iid = path[len("/debug/incidents/"):]
                        bundle = (
                            rec.bundle(iid) if rec is not None else None
                        )
                        if bundle is None:
                            self._reply(
                                404, "no such incident\n", "text/plain"
                            )
                        else:
                            self._reply(
                                200, bundle,
                                "application/x-ndjson; charset=utf-8",
                            )
                    elif path == "/tune":
                        # self-tuning posture: the controller's live
                        # knob values + trajectory counters, read-only
                        # (revert stays an in-process call on purpose —
                        # a GET must never move a knob)
                        ctl = outer._controller
                        body = {
                            "enabled": ctl is not None,
                            "counters": outer._registry.counters_prefixed(
                                "tune."
                            ),
                        }
                        if ctl is not None:
                            body["status"] = ctl.status()
                        self._reply(
                            200, json.dumps(body, default=repr),
                            "application/json",
                        )
                    elif path == "/healthz":
                        self._reply(
                            200,
                            json.dumps(readiness_report(
                                outer._registry, outer._slo,
                                outer._recorder or _trace.recorder(),
                                uptime_s=time.monotonic() - outer._t0,
                            )),
                            "application/json",
                        )
                    else:
                        self._reply(404, "not found\n", "text/plain")
                except BrokenPipeError:  # scraper went away mid-write
                    pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name=f"gochugaru-telemetry-{self.port}",
            daemon=True,
        )
        self._thread.start()
        _metrics.default.set_gauge("telemetry.port", self.port)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


__all__ = [
    "CONTENT_TYPE_OPENMETRICS",
    "CONTENT_TYPE_PROM",
    "PROM_PREFIX",
    "TelemetryServer",
    "prom_name",
    "readiness_report",
    "render_prometheus",
    "render_traces",
]
