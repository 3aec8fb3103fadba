"""The port's telemetry daemon (``python -m
gochugaru_tpu_torch.scripts.telemetryd --device cpu``) beside the
reference's ``scripts/telemetryd.py``, both as processes on the CPU.

The port's endpoints answer what the reference's telemetry smoke polls
(``/healthz`` ok, ``gochugaru_checks_requested_total`` > 0 and the
dispatch p99 quantile in ``/metrics``, a ``trace_id`` in ``/traces``,
``/slo`` enabled with burn windows, ``/debug/incidents``, OpenMetrics
ending in ``# EOF``), ``/perf?bench=1`` names the device it measured,
and the metric families of both daemons are the same once the families
named below are mapped or set aside.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
import urllib.request

from gochugaru_tpu_torch.scripts.procs import ROOT, Child, close_all, module_argv

ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
           GOCHUGARU_ROOFLINE_CACHE="0")

#: the reference's backend-specific families and the port's names for
#: them: the Pallas byte models become the CUDA kernels' (utils/perf.py
#: ``publish_kernel_model``)
RENAMED = {
    "gochugaru_perf_pallas_bytes_per_check": "gochugaru_perf_kernels_bytes_per_check",
    "gochugaru_perf_pallas_bytes_saved_per_check":
        "gochugaru_perf_kernels_bytes_saved_per_check",
}
#: the reference's families with no port counterpart: Pallas's fallback
#: and trace counters (the port raises where its kernels cannot run, and
#: traces nothing), XLA's cost analysis of a latency pin (torch has none:
#: the port realizes each cost entry as unavailable, below), and the
#: reference's memo of interned query ids (the port lowers without one)
REFERENCE_ONLY = {
    "gochugaru_pallas_degraded_total",
    "gochugaru_pallas_unavailable_total",
    "gochugaru_pallas_kernel_traces_total",
    "gochugaru_perf_cost_latency_pin_bytes_accessed",
    "gochugaru_perf_cost_latency_pin_flops",
    "gochugaru_intern_memo_hits_total",
}
#: the port's families the reference lacks: the unavailable cost
#: entries, and the first dispatch of a latency pin (capture or rebind)
PORT_ONLY = {
    "gochugaru_perf_cost_analysis_unavailable",
    "gochugaru_perf_cost_analysis_unavailable_total_total",
    "gochugaru_latency_cold_dispatch_seconds",
}


def _get(url, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def _families(text):
    return set(re.findall(r"^# TYPE (\S+)", text, re.M))


def _live_metrics(url, timeout=30.0):
    """/metrics once the demo checks have bumped the counter and the
    dispatch timer's ring holds a quantile."""
    deadline = time.monotonic() + timeout
    while True:
        text = _get(url + "/metrics")
        if (re.search(r"^gochugaru_checks_requested_total [1-9]", text, re.M)
                and re.search(r'^gochugaru_checks_dispatch_seconds\{quantile="0.99"\}',
                              text, re.M)):
            return text
        assert time.monotonic() < deadline, "checks counter or p99 quantile missing"
        time.sleep(0.5)


def test_endpoints_and_metric_families_against_reference(tmp_path):
    kids = []
    try:
        port = Child(module_argv("gochugaru_tpu_torch.scripts.telemetryd",
                                 "--device", "cpu", "--checks", "32"),
                     str(tmp_path / "port.log"), env=ENV)
        ref = Child([sys.executable, os.path.join(ROOT, "scripts", "telemetryd.py"),
                     "--checks", "32"], str(tmp_path / "ref.log"), env=ENV)
        kids += [port, ref]
        url = port.wait_line("READY url=", 60).split("=", 1)[1]
        ref_url = ref.wait_line("READY url=", 60).split("=", 1)[1]
        metrics = _live_metrics(url)
        ref_metrics = _live_metrics(ref_url)

        assert json.loads(_get(url + "/healthz"))["status"] == "ok"
        assert "trace_id" in json.loads(_get(url + "/traces").splitlines()[0])
        slo = json.loads(_get(url + "/slo"))
        assert slo["enabled"] is True
        assert all("burn" in w for s in slo["slos"] for w in s["windows"].values())
        assert "incidents" in json.loads(_get(url + "/debug/incidents"))
        om = _get(url + "/metrics", accept="application/openmetrics-text")
        assert om.rstrip().endswith("# EOF")
        bench = json.loads(_get(url + "/perf?bench=1"))["roofline"]
        assert bench["platform"] == "cpu" and "kind=cpu" in bench["fingerprint"]

        ours = _families(metrics)
        theirs = {RENAMED.get(f, f) for f in _families(ref_metrics)} - REFERENCE_ONLY
        assert ours - PORT_ONLY == theirs
        assert "gochugaru_latency_cold_dispatch_seconds" in ours  # pins captured
        assert port.stop(30) == 0
        assert "demo world ready on cpu" in port.text()
    finally:
        close_all(kids)
