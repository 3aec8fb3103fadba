"""Standalone telemetry endpoint: build a small demo world, run traced
checks, and serve /metrics + /traces + /slo + /perf + /debug/incidents +
/healthz until killed.

The in-process route is ``client.with_telemetry(port=...)`` (client.py);
this daemon exists so operators can curl the endpoints without writing a
driver, and as living documentation of the wiring.

Usage:
  python -m gochugaru_tpu_torch.scripts.telemetryd [--port 0]
      [--sample-rate 1.0] [--checks 64] [--idle] [--incident-dir DIR]
      [--no-slo] [--device cuda|cpu]

Prints ``READY url=http://host:port`` on stdout once serving.  The demo
world is served on ``--device`` through a latency-mode client.  With
``--idle`` no demo world is built (bare registry — fastest start).
``--incident-dir`` (default: $GOCHUGARU_INCIDENT_DIR) lands flight-
recorder incident bundles there; the recorder itself is always
installed, so /debug/incidents serves in-memory bundles either way.
SIGTERM stops it as SIGINT does.
"""

import argparse
import os
import signal
import sys
import time

from . import add_device_arg, require_device


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--sample-rate", type=float, default=1.0)
    ap.add_argument("--checks", type=int, default=64,
                    help="demo checks to run before (and while) serving")
    ap.add_argument("--idle", action="store_true",
                    help="serve the bare registry; no demo world")
    ap.add_argument("--incident-dir",
                    default=os.environ.get("GOCHUGARU_INCIDENT_DIR") or None,
                    help="dump flight-recorder incident bundles here")
    ap.add_argument("--no-slo", action="store_true",
                    help="skip the SLO burn-rate engine")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    require_device(args.device)
    signal.signal(signal.SIGTERM, _interrupt)

    from ..utils import slo as slo_mod
    from ..utils import trace
    from ..utils.telemetry import TelemetryServer

    trace.configure(sample_rate=args.sample_rate, slow_threshold_s=0.1)
    recorder = trace.install_recorder(
        trace.FlightRecorder(incident_dir=args.incident_dir)
    )
    # install_engine, not a bare constructor: the process-global slot is
    # what enforces one evaluator per process and what the telemetry
    # endpoints' closed-engine fallback resolves through
    slo = None if args.no_slo else slo_mod.install_engine(slo_mod.SLOEngine())
    srv = TelemetryServer(
        port=args.port, host=args.host, slo=slo, recorder=recorder
    )
    print(f"READY url={srv.url}", flush=True)

    client = ctx = rs = None
    try:
        if not args.idle:
            from .. import consistency, rel
            from ..client import new_evaluator, with_latency_mode
            from ..utils.context import background

            client = new_evaluator(with_latency_mode(), device=args.device)
            ctx = background()
            client.write_schema(ctx, """
definition user {}
definition doc { relation reader: user  permission read = reader }
""")
            txn = rel.Txn()
            for i in range(32):
                txn.create(rel.must_from_triple(
                    f"doc:d{i}", "reader", f"user:u{i}"))
            client.write(ctx, txn)
            rs = [
                rel.must_from_triple(
                    f"doc:d{i % 32}", "read", f"user:u{(i * 7) % 32}")
                for i in range(16)
            ]
            for _ in range(max(args.checks // 16, 1)):
                client.check(ctx, consistency.full(), *rs)
            print(f"# demo world ready on {client.device}, {args.checks}"
                  " checks traced", file=sys.stderr, flush=True)

        while True:
            time.sleep(2.0)
            if client is not None:
                client.check(ctx, consistency.full(), *rs)  # keep numbers moving
    except KeyboardInterrupt:
        pass
    finally:
        if slo is not None:
            slo.close()
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
