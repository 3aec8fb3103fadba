"""Fleet daemon: run one fleet process — the router (authority store +
consistent-hash placement + zookie minting) or a replica (bootstraps
from the router, tails the replication stream, serves checks on
``--device``).

A minimal local fleet, three terminals:

  # 1. the router (authority); prints ROUTER-READY with its port
  python -m gochugaru_tpu_torch.scripts.fleetd router --port 7411 --demo-world

  # 2..n. replicas; each bootstraps, catches up, and serves
  python -m gochugaru_tpu_torch.scripts.fleetd replica --upstream 127.0.0.1:7411 --id r0
  python -m gochugaru_tpu_torch.scripts.fleetd replica --upstream 127.0.0.1:7411 --id r1

Replicas self-announce to the router?  No — membership is the
operator's (or supervisor's) call: POST a ``health`` probe yourself or
use ``--join`` below, which asks the router to admit the replica once
it reports ready.

Router options: ``--demo-world`` writes a tiny schema + relationships
so zookie round trips work out of the box; ``--incident-dir`` installs
a flight recorder so ``fleet.failover`` incidents land as bundles.  The
router holds the store and no device.

Replica options: ``--device cuda`` (the default: the kernels, exiting at
once without a card) or ``cpu`` (the plain versions); ``--host-only``
(the host oracle, no device); ``--latency-mode``; ``--join``.  A clean
stop (SIGINT or SIGTERM) prints one line,
``REPLICA-EXIT {"id", "device", "launches", "captures", "prepares",
"prepare_s"}``: the process's own probe-kernel launches by mode, its
latency-graph captures, and its full prepares with their seconds.
"""

import argparse
import json
import os
import signal
import sys
import time

from . import add_device_arg, require_device


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def run_router(args) -> int:
    from ..fleet import FleetRouter
    from ..utils import trace
    from ..utils.context import background

    if args.incident_dir:
        trace.install_recorder(
            trace.FlightRecorder(incident_dir=args.incident_dir)
        )
    router = FleetRouter(host=args.host, port=args.port)
    try:
        if args.demo_world:
            from .. import rel

            ctx = background()
            router.write_schema(ctx, """
            definition user {}
            definition doc {
                relation owner: user
                relation reader: user
                permission read = reader + owner
            }
            """)
            txn = rel.Txn()
            for i in range(32):
                txn.touch(rel.must_from_triple(
                    f"doc:d{i}", "owner", f"user:u{i % 8}"
                ))
            router.write(ctx, txn)
        print(f"ROUTER-READY host={router.host} port={router.port}"
              f" head={router.head_revision}", flush=True)
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
    return 0


def exit_report(replica) -> dict:
    """What a replica process did on its device: the REPLICA-EXIT line's
    object."""
    from ..engine import kernels as K
    from ..utils import metrics

    dev = replica._client.device
    snap = metrics.default.snapshot()
    return {
        "id": replica.id,
        "device": "host" if dev is None else dev.type,
        "launches": {k: v for k, v in K.LAUNCHES.items() if v},
        "captures": int(metrics.default.counter("latency.compiles")),
        # full device prepares and their seconds (a delta prepare is not one)
        "prepares": int(snap.get("prepare.total_s.count", 0)),
        "prepare_s": float(snap.get("prepare.total_s.total_s", 0.0)),
    }


def run_replica(args) -> int:
    # the replica module's own CLI does the work (REPLICA-READY line,
    # exit-on-death crash semantics); --join additionally sends the
    # router a ``join`` op so this replica enters the ring without an
    # operator calling add_replica by hand
    from ..fleet import replica as replica_mod

    if not args.host_only:
        require_device(args.device)
    argv = ["--upstream", args.upstream, "--host", args.host,
            "--port", str(args.port), "--device", args.device]
    if args.id:
        argv += ["--id", args.id]
    if args.host_only:
        argv.append("--host-only")
    if args.latency_mode:
        argv.append("--latency-mode")
    if args.join:
        argv.append("--join")

    def on_exit(r):
        print("REPLICA-EXIT " + json.dumps(exit_report(r)), flush=True)

    return replica_mod.main(argv, on_exit=on_exit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="gochugaru fleet daemon")
    sub = ap.add_subparsers(dest="role", required=True)

    rt = sub.add_parser("router", help="authority store + placement")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=0)
    rt.add_argument("--demo-world", action="store_true",
                    help="write a small schema+world so checks work"
                         " out of the box")
    rt.add_argument("--incident-dir",
                    default=os.environ.get("GOCHUGARU_INCIDENT_DIR") or None)

    rp = sub.add_parser("replica", help="bootstrapped serving replica")
    rp.add_argument("--upstream", required=True, help="router HOST:PORT")
    rp.add_argument("--host", default="127.0.0.1")
    rp.add_argument("--port", type=int, default=0)
    rp.add_argument("--id", default=None)
    rp.add_argument("--host-only", action="store_true")
    rp.add_argument("--latency-mode", action="store_true")
    rp.add_argument("--join", action="store_true",
                    help="probe the router once serving starts")
    add_device_arg(rp)

    args = ap.parse_args(argv)
    signal.signal(signal.SIGTERM, _interrupt)
    if args.role == "router":
        return run_router(args)
    return run_replica(args)


if __name__ == "__main__":
    sys.exit(main())
