"""Replica: one serving process that tails the shared watch stream.

A replica bootstraps a full world from the router (schema + columnar
export at a pinned revision), aligns its local revision counter to the
upstream numbering, then tails the router's replication stream —
``Store.entries_since`` on the authority side, ``apply_replicated`` on
this side — so every applied entry lands at its upstream revision and
zookies minted on write resolve identically everywhere.  The tail
cursor is the local head: a resume after any stream break re-subscribes
from it and ``apply_replicated``'s dup guard makes redelivered prefixes
no-ops (the same exactly-once discipline ``Client.updates_since_revision``
proved out, one layer down).

Serving: a framed-JSON wire server (fleet/wire.py) answering
``health`` / ``check`` / ``kill``.  Checks run through a full local
``Client`` on the card (``device=None``: ``cuda``, raising without one;
``device="cpu"`` runs the plain versions; a host-only client takes no
device) — verdict cache, admission gate/breaker, deadline shed — so
a replica sheds exactly like a single-process server and the router
treats the shed as per-replica backpressure.  ``health`` reports the
resident revision range (store snapshots + verdict-cache shards),
catchup lag, and the admission state; the router's ring membership and
freshness overrides are computed from it.

Crash realism: the ``replica.kill`` fault site (and the explicit
``kill`` op) makes the replica drop every connection mid-request and
stop serving — with ``exit_on_death`` (subprocess mode) the process
exits non-zero.  The router sees exactly what a SIGKILL looks like:
reset sockets and failed probes.

Run as a process: ``python -m gochugaru_tpu_torch.fleet.replica
--upstream HOST:PORT [--device cuda|cpu] [--host-only] [--latency-mode]``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from .. import consistency
from ..client import (
    Client,
    new_tpu_evaluator,
    with_host_only_evaluation,
    with_latency_mode,
    with_store,
    with_verdict_cache,
)
from ..store.store import Store
from ..utils import faults
from ..utils import metrics as _metrics
from ..utils.context import background
from ..utils.errors import (
    PermanentError,
    UnavailableError,
    classify_dispatch_exception,
)
from .config import FleetConfig
from . import wire as _wire


class Replica:
    """One fleet member: bootstrapped store + tailing thread + wire
    server.  In-process construction is what the tier-1 tests use; the
    module's ``main`` wraps the same object as a standalone process."""

    def __init__(
        self,
        upstream: Tuple[str, int],
        *,
        replica_id: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        config: Optional[FleetConfig] = None,
        client_options: Optional[tuple] = None,
        exit_on_death: bool = False,
        registry: Optional[_metrics.Metrics] = None,
        device=None,
    ) -> None:
        self._cfg = config or FleetConfig()
        self._m = registry or _metrics.default
        self._upstream = upstream
        self._exit_on_death = exit_on_death
        self._dead = False
        self._stop = threading.Event()
        self._tail_gate = threading.Event()  # cleared = paused (tests)
        self._tail_gate.set()
        self._tail_err: Optional[BaseException] = None

        self._store = Store()
        #: the bootstrap's seconds: receiving and decoding the export
        #: (``stream_s``), importing it (``import_s``), materializing the
        #: first snapshot (``materialize_s``), and its relationships
        self.bootstrap_stats: Dict[str, float] = {}
        base = self._bootstrap()
        self._upstream_head = base
        self._client: Client = new_tpu_evaluator(
            with_store(self._store),
            *(client_options if client_options is not None
              else (with_verdict_cache(),)),
            device=device,
        )
        # materialize the bootstrap world so MIN_LATENCY reads serve
        # immediately and the residency report starts at the base revision
        t0 = time.perf_counter()
        self._store.snapshot_for(consistency.full())
        self.bootstrap_stats["materialize_s"] = time.perf_counter() - t0

        self.id = replica_id or f"replica-{os.getpid()}"
        self._server = _wire.WireServer(
            self._handle, host=host, port=port, name=f"fleet-{self.id}"
        )
        self.host, self.port = self._server.host, self._server.port
        self._tail_thread = threading.Thread(
            target=self._tail_loop, daemon=True, name=f"{self.id}-tail"
        )
        self._tail_thread.start()

    # -- bootstrap --------------------------------------------------------
    def _bootstrap(self) -> int:
        boot = _wire.Conn(
            self._upstream,
            connect_timeout=self._cfg.connect_timeout_s,
            io_timeout=self._cfg.io_timeout_s,
        )
        try:
            meta = boot.request({"op": "bootstrap"})
            base = int(meta["revision"])
            self._store.write_schema(meta["schema"])
            stream_s, n = 0.0, 0

            def frames():
                nonlocal stream_s, n
                t = time.perf_counter()
                for frame in boot.stream({"op": "export", "revision": base}):
                    rels = [_wire.rel_from_wire(d) for d in frame.get("rels", ())]
                    stream_s += time.perf_counter() - t
                    n += len(rels)
                    yield rels
                    t = time.perf_counter()

            # ONE import: the local schema write and this import mint
            # revisions 1 and 2, which alignment fast-forwards to the
            # base.  An import a frame would mint one revision a frame,
            # past the base of any world larger than (base - 1) frames,
            # and alignment refuses to rewind.  Past COLUMNAR_IMPORT_MIN
            # relationships each frame is lowered to int columns as it
            # arrives, so the objects alive stay bounded at any world size
            t0 = time.perf_counter()
            self._store.import_relationship_batches(frames())
            self.bootstrap_stats.update(
                stream_s=stream_s,
                import_s=time.perf_counter() - t0 - stream_s,
                relationships=n,
            )
            # local schema/import revisions were provisional numbering;
            # from here on this store counts in upstream revisions
            self._store.align_replica_head(base)
            return base
        finally:
            boot.close()

    # -- replication tail -------------------------------------------------
    def _tail_loop(self) -> None:
        resumes = 0
        while not self._stop.is_set():
            conn = None
            try:
                conn = _wire.Conn(
                    self._upstream,
                    connect_timeout=self._cfg.connect_timeout_s,
                    io_timeout=max(self._cfg.heartbeat_s * 20, 10.0),
                )
                # cursor = local head: apply_replicated's dup guard makes
                # any redelivered prefix a no-op (exactly-once)
                since = self._store.head_revision
                paused_skips = False
                for frame in conn.stream({"op": "stream", "since": since}):
                    if self._stop.is_set():
                        return
                    gate_open = self._tail_gate.is_set()
                    if gate_open and paused_skips:
                        # entries were skipped while paused: resubscribe
                        # from the local head so they are redelivered
                        # (dup guard keeps the overlap exactly-once)
                        break
                    head = frame.get("head")
                    if head is not None:
                        self._upstream_head = max(
                            self._upstream_head, int(head)
                        )
                    if frame.get("rev") is not None:
                        if not gate_open:
                            # paused (test lag induction): keep tracking
                            # the upstream head but apply nothing
                            paused_skips = True
                        else:
                            ups = [
                                _wire.update_from_wire(d)
                                for d in frame.get("updates", ())
                            ]
                            faults.fire("replica.apply")
                            local = self._store.head_revision
                            self._store.apply_replicated(
                                int(frame["rev"]), ups
                            )
                            resumes = 0
                            self._m.inc("fleet.applied_entries")
                            if int(frame["rev"]) - local > 1:
                                # a group-committed entry: one frame,
                                # one advance, head jumps base→base+k
                                self._m.inc("fleet.group_applies")
                            self._advance_serving()
                    self._m.set_gauge(
                        f"fleet.catchup_lag.{self.id}", float(self.lag())
                    )
            except BaseException as e:
                if self._stop.is_set():
                    return
                if classify_dispatch_exception(e) is None:
                    # an unclassified tail failure is a real bug: stop
                    # advancing and let health report it (the router
                    # drains a stalled replica via the ready gate)
                    self._tail_err = e
                    return
                resumes += 1
                self._m.inc("fleet.tail_resumes")
            finally:
                if conn is not None:
                    conn.close()
            self._stop.wait(min(0.002 * resumes, 0.1))

    def _advance_serving(self) -> None:
        """Make the just-applied head the generation MIN_LATENCY serves,
        and retire verdict-cache shards for generations the store no
        longer keeps.

        ``apply_replicated`` advances the live table and the head
        revision but materializes nothing, and ``snapshot_for`` under
        MinLatency serves the freshest MATERIALIZED generation — so
        without this step a replica keeps answering from its
        bootstrap-era world (and that world's cached verdicts) no matter
        how many deltas it applies.  Materializing here is the
        watch-driven re-index discipline: a delta advance off the
        previous generation, not a rebuild.  The shard drop mirrors the
        client's snapshot-LRU eviction hook — a verdict-cache revision
        whose store generation is gone can never be pin-validated again,
        it is pure dead weight — and counts each retirement as
        ``fleet.vcache_invalidations``.

        On a device client the entry also goes through the device
        prepare here, from the previous revision's resident snapshot (the
        delta chain, engine/device.py ``_prepare_delta``), not in the
        first check that reads it: entries applied between two checks
        would otherwise reach that check with their predecessor
        unprepared, and pay a full prepare."""
        snap = self._store.snapshot_for(consistency.full())
        engine = self._client._engine_for(snap)
        if engine is not None:
            self._client._dsnap_for(engine, snap)
        vc = self._client._vcache
        if vc is None:
            return
        resident = set(self._store.resident_revisions())
        for rev in vc.resident_revisions:
            if rev not in resident:
                vc.drop_revision(rev)
                self._m.inc("fleet.vcache_invalidations")

    # -- state ------------------------------------------------------------
    @property
    def head(self) -> int:
        return self._store.head_revision

    def lag(self) -> int:
        return max(0, self._upstream_head - self._store.head_revision)

    def ready(self) -> bool:
        return (
            not self._dead
            and self._tail_err is None
            and self.lag() <= self._cfg.ready_lag
        )

    def health(self) -> Dict[str, Any]:
        vc = self._client._vcache
        return {
            "ok": True,
            "replica": self.id,
            "head": self.head,
            "upstream_head": self._upstream_head,
            "lag": self.lag(),
            "ready": self.ready(),
            "dead": self._dead,
            "tail_error": repr(self._tail_err) if self._tail_err else None,
            # residency: materialized store generations + verdict-cache
            # revision shards — what the router's exact-snapshot
            # placement reads
            "resident": self._store.resident_revisions(),
            "cache": None if vc is None else vc.residency(),
            "admission": self._client._admission.report(),
        }

    # -- test hooks -------------------------------------------------------
    def pause_tail(self) -> None:
        """Stop applying streamed entries (lag induction for tests)."""
        self._tail_gate.clear()

    def resume_tail(self) -> None:
        self._tail_gate.set()

    # -- serving ----------------------------------------------------------
    def _handle(self, msg: Dict[str, Any], sock) -> Optional[Dict[str, Any]]:
        try:
            # the kill site fires on ANY op — a dead replica fails health
            # probes and checks alike, which is what drives the router's
            # eviction path in the chaos soak
            faults.fire("replica.kill")
        except BaseException:
            self.die()
            raise _wire.WireClosed("replica killed by fault injection")
        if self._dead:
            raise _wire.WireClosed("replica is dead")
        op = msg.get("op")
        if op == "health":
            return self.health()
        if op == "check":
            if not self.ready():
                raise UnavailableError(
                    f"replica {self.id} catching up (lag={self.lag()})"
                )
            cs = _wire.strategy_from_wire(msg["cs"])
            rels = [_wire.rel_from_wire(d) for d in msg["rels"]]
            ctx = background().with_timeout(
                float(msg.get("deadline_s") or self._cfg.io_timeout_s)
            )
            with self._m.timer("fleet.replica_check_s"):
                verdicts = self._client.check(ctx, cs, *rels)
            return {
                "ok": True,
                "replica": self.id,
                "head": self.head,
                "verdicts": [bool(v) for v in verdicts],
            }
        if op == "kill":
            self.die()
            raise _wire.WireClosed("replica killed")
        raise PermanentError(f"unknown replica op {op!r}")

    # -- lifecycle --------------------------------------------------------
    def die(self) -> None:
        """Crash, not shutdown: stop serving and hard-close every
        connection so peers see resets mid-request."""
        if self._dead:
            return
        self._dead = True
        self._stop.set()
        self._tail_gate.set()
        self._m.inc("fleet.replica_deaths")
        self._server.close(abort=True)
        if self._exit_on_death:
            os._exit(1)

    def close(self) -> None:
        """Graceful teardown (tests, clean process exit)."""
        self._dead = True
        self._stop.set()
        self._tail_gate.set()
        self._server.close(abort=True)
        self._tail_thread.join(2.0)


def main(argv=None, *, on_exit=None) -> int:
    """The replica process.  ``on_exit(replica)``, where given, runs after
    a clean stop (SIGINT) has closed the replica."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="gochugaru fleet replica")
    ap.add_argument("--upstream", required=True, help="router HOST:PORT")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--id", default=None)
    ap.add_argument("--ready-lag", type=int, default=None)
    ap.add_argument(
        "--device", default="cuda",
        help="the client's device: cuda (the kernels) or cpu (the plain"
             " versions)",
    )
    ap.add_argument(
        "--host-only", action="store_true",
        help="host-path evaluation (no device dispatch)",
    )
    ap.add_argument(
        "--latency-mode", action="store_true",
        help="pinned small-batch dispatch path",
    )
    ap.add_argument(
        "--join", action="store_true",
        help="ask the router to admit this replica (its 'join' op) once"
             " serving starts",
    )
    args = ap.parse_args(argv)

    host, _, port = args.upstream.rpartition(":")
    cfg = FleetConfig()
    if args.ready_lag is not None:
        from dataclasses import replace

        cfg = replace(cfg, ready_lag=args.ready_lag)
    opts = [with_verdict_cache()]
    if args.host_only:
        opts.append(with_host_only_evaluation())
    if args.latency_mode:
        opts.append(with_latency_mode())

    from ..utils import decisions as _decisions

    replica_id = args.id or f"replica-{os.getpid()}"
    # satellite: every decision-log entry this process emits carries its
    # replica identity
    _decisions.set_identity(replica_id)
    r = Replica(
        (host, int(port)),
        replica_id=replica_id,
        host=args.host,
        port=args.port,
        config=cfg,
        client_options=tuple(opts),
        exit_on_death=True,
        device=args.device,
    )
    print(
        "REPLICA-READY "
        + json.dumps({"id": r.id, "host": r.host, "port": r.port,
                      "bootstrap": r.bootstrap_stats}),
        flush=True,
    )
    if args.join:
        jc = _wire.Conn((host, int(port)))
        try:
            jr = jc.request({
                "op": "join", "host": r.host, "port": r.port,
                "wait_ready_s": 60.0,
            })
            print(f"JOINED ring={jr['ring']}", flush=True)
        finally:
            jc.close()
    try:
        while not r._stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        r.close()
        if on_exit is not None:
            on_exit(r)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
