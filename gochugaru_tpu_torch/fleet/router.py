"""Front router: consistent-hash placement with freshness overrides.

The router owns the authoritative ``Store`` — every write lands here,
mints a revision, and is pushed to replicas over the replication stream
(``Store.entries_since`` served by the router's wire server).  Reads
route to replicas:

- **Placement** — a consistent-hash ring (virtual nodes) keyed by the
  resource id, so a check batch splits into per-owner sub-batches and
  each replica's verdict cache sees a stable keyspace slice.
- **Freshness override** — ``consistency.policy_for`` maps the caller's
  strategy (plus any zookie) to a minimum revision; an owner whose
  resident head hasn't reached it is overridden to any sufficiently
  fresh ring member, and when *no* member is fresh enough the dispatch
  blocks (bounded, probing as it waits) for catchup — block-or-redirect,
  never stale.
- **Failover** — health probes (``kill_threshold`` consecutive misses)
  and classified transport errors on the dispatch path evict a replica
  from the ring, fire the ``fleet.failover`` incident trigger, and
  re-route the affected sub-batch to a survivor within the same attempt;
  the client-facing retry envelope (``retry_retriable_errors``) is the
  outer backstop.  Checks are idempotent reads, so re-dispatch loses and
  duplicates nothing.  A restarted replica re-enters the ring only when
  its health reports ready (caught up past the ready-lag gate).

Fault sites on this path: ``router.dispatch`` (fires before each
sub-batch dispatch) and ``router.health`` (fires before each probe) —
both armed by the chaos soak.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .. import consistency
from ..rel.relationship import as_relationship
from ..rel.txn import Txn
from ..rel.update import UpdateType
from ..store.store import RevisionToken, Store, parse_revision
from ..utils import faults
from ..utils import metrics as _metrics
from ..utils import trace as _trace
from ..utils.context import Context, background
from ..utils.errors import (
    PermanentError,
    RevisionUnavailableError,
    TRANSPORT_ERRORS,
    UnavailableError,
    classify_dispatch_exception,
    is_retriable,
)
from ..utils.retry import retry_retriable_errors
from .config import FleetConfig
from . import wire as _wire
from . import zookie as _zookie


def _hash64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.  Not thread-safe; the
    router mutates it under its own lock."""

    def __init__(self, vnodes: int = 32) -> None:
        self._vnodes = vnodes
        self._points: List[Tuple[int, str]] = []  # sorted (hash, member)
        self._members: Set[str] = set()

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for v in range(self._vnodes):
            bisect.insort(self._points, (_hash64(f"{member}#{v}"), member))

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        self._points = [p for p in self._points if p[1] != member]

    def members(self) -> Set[str]:
        return set(self._members)

    def owner(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        h = _hash64(key)
        i = bisect.bisect_right(self._points, (h, "\uffff"))
        if i == len(self._points):
            i = 0
        return self._points[i][1]


class _ReplicaHandle:
    """Router-side view of one replica: address, pooled connections, and
    the last-probed health (head / lag / readiness / residency)."""

    def __init__(self, addr: Tuple[str, int], cfg: FleetConfig) -> None:
        self.id = ""
        self.addr = addr
        self.cfg = cfg
        self.in_ring = False
        self.fails = 0
        self.head = 0
        self.lag = 0
        self.ready = False
        self.resident: List[int] = []
        self._pool: List[_wire.Conn] = []
        self._lock = threading.Lock()

    def request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            conn = self._pool.pop() if self._pool else None
        if conn is None:
            conn = _wire.Conn(
                self.addr,
                connect_timeout=self.cfg.connect_timeout_s,
                io_timeout=self.cfg.io_timeout_s,
            )
        try:
            out = conn.request(msg)
        except BaseException:
            conn.close()
            raise
        with self._lock:
            if len(self._pool) < 4:
                self._pool.append(conn)
            else:
                conn.close()
        return out

    def probe(self, timeout: float) -> Dict[str, Any]:
        """Health check on a fresh short-timeout connection — probe
        latency must not ride the (long) dispatch io timeout."""
        c = _wire.Conn(self.addr, connect_timeout=timeout, io_timeout=timeout)
        try:
            return c.request({"op": "health"})
        finally:
            c.close()

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, []
        for c in pool:
            c.close()


class FleetRouter:
    """The authority + front: owns the store, serves the replication
    stream, and routes checks across the replica ring."""

    def __init__(
        self,
        store: Optional[Store] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        config: Optional[FleetConfig] = None,
        registry: Optional[_metrics.Metrics] = None,
    ) -> None:
        self._store = store if store is not None else Store()
        self._cfg = config or FleetConfig()
        self._m = registry or _metrics.default
        self._replicas: Dict[str, _ReplicaHandle] = {}
        self._ring = HashRing(self._cfg.vnodes)
        self._lock = threading.RLock()
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=self._cfg.dispatch_workers,
            thread_name_prefix="fleet-dispatch",
        )
        self._server = _wire.WireServer(
            self._serve, host=host, port=port, name="fleet-router"
        )
        self.host, self.port = self._server.host, self._server.port
        self._prober = threading.Thread(
            target=self._probe_loop, daemon=True, name="fleet-prober"
        )
        self._prober.start()

    # -- properties -------------------------------------------------------
    @property
    def store(self) -> Store:
        return self._store

    @property
    def head_revision(self) -> int:
        return self._store.head_revision

    # -- write path (authority) ------------------------------------------
    def write_schema(self, ctx: Context, schema: str) -> str:
        return self._store.write_schema(schema)

    def write(self, ctx: Context, txn: Txn) -> str:
        """Apply a transaction on the authority and mint the zookie the
        client presents for read-your-writes."""
        token = self._store.write(txn)
        self._m.inc("fleet.writes")
        return _zookie.mint(token, self._cfg.zookie_key)

    def write_group(self, ctx: Context, txns: Sequence[Txn]) -> List[object]:
        """Group-commit on the authority (store/group.py semantics): the
        whole group lands as ONE log entry, so the watch stream carries
        it to every replica as ONE frame and each replica applies it as
        one advance under the same exactly-once cursor discipline as a
        single write.  Returns per-transaction outcomes in order: a
        minted zookie for survivors, the ejecting exception otherwise."""
        outcomes = self._store.write_group(txns)
        minted = 0
        for i, out in enumerate(outcomes):
            if not isinstance(out, BaseException):
                outcomes[i] = _zookie.mint(out, self._cfg.zookie_key)
                minted += 1
        self._m.inc("fleet.writes", minted)
        if minted:
            self._m.inc("fleet.write_groups")
        return outcomes

    # -- membership -------------------------------------------------------
    def add_replica(
        self, host: str, port: int, *, wait_ready_s: Optional[float] = None
    ) -> str:
        """Register a replica; it joins the ring on its first ready
        probe.  ``wait_ready_s`` blocks until then (bench/smoke setup)."""
        h = _ReplicaHandle((host, port), self._cfg)
        r = h.probe(self._cfg.probe_timeout_s)
        h.id = str(r["replica"])
        with self._lock:
            self._replicas[h.id] = h
        self._apply_probe(h, r)
        if wait_ready_s:
            deadline = time.monotonic() + wait_ready_s
            while not h.in_ring and time.monotonic() < deadline:
                time.sleep(0.02)
                try:
                    self._apply_probe(h, h.probe(self._cfg.probe_timeout_s))
                except Exception:
                    pass
            if not h.in_ring:
                raise UnavailableError(
                    f"replica {h.id} did not become ready in {wait_ready_s}s"
                )
        self._publish_ring()
        return h.id

    def remove_replica(self, replica_id: str) -> None:
        with self._lock:
            h = self._replicas.pop(replica_id, None)
            if h is not None and h.in_ring:
                self._ring.remove(h.id)
                h.in_ring = False
        if h is not None:
            h.close()
        self._publish_ring()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            handles = list(self._replicas.values())
            ring = sorted(self._ring.members())
        return {
            "head": self.head_revision,
            "ring": ring,
            "replicas": {
                h.id: {
                    "head": h.head,
                    "lag": h.lag,
                    "ready": h.ready,
                    "in_ring": h.in_ring,
                    "fails": h.fails,
                }
                for h in handles
            },
        }

    # -- health probing ---------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._closed:
            with self._lock:
                handles = list(self._replicas.values())
            for h in handles:
                if self._closed:
                    return
                self._probe_once(h)
            if handles:
                self._m.set_gauge(
                    "fleet.max_catchup_lag",
                    float(max(h.lag for h in handles)),
                )
            time.sleep(self._cfg.probe_interval_s)

    def _probe_once(self, h: _ReplicaHandle) -> None:
        try:
            faults.fire("router.health")
            r = h.probe(self._cfg.probe_timeout_s)
        except BaseException as e:
            h.fails += 1
            self._m.inc("fleet.probe_failures")
            if h.fails >= self._cfg.kill_threshold and h.in_ring:
                self._evict(
                    h,
                    cause=f"{h.fails} consecutive probe failures: {e!r}",
                    kill=True,
                )
            return
        self._apply_probe(h, r)

    def _apply_probe(self, h: _ReplicaHandle, r: Dict[str, Any]) -> None:
        h.fails = 0
        h.head = max(h.head, int(r.get("head", 0)))
        h.lag = int(r.get("lag", 0))
        h.ready = bool(r.get("ready"))
        h.resident = [int(x) for x in r.get("resident", ())]
        if r.get("dead"):
            if h.in_ring:
                self._evict(h, cause="replica reports dead", kill=True)
            return
        if h.ready and not h.in_ring:
            self._join(h)
        elif not h.ready and h.in_ring:
            # catching up or shedding — drain without the failover alarm
            self._evict(
                h, cause=f"not ready (lag={h.lag})", kill=False
            )

    def _join(self, h: _ReplicaHandle) -> None:
        with self._lock:
            self._ring.add(h.id)
            h.in_ring = True
        self._m.inc("fleet.rejoins")
        self._publish_ring()

    def _evict(self, h: _ReplicaHandle, *, cause: str, kill: bool) -> None:
        with self._lock:
            if not h.in_ring:
                return
            self._ring.remove(h.id)
            h.in_ring = False
            survivors = sorted(self._ring.members())
        self._m.inc("fleet.evictions")
        self._publish_ring()
        if kill:
            self._m.inc("fleet.kill_detections")
            _trace.trigger_incident(
                "fleet.failover", replica=h.id, cause=cause, ring=survivors
            )

    def _publish_ring(self) -> None:
        with self._lock:
            self._m.set_gauge("fleet.ring_size", float(len(self._ring.members())))
            self._m.set_gauge("fleet.replicas", float(len(self._replicas)))

    # -- routed check -----------------------------------------------------
    def check(
        self, ctx: Context, cs: consistency.Strategy, *rs,
        zookie: Optional[str] = None,
    ) -> List[bool]:
        """Routed batched check.  ``zookie`` raises the freshness floor
        to the write that minted it (read-your-writes); an invalid token
        fails permanently before any dispatch."""
        rels = [as_relationship(r) for r in rs]
        if not rels:
            return []
        zrev = (
            _zookie.parse(zookie, self._cfg.zookie_key)
            if zookie is not None
            else None
        )
        with self._m.timer("fleet.check_s"):
            return retry_retriable_errors(
                ctx, lambda: self._dispatch(ctx, cs, zrev, rels)
            )

    def _dispatch(
        self,
        ctx: Context,
        cs: consistency.Strategy,
        zrev: Optional[int],
        rels: List,
    ) -> List[bool]:
        mode, rev_tok = consistency.policy_for(cs)
        head = self._store.head_revision
        if mode == "head":
            min_rev = head
        elif mode == "any":
            min_rev = 0
        else:
            min_rev = parse_revision(rev_tok or "")
        fwd = cs
        if mode == "head":
            # FULL pins "the head at dispatch": replicas evaluate
            # at-least that revision, which is read-your-writes for
            # every write committed before this call
            fwd = consistency.at_least(RevisionToken(min_rev))
        if zrev is not None and mode != "exact":
            if zrev > min_rev:
                min_rev = zrev
                fwd = consistency.at_least(RevisionToken(min_rev))
        if min_rev > head:
            # mirrors Store.snapshot_for's AT_LEAST contract: a token
            # from the future is a permanent client error, not a wait
            raise RevisionUnavailableError(
                f"revision {min_rev} is in the future (head {head})"
            )

        with self._lock:
            groups: Dict[Optional[str], List[int]] = {}
            for i, r in enumerate(rels):
                owner = self._ring.owner(f"{r.resource_type}:{r.resource_id}")
                groups.setdefault(owner, []).append(i)
        out: List[Optional[bool]] = [None] * len(rels)
        self._m.inc("fleet.dispatches", len(groups))
        futures = [
            (
                idxs,
                self._pool.submit(
                    self._dispatch_group, ctx, owner, mode, min_rev, fwd,
                    [rels[i] for i in idxs],
                ),
            )
            for owner, idxs in groups.items()
        ]
        for idxs, fut in futures:
            verdicts = fut.result()
            for i, v in zip(idxs, verdicts):
                out[i] = v
        return [bool(v) for v in out]

    def _dispatch_group(
        self,
        ctx: Context,
        owner_id: Optional[str],
        mode: str,
        min_rev: int,
        fwd: consistency.Strategy,
        sub: List,
    ) -> List[bool]:
        """One sub-batch: owner-preferred, freshness-overridden, with
        in-attempt failover.  ``failed`` accumulates replicas this
        attempt already saw fail — a transport failure also feeds the
        eviction path immediately instead of waiting out the prober."""
        failed: Set[str] = set()
        wait_deadline = time.monotonic() + self._cfg.freshness_wait_s
        waited = False
        msg = {
            "op": "check",
            "cs": _wire.strategy_to_wire(fwd),
            "rels": [_wire.rel_to_wire(r) for r in sub],
        }
        while True:
            err = ctx.err()
            if err is not None:
                raise err
            h = self._select(owner_id, mode, min_rev, failed)
            if h is None:
                if time.monotonic() >= wait_deadline:
                    raise UnavailableError(
                        f"no replica fresh enough for revision {min_rev}"
                        f" (mode={mode}, failed={sorted(failed)})"
                    )
                if not waited:
                    waited = True
                    self._m.inc("fleet.fresh_waits")
                # block-or-redirect, never stale: probe for catchup at
                # the poll cadence instead of trusting the (slower)
                # background prober
                with self._lock:
                    candidates = [
                        self._replicas[m]
                        for m in self._ring.members()
                        if m not in failed
                    ]
                for c in candidates:
                    try:
                        self._apply_probe(
                            c, c.probe(self._cfg.probe_timeout_s)
                        )
                    except Exception:
                        pass
                ctx.wait(self._cfg.freshness_poll_s)
                continue
            try:
                faults.fire("router.dispatch")
                resp = h.request(msg)
            except BaseException as e:
                classified = classify_dispatch_exception(e)
                if classified is None:
                    raise
                if not is_retriable(classified):
                    raise classified
                if isinstance(e, TRANSPORT_ERRORS):
                    # a reset/refused socket IS the death signal — don't
                    # wait for the prober to notice
                    h.fails += 1
                    if (
                        h.fails >= self._cfg.kill_threshold and h.in_ring
                    ):
                        self._evict(
                            h,
                            cause=f"transport failure on dispatch: {e!r}",
                            kill=True,
                        )
                failed.add(h.id)
                self._m.inc("fleet.reroutes")
                continue
            h.head = max(h.head, int(resp.get("head", 0)))
            return [bool(v) for v in resp["verdicts"]]

    def _select(
        self,
        owner_id: Optional[str],
        mode: str,
        min_rev: int,
        failed: Set[str],
    ) -> Optional[_ReplicaHandle]:
        with self._lock:
            members = [
                self._replicas[m]
                for m in self._ring.members()
                if m not in failed
            ]
        if mode == "exact":
            eligible = [
                h for h in members
                if min_rev in h.resident or h.head == min_rev
            ]
        else:
            eligible = [h for h in members if h.head >= min_rev]
        if not eligible:
            return None
        for h in eligible:
            if h.id == owner_id:
                return h
        if owner_id is not None and any(h.id == owner_id for h in members):
            # the owner is alive but not fresh enough: freshness override
            self._m.inc("fleet.freshness_redirects")
        return max(eligible, key=lambda h: h.head)

    # -- wire front (replica bootstrap/stream + remote clients) ----------
    def _serve(self, msg: Dict[str, Any], sock) -> Optional[Dict[str, Any]]:
        op = msg.get("op")
        if op == "bootstrap":
            snap = self._store.snapshot_for(consistency.full())
            schema, _ = self._store.read_schema()
            return {"ok": True, "schema": schema, "revision": snap.revision}
        if op == "export":
            rev = int(msg["revision"])
            batch: List[Dict[str, Any]] = []
            for r in self._store.export_at(RevisionToken(rev)):
                batch.append(_wire.rel_to_wire(r))
                if len(batch) >= self._cfg.bootstrap_chunk:
                    _wire.send_frame(sock, {"rels": batch})
                    batch = []
            if batch:
                _wire.send_frame(sock, {"rels": batch})
            _wire.send_frame(sock, {"ok": True, "eof": True})
            return None
        if op == "stream":
            since = int(msg.get("since", 0))
            for rev, ups in self._store.entries_since(
                since,
                heartbeats=True,
                poll_interval=self._cfg.heartbeat_s,
                cancelled=lambda: self._closed,
            ):
                if ups is None:
                    _wire.send_frame(sock, {"head": rev})
                else:
                    _wire.send_frame(
                        sock,
                        {
                            "rev": rev,
                            "head": self._store.head_revision,
                            "updates": [_wire.update_to_wire(u) for u in ups],
                        },
                    )
            _wire.send_frame(sock, {"ok": True, "eof": True})
            return None
        if op == "join":
            # self-service membership (the replica process's --join): the
            # replica asks to be admitted; it enters the ring on its
            # first ready probe like any other member
            rid = self.add_replica(
                str(msg["host"]), int(msg["port"]),
                wait_ready_s=msg.get("wait_ready_s"),
            )
            return {"ok": True, "replica": rid, "ring": self.status()["ring"]}
        if op == "write":
            txn = Txn()
            for d in msg.get("updates", ()):
                u = _wire.update_from_wire(d)
                if u.update_type == UpdateType.CREATE:
                    txn.create(u.relationship)
                elif u.update_type == UpdateType.TOUCH:
                    txn.touch(u.relationship)
                else:
                    txn.delete(u.relationship)
            zk = self.write(background(), txn)
            return {
                "ok": True,
                "zookie": zk,
                "revision": RevisionToken(self._store.head_revision),
            }
        if op == "check":
            cs = _wire.strategy_from_wire(msg["cs"])
            rels = [_wire.rel_from_wire(d) for d in msg["rels"]]
            ctx = background().with_timeout(
                float(msg.get("deadline_s") or self._cfg.io_timeout_s)
            )
            verdicts = self.check(ctx, cs, *rels, zookie=msg.get("zookie"))
            return {
                "ok": True,
                "verdicts": verdicts,
                "head": self._store.head_revision,
            }
        if op == "health":
            st = self.status()
            st["ok"] = True
            st["role"] = "router"
            return st
        raise PermanentError(f"unknown router op {op!r}")

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        self._server.close(abort=True)
        self._pool.shutdown(wait=False)
        with self._lock:
            handles = list(self._replicas.values())
        for h in handles:
            h.close()
        self._prober.join(2.0)
