"""The port's fleet daemon (``python -m gochugaru_tpu_torch.scripts.fleetd``)
as processes on the CPU, held against the reference's
``scripts/fleetd.py``.

- The demo world: the port's router role and the reference's, each with
  one replica process of its own package, give equal verdicts through
  the wire ``check`` op on every (doc, user) pair.
- A port router in this process with two ``fleetd replica --device cpu
  --join`` processes survives a SIGKILL of one, every answer equal to the
  reference's host oracle on the same relationships, then admits a
  restarted process; SIGINT makes each survivor print ``REPLICA-EXIT``.

Every child is killed in a ``finally``; every wait has a timeout.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from dataclasses import replace

import numpy as np

from gochugaru_tpu import consistency as jconsistency
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import new_tpu_evaluator as j_new_tpu_evaluator
from gochugaru_tpu.client import with_host_only_evaluation as j_host_only
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency, rel
from gochugaru_tpu_torch.fleet import FleetConfig, FleetRouter
from gochugaru_tpu_torch.fleet import wire as fwire
from gochugaru_tpu_torch.scripts.procs import ROOT, Child, close_all, module_argv
from gochugaru_tpu_torch.utils import metrics as _metrics
from gochugaru_tpu_torch.utils.context import background

FLEETD = "gochugaru_tpu_torch.scripts.fleetd"
#: children run torch on one thread, as the port's CPU tests do
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
BOOT_S = 60.0


def _addr(line: str):
    kv = dict(w.split("=", 1) for w in line.split()[1:])
    return kv["host"], int(kv["port"])


def _wire_check(addr, rels):
    conn = fwire.Conn(addr, connect_timeout=5.0, io_timeout=30.0)
    try:
        r = conn.request({
            "op": "check",
            "cs": fwire.strategy_to_wire(consistency.full()),
            "rels": [fwire.rel_to_wire(x) for x in rels],
        })
    finally:
        conn.close()
    return [bool(v) for v in r["verdicts"]]


def test_demo_world_verdicts_equal_reference_through_the_wire(tmp_path):
    """Both routers' ``--demo-world`` with one replica process each: the
    router's wire ``check`` of every (doc, user) pair of the demo world
    answers alike, and as the world says (doc:dI is owned by user:u(I % 8))."""
    kids = []
    try:
        port_router = Child(module_argv(FLEETD, "router", "--demo-world"),
                            str(tmp_path / "port_router.log"), env=ENV)
        ref_router = Child(
            [sys.executable, os.path.join(ROOT, "scripts", "fleetd.py"), "router",
             "--demo-world"], str(tmp_path / "ref_router.log"), env=ENV)
        kids += [port_router, ref_router]
        pa = _addr(port_router.wait_line("ROUTER-READY", BOOT_S))
        ra = _addr(ref_router.wait_line("ROUTER-READY", BOOT_S))
        port_rep = Child(module_argv(FLEETD, "replica", "--upstream",
                                     f"{pa[0]}:{pa[1]}", "--device", "cpu",
                                     "--join"),
                         str(tmp_path / "port_replica.log"), env=ENV)
        ref_rep = Child(
            [sys.executable, os.path.join(ROOT, "scripts", "fleetd.py"), "replica",
             "--upstream", f"{ra[0]}:{ra[1]}", "--join"],
            str(tmp_path / "ref_replica.log"), env=ENV)
        kids += [port_rep, ref_rep]
        port_rep.wait_line("JOINED", BOOT_S)
        ref_rep.wait_line("JOINED", BOOT_S)

        pairs = [(d, u) for d in range(32) for u in range(8)]
        rels = [rel.must_from_triple(f"doc:d{d}", "read", f"user:u{u}")
                for d, u in pairs]
        got = _wire_check(pa, rels)
        want = _wire_check(ra, rels)
        assert got == want
        assert got == [u == d % 8 for d, u in pairs]
        assert sum(got) == 32
        # the replica process answered: SIGINT prints its exit report
        assert port_rep.stop(30) == 0
        line = port_rep.wait_line("REPLICA-EXIT", 5)
        rep = json.loads(line.split(" ", 1)[1])
        assert rep["device"] == "cpu" and rep["launches"] == {}
        assert port_router.stop(30) == 0
    finally:
        close_all(kids)


SCHEMA = """
definition user {}
definition org { relation admin: user  relation member: user }
definition repo {
    relation org: org
    relation reader: user
    permission admin = org->admin
    permission read = reader + admin + org->member
}
"""


def _world(rng, n_repos=200, n_users=60):
    triples = []
    for i in range(n_repos):
        triples.append((f"repo:r{i}", "reader", f"user:u{int(rng.integers(n_users))}"))
        triples.append((f"repo:r{i}", "org", f"org:o{i % 6}"))
    for o in range(6):
        triples.append((f"org:o{o}", "admin", f"user:u{o}"))
        for j in range(5):
            triples.append((f"org:o{o}", "member", f"user:u{(o * 7 + j) % n_users}"))
    return triples


def _spawn_replica(tmp_path, port, name):
    return Child(module_argv(FLEETD, "replica", "--upstream", f"127.0.0.1:{port}",
                             "--id", name, "--device", "cpu", "--latency-mode",
                             "--join"),
                 str(tmp_path / f"{name}.log"), env=ENV)


def test_sigkill_failover_and_restart_against_reference_oracle(tmp_path):
    """Two replica processes behind a router in this process; callers
    check throughout a SIGKILL of one: every call answered once, every
    answer the reference host oracle's; the ring evicts the dead process
    (``fleet.kill_detections`` bumps), a restarted process rejoins and
    answers; SIGINT makes each survivor print ``REPLICA-EXIT`` with device
    ``cpu``."""
    rng = np.random.default_rng(5)
    triples = _world(rng)
    ctx = background()
    cfg = replace(FleetConfig(), probe_interval_s=0.05, probe_timeout_s=1.0,
                  heartbeat_s=0.05, freshness_wait_s=30.0)
    router = FleetRouter(config=cfg)
    kids = []
    try:
        router.write_schema(ctx, SCHEMA)
        txn = rel.Txn()
        for t in triples:
            txn.touch(rel.must_from_triple(*t))
        router.write(ctx, txn)

        oracle = j_new_tpu_evaluator(j_host_only())
        jctx = j_background()
        oracle.write_schema(jctx, SCHEMA)
        jtxn = jrel.Txn()
        for t in triples:
            jtxn.touch(jrel.must_from_triple(*t))
        oracle.write(jctx, jtxn)
        queries = [(f"repo:r{int(a)}", "read" if p else "admin", f"user:u{int(b)}")
                   for a, p, b in zip(rng.integers(0, 200, 512),
                                      rng.random(512) < 0.8,
                                      rng.integers(0, 60, 512))]
        want = oracle.check(jctx, jconsistency.full(),
                            *[jrel.must_from_triple(*q) for q in queries])
        assert 0 < sum(want) < len(want)
        oracle_of = dict(zip(queries, want))

        kids += [_spawn_replica(tmp_path, router.port, f"p{i}") for i in range(2)]
        for k in kids:
            k.wait_line("JOINED", BOOT_S)
        assert len(router.status()["ring"]) == 2
        # both replicas' first prepares, before the timed window
        router.check(background().with_timeout(60.0), consistency.min_latency(),
                     *[rel.must_from_triple(*q) for q in queries[:64]])

        calls, bad, errs = [0], [], []
        killed_at, after = [float("inf")], [0]
        stop = threading.Event()

        def caller(seed):
            r = np.random.default_rng(seed)
            while not stop.is_set():
                idx = r.integers(0, len(queries), 16)
                rels = [rel.must_from_triple(*queries[i]) for i in idx]
                t0 = time.monotonic()
                try:
                    got = router.check(background().with_timeout(60.0),
                                       consistency.min_latency(), *rels)
                except BaseException as e:  # noqa: BLE001 - counted
                    errs.append(repr(e))
                    continue
                calls[0] += 1
                after[0] += t0 > killed_at[0]
                exp = [oracle_of[queries[i]] for i in idx]
                if list(got) != exp:
                    bad.append((list(got), exp))

        m = _metrics.default
        kills0 = m.counter("fleet.kill_detections")
        ts = [threading.Thread(target=caller, args=(s,)) for s in range(3)]
        for t in ts:
            t.start()
        try:
            time.sleep(0.5)
            victim = kids[0]
            killed_at[0] = time.monotonic()
            victim.send(signal.SIGKILL)
            deadline = time.monotonic() + 30
            while len(router.status()["ring"]) != 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            # calls that started after the kill, answered by the survivor
            while after[0] < 6 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            stop.set()
            for t in ts:
                t.join(60)
        assert victim.wait(10) == -signal.SIGKILL
        assert len(router.status()["ring"]) == 1
        assert m.counter("fleet.kill_detections") > kills0
        assert after[0] > 0 and not errs and not bad

        again = _spawn_replica(tmp_path, router.port, "p2")
        kids.append(again)
        again.wait_line("JOINED", BOOT_S)
        assert len(router.status()["ring"]) == 2
        rels = [rel.must_from_triple(*q) for q in queries]
        assert router.check(background().with_timeout(60.0), consistency.full(),
                            *rels) == list(want)

        for k in (kids[1], again):
            assert k.stop(30) == 0
            rep = json.loads(k.wait_line("REPLICA-EXIT", 5).split(" ", 1)[1])
            assert rep["device"] == "cpu" and rep["id"] in ("p1", "p2")
    finally:
        router.close()
        close_all(kids)
