"""The port's fleet serving (gochugaru_tpu_torch/fleet/) against the
reference's (gochugaru_tpu/fleet/).

First the reference's own tests of tests/test_fleet.py, on the port,
in-process: the router and replicas live in this process as objects, but
every byte between them crosses real localhost sockets through the
framed wire protocol.  Replica parity under every strategy, the streamed
write that reaches each replica exactly once, and the kill failover run
twice: with host-only replicas (as the reference's tests run them) and
with replicas whose clients take the port's device path on ``cpu`` (the
plain versions; on ``cuda`` the same path launches the kernels, which
chip_smoke.py phase 18 drives).

Then parity with the reference: the same wire frames, byte for byte, for
the same relationships, updates and strategies; a port replica that
bootstraps from and tails a REFERENCE router; the same verdicts from a
reference fleet and a port fleet on the same world; and a short run of
the reference's fleet chaos soak (tests/test_chaos.py) on the port, with
the four fleet fault sites armed.  Verdicts are bools: the tolerance is
equality.
"""

import datetime as dt
import random
import socket
import threading
import time
import zlib
from dataclasses import replace

import pytest

from gochugaru_tpu import consistency as jconsistency
from gochugaru_tpu import rel as jrel
from gochugaru_tpu.client import (
    new_tpu_evaluator as j_new,
    with_host_only_evaluation as j_host_only,
    with_store as j_with_store,
    with_verdict_cache as j_with_vcache,
)
from gochugaru_tpu.fleet import FleetConfig as JFleetConfig
from gochugaru_tpu.fleet import FleetRouter as JFleetRouter
from gochugaru_tpu.fleet import Replica as JReplica
from gochugaru_tpu.fleet import wire as jwire
from gochugaru_tpu.fleet import zookie as jzookie
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency, rel
from gochugaru_tpu_torch.client import (
    WatchConfig,
    new_evaluator,
    with_host_only_evaluation,
    with_latency_mode,
    with_store,
    with_verdict_cache,
)
from gochugaru_tpu_torch.fleet import FleetConfig, FleetRouter, HashRing, Replica
from gochugaru_tpu_torch.fleet import replica as freplica
from gochugaru_tpu_torch.fleet import wire as fwire
from gochugaru_tpu_torch.fleet import zookie
from gochugaru_tpu_torch.utils import decisions as _decisions
from gochugaru_tpu_torch.utils import faults
from gochugaru_tpu_torch.utils import metrics as _metrics
from gochugaru_tpu_torch.utils import slo, trace
from gochugaru_tpu_torch.utils.context import background
from gochugaru_tpu_torch.utils.errors import (
    AuthzError,
    DeadlineExceededError,
    UnavailableError,
    classify_dispatch_exception,
)

SCHEMA = """
definition user {}
definition team { relation member: user }
definition doc {
    relation owner: user
    relation reader: user | team#member
    relation banned: user
    permission read = reader + owner - banned
}
"""

#: test posture: sub-100ms failure detection, short freshness waits
CFG = replace(
    FleetConfig(),
    probe_interval_s=0.05,
    probe_timeout_s=0.5,
    freshness_wait_s=3.0,
    freshness_poll_s=0.02,
    heartbeat_s=0.05,
)

#: replica client modes: the reference tests' host-only clients, and the
#: port's device path on the CPU (plain versions), with latency mode on
MODES = {
    "host": dict(client_options=(with_verdict_cache(), with_host_only_evaluation())),
    "device": dict(client_options=(with_verdict_cache(), with_latency_mode()),
                   device="cpu"),
}


@pytest.fixture(autouse=True)
def _hygiene():
    faults.reset()
    yield
    faults.reset()
    trace.install_recorder(None)
    trace.disable()
    slo.install_engine(None)
    _decisions.set_identity(None)


def _world(router, r=rel):
    ctx = background()
    router.write_schema(ctx, SCHEMA)
    txn = r.Txn()
    for i in range(16):
        txn.touch(r.must_from_triple(f"doc:d{i}", "owner", f"user:u{i % 5}"))
        txn.touch(r.must_from_triple(f"doc:d{i}", "reader", f"user:r{i % 7}"))
    txn.touch(r.must_from_triple("team:core", "member", "user:tm"))
    txn.touch(r.must_from_tuple("doc:d0#reader", "team:core#member"))
    txn.touch(r.must_from_triple("doc:d1", "banned", "user:r1"))
    router.write(ctx, txn)


def _replica(router, rid, cfg=CFG, mode="host"):
    return Replica(
        ("127.0.0.1", router.port), replica_id=rid, config=cfg, **MODES[mode]
    )


def _start_fleet(mode):
    router = FleetRouter(config=CFG)
    _world(router)
    reps = [_replica(router, f"r{i}", mode=mode) for i in range(3)]
    for r in reps:
        router.add_replica(r.host, r.port, wait_ready_s=10.0)
    return router, reps


def _stop_fleet(router, reps):
    router.close()
    for r in reps:
        r.close()


@pytest.fixture
def fleet():
    router, reps = _start_fleet("host")
    yield router, reps
    _stop_fleet(router, reps)


@pytest.fixture(params=sorted(MODES))
def any_fleet(request):
    router, reps = _start_fleet(request.param)
    yield router, reps
    _stop_fleet(router, reps)


def _queries(r=rel):
    qs = [r.must_from_triple(f"doc:d{i}", "read", f"user:u{i % 5}") for i in range(8)]
    qs += [r.must_from_triple(f"doc:d{i}", "read", f"user:r{i % 7}") for i in range(8)]
    qs.append(r.must_from_triple("doc:d0", "read", "user:tm"))
    qs.append(r.must_from_triple("doc:d1", "read", "user:r1"))  # banned
    qs.append(r.must_from_triple("doc:d2", "read", "user:nobody"))
    return qs


def _oracle(router):
    return new_evaluator(with_store(router.store), with_host_only_evaluation())


def _wait(pred, seconds=5.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _kill_over_wire(r):
    conn = fwire.Conn((r.host, r.port))
    try:
        with pytest.raises(ConnectionError):
            conn.request({"op": "kill"})
    finally:
        conn.close()


# -- hash ring, wire codecs ---------------------------------------------------


def test_ring_stability_and_spread():
    ring = HashRing(vnodes=32)
    for m in ("a", "b", "c"):
        ring.add(m)
    keys = [f"doc:d{i}" for i in range(500)]
    owners = {k: ring.owner(k) for k in keys}
    spread = {m: sum(1 for o in owners.values() if o == m) for m in "abc"}
    assert all(50 < n < 450 for n in spread.values()), spread
    ring.remove("b")
    for k in keys:
        if owners[k] != "b":
            assert ring.owner(k) == owners[k]
    assert ring.owner("anything") in {"a", "c"}
    ring.remove("a")
    ring.remove("c")
    assert ring.owner("anything") is None


def test_wire_rel_roundtrip_preserves_caveat_and_expiration():
    r = rel.must_from_triple("doc:d1", "reader", "user:u1").with_caveat(
        "tod", {"hour": 9}
    ).with_expiration(dt.datetime(2030, 1, 1, tzinfo=dt.timezone.utc))
    back = fwire.rel_from_wire(fwire.rel_to_wire(r))
    assert back == r
    u = rel.Update(rel.UpdateType.DELETE, r)
    bu = fwire.update_from_wire(fwire.update_to_wire(u))
    assert bu.update_type == rel.UpdateType.DELETE
    assert bu.relationship == r


def test_wire_strategy_roundtrip():
    for cs in (
        consistency.full(),
        consistency.min_latency(),
        consistency.at_least("gtz1.5"),
        consistency.snapshot("gtz1.9"),
    ):
        assert fwire.strategy_from_wire(fwire.strategy_to_wire(cs)) == cs


def test_policy_for_mapping():
    assert consistency.policy_for(consistency.full()) == ("head", None)
    assert consistency.policy_for(consistency.min_latency()) == ("any", None)
    assert consistency.policy_for(consistency.at_least("gtz1.3")) == (
        "at_least", "gtz1.3",
    )
    assert consistency.policy_for(consistency.snapshot("gtz1.3")) == (
        "exact", "gtz1.3",
    )


# -- coherence ----------------------------------------------------------------


def test_replica_parity_all_strategies(any_fleet):
    router, _ = any_fleet
    ctx = background()
    qs = _queries()
    want = _oracle(router).check(ctx, consistency.full(), *qs)
    at = consistency.at_least(
        zookie.revision_token(zookie.mint(router.head_revision))
    )
    for cs in (consistency.min_latency(), consistency.full(), at):
        assert router.check(ctx, cs, *qs) == want, cs


def test_streamed_write_reaches_replicas_exactly_once(any_fleet):
    router, reps = any_fleet
    ctx = background()
    for n in range(6):
        txn = rel.Txn()
        txn.touch(rel.must_from_triple(f"doc:w{n}", "reader", "user:wr"))
        router.write(ctx, txn)
    assert _wait(lambda: all(r.head == router.head_revision for r in reps))
    for r in reps:
        assert (
            sorted(map(str, r._store.live_relationships()))
            == sorted(map(str, router.store.live_relationships()))
        )
    # and each replica SERVES the streamed writes (its client advanced)
    q = rel.must_from_triple("doc:w5", "read", "user:wr")
    assert router.check(ctx, consistency.full(), q) == [True]


def test_replica_apply_advances_serving_and_invalidates_vcache():
    m = _metrics.default
    router = FleetRouter(config=CFG)
    _world(router)
    r = _replica(router, "rv-fresh")
    router.add_replica(r.host, r.port, wait_ready_s=5.0)
    try:
        ctx = background()
        q = rel.must_from_triple("doc:fresh", "read", "user:fu")
        assert router.check(ctx, consistency.min_latency(), q) == [False]
        inv0 = m.counter("fleet.vcache_invalidations")
        for n in range(6):
            txn = rel.Txn()
            txn.touch(rel.must_from_triple("doc:fresh", "reader", "user:fu"))
            txn.touch(rel.must_from_triple(f"doc:churn{n}", "reader", "user:cu"))
            router.write(ctx, txn)
        assert _wait(lambda: r.head == router.head_revision)
        assert router.check(ctx, consistency.min_latency(), q) == [True]
        assert m.counter("fleet.vcache_invalidations") > inv0
        h = r.health()
        assert set(h["cache"]["revisions"]) <= set(h["resident"])
    finally:
        router.close()
        r.close()


def test_zookie_read_your_writes(fleet):
    router, _ = fleet
    ctx = background()
    for n in range(5):
        txn = rel.Txn()
        txn.touch(rel.must_from_triple(f"doc:ryw{n}", "reader", "user:me"))
        zk = router.write(ctx, txn)
        got = router.check(
            ctx, consistency.min_latency(),
            rel.must_from_triple(f"doc:ryw{n}", "read", "user:me"),
            zookie=zk,
        )
        assert got == [True], n


def test_future_zookie_blocks_for_catchup_never_stale():
    m = _metrics.default
    router = FleetRouter(config=CFG)
    _world(router)
    r0 = _replica(router, "lagger")
    router.add_replica(r0.host, r0.port, wait_ready_s=5.0)
    try:
        r0.pause_tail()
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:late", "reader", "user:lw"))
        zk = router.write(background(), txn)
        waits_before = m.counter("fleet.fresh_waits")
        t = threading.Timer(0.3, r0.resume_tail)
        t.start()
        got = router.check(
            background().with_timeout(10.0), consistency.min_latency(),
            rel.must_from_triple("doc:late", "read", "user:lw"),
            zookie=zk,
        )
        t.join()
        assert got == [True]
        assert m.counter("fleet.fresh_waits") > waits_before
    finally:
        router.close()
        r0.close()


def test_no_fresh_replica_sheds_classified_not_stale():
    cfg = replace(CFG, freshness_wait_s=0.3)
    router = FleetRouter(config=cfg)
    _world(router)
    r0 = _replica(router, "stuck", cfg)
    router.add_replica(r0.host, r0.port, wait_ready_s=5.0)
    try:
        ctx = background().with_timeout(1.5)
        r0.pause_tail()
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:never", "reader", "user:nv"))
        zk = router.write(background(), txn)
        with pytest.raises((UnavailableError, DeadlineExceededError)):
            router.check(
                ctx, consistency.min_latency(),
                rel.must_from_triple("doc:never", "read", "user:nv"),
                zookie=zk,
            )
    finally:
        router.close()
        r0.close()


def test_invalid_zookie_fails_before_dispatch(fleet):
    router, _ = fleet
    with pytest.raises(zookie.InvalidZookieError):
        router.check(
            background(), consistency.min_latency(),
            rel.must_from_triple("doc:d0", "read", "user:u0"),
            zookie="zk1.999.forgedforgedforged00",
        )


# -- failover -----------------------------------------------------------------


def test_replica_kill_failover_and_rejoin(any_fleet, tmp_path, request):
    router, reps = any_fleet
    mode = request.node.callspec.params["any_fleet"]
    m = _metrics.default
    rec = trace.install_recorder(trace.FlightRecorder(
        incident_dir=str(tmp_path), grace_s=0.0, cooldown_s=0.0,
    ))
    ctx = background()
    qs = _queries()
    want = _oracle(router).check(ctx, consistency.full(), *qs)
    kills_before = m.counter("fleet.kill_detections")
    _kill_over_wire(reps[1])
    for _ in range(25):
        got = router.check(
            background().with_timeout(15.0), consistency.full(), *qs
        )
        assert got == want
    assert _wait(lambda: sorted(router.status()["ring"]) == ["r0", "r2"])
    assert m.counter("fleet.kill_detections") > kills_before
    rec.flush()
    assert any(
        e["trigger"] == "fleet.failover" and e["info"]["replica"] == "r1"
        for e in rec.incident_index()
    )
    r1b = _replica(router, "r1b", mode=mode)
    reps.append(r1b)
    router.add_replica(r1b.host, r1b.port, wait_ready_s=10.0)
    assert sorted(router.status()["ring"]) == ["r0", "r1b", "r2"]
    assert router.check(ctx, consistency.full(), *qs) == want


def test_bootstrap_of_more_frames_than_revisions():
    """A world exported in more frames than its base revision (here 35
    relationships at revision 2, in frames of 4) bootstraps: the port's
    replica imports the export once, so its local revisions stay under
    the base it aligns to.  The reference's replica imports a frame at a
    time and raises (``cannot rewind head``) on the same world -- at
    BASELINE config 2's size (50,069 relationships at revision 7, frames
    of 2,048) as well."""
    cfg = replace(CFG, bootstrap_chunk=4)
    router = FleetRouter(config=cfg)
    _world(router)
    assert router.head_revision == 2 and len(router.store.live_relationships()) > 4 * 2
    r = _replica(router, "big", cfg, mode="device")
    jrouter = JFleetRouter(config=replace(JFleetConfig(), bootstrap_chunk=4))
    _world(jrouter, jrel)
    try:
        router.add_replica(r.host, r.port, wait_ready_s=10.0)
        assert r.head == router.head_revision
        assert (sorted(map(str, r._store.live_relationships()))
                == sorted(map(str, router.store.live_relationships())))
        qs = _queries()
        assert router.check(background(), consistency.full(), *qs) == (
            _oracle(router).check(background(), consistency.full(), *qs))
        with pytest.raises(ValueError, match="cannot rewind"):
            JReplica(("127.0.0.1", jrouter.port), replica_id="jbig")
    finally:
        router.close()
        jrouter.close()
        r.close()


@pytest.mark.parametrize("columnar_min", [8, None])
def test_bootstrap_import_holds_bounded_objects(monkeypatch, columnar_min):
    """``Store.import_relationship_batches`` (the replica's bootstrap)
    keeps fewer than COLUMNAR_IMPORT_MIN Relationship objects alive
    between frames: past that count each frame is lowered to columns and
    dropped before the stream makes the next.  Either way it mints one
    revision and lands the world that one ``import_relationships(...,
    touch=True)`` of the concatenation lands (through the object path
    below the threshold, as a column segment at or past it); importing
    it again upserts."""
    import weakref

    from gochugaru_tpu_torch.store import store as _store

    if columnar_min is not None:
        monkeypatch.setattr(_store, "COLUMNAR_IMPORT_MIN", columnar_min)
    router = FleetRouter(config=CFG)
    try:
        _world(router)
        src = sorted(router.store.live_relationships(), key=str)
    finally:
        router.close()
    texts = sorted(map(str, src))
    refs, alive_at = [], []

    def frames():  # fresh objects a frame, as the wire decodes them
        for a in range(0, len(src), 4):
            alive_at.append(sum(w() is not None for w in refs))
            b = [replace(r) for r in src[a:a + 4]]
            refs.extend(weakref.ref(r) for r in b)
            yield b
            del b

    def world(st):
        return sorted(map(str, st.export_at(_store.RevisionToken(st.head_revision))))

    st = _store.Store()
    st.write_schema(SCHEMA)
    assert st.import_relationship_batches(frames()) == "gtz1.2"
    assert len(alive_at) == -(-len(src) // 4) > 2
    one = _store.Store()
    one.write_schema(SCHEMA)
    one.import_relationships(src, touch=True)
    assert world(st) == world(one) == texts
    if columnar_min is not None:
        assert len(src) > columnar_min and max(alive_at) < columnar_min
        assert st.live_relationships() == [] and len(st._segments) == 1
    else:
        assert sorted(map(str, st.live_relationships())) == texts
    assert st.import_relationship_batches([]) == "gtz1.2"
    assert st.import_relationship_batches([[replace(r) for r in src]]) == "gtz1.3"
    assert world(st) == texts


def test_router_dispatch_fault_reroutes(fleet):
    router, _ = fleet
    m = _metrics.default
    ctx = background().with_timeout(15.0)
    qs = _queries()[:6]
    want = _oracle(router).check(background(), consistency.full(), *qs)
    before = m.counter("fleet.reroutes")
    with faults.armed("router.dispatch", times=2, seed=7):
        assert router.check(ctx, consistency.full(), *qs) == want
    assert m.counter("fleet.reroutes") >= before + 2


def test_router_health_fault_storm_evicts_then_rejoins():
    router = FleetRouter(config=CFG)
    _world(router)
    r0 = _replica(router, "flappy")
    router.add_replica(r0.host, r0.port, wait_ready_s=5.0)
    try:
        with faults.armed("router.health", probability=1.0, times=6, seed=3):
            assert _wait(lambda: not router.status()["ring"])
        assert _wait(lambda: router.status()["ring"] == ["flappy"])
    finally:
        router.close()
        r0.close()


def test_replica_apply_fault_tail_resumes_exactly_once():
    m = _metrics.default
    router = FleetRouter(config=CFG)
    _world(router)
    r0 = _replica(router, "applier")
    router.add_replica(r0.host, r0.port, wait_ready_s=5.0)
    try:
        ctx = background()
        with faults.armed("replica.apply", probability=0.5, seed=11):
            for n in range(12):
                txn = rel.Txn()
                txn.touch(rel.must_from_triple(f"doc:af{n}", "reader", "user:af"))
                router.write(ctx, txn)
            _wait(lambda: r0.head == router.head_revision, 8.0)
        assert r0.head == router.head_revision
        assert (
            sorted(map(str, r0._store.live_relationships()))
            == sorted(map(str, router.store.live_relationships()))
        )
        assert m.counter("fleet.tail_resumes") > 0
    finally:
        router.close()
        r0.close()


def test_not_ready_replica_drained_without_failover_alarm():
    cfg = replace(CFG, ready_lag=2)
    m = _metrics.default
    router = FleetRouter(config=cfg)
    _world(router)
    r0 = _replica(router, "slowpoke", cfg)
    router.add_replica(r0.host, r0.port, wait_ready_s=5.0)
    try:
        kills_before = m.counter("fleet.kill_detections")
        r0.pause_tail()
        ctx = background()
        for n in range(6):
            txn = rel.Txn()
            txn.touch(rel.must_from_triple(f"doc:nr{n}", "reader", "user:x"))
            router.write(ctx, txn)
        assert _wait(lambda: not router.status()["ring"])
        assert m.counter("fleet.kill_detections") == kills_before
        r0.resume_tail()
        assert _wait(lambda: router.status()["ring"] == ["slowpoke"])
    finally:
        router.close()
        r0.close()


# -- group commit over the wire -----------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_group_commit_replicates_as_one_entry(mode):
    m = _metrics.default
    router = FleetRouter(config=CFG)
    _world(router)
    r0 = _replica(router, "grouped", mode=mode)
    router.add_replica(r0.host, r0.port, wait_ready_s=10.0)
    try:
        ctx = background()
        applied_before = m.counter("fleet.applied_entries")
        groups_before = m.counter("fleet.write_groups")
        gapplies_before = m.counter("fleet.group_applies")
        base = router.head_revision
        txns = []
        for n in range(8):
            txn = rel.Txn()
            txn.touch(rel.must_from_triple(f"doc:gc{n}", "reader", "user:gw"))
            txns.append(txn)
        zks = router.write_group(ctx, txns)
        assert not any(isinstance(z, BaseException) for z in zks)
        assert [zookie.parse(z) for z in zks] == [base + 1 + i for i in range(8)]
        assert router.head_revision == base + 8
        assert m.counter("fleet.write_groups") == groups_before + 1
        assert _wait(lambda: r0.head == router.head_revision)
        assert m.counter("fleet.applied_entries") == applied_before + 1
        assert m.counter("fleet.group_applies") == gapplies_before + 1
        got = router.check(
            ctx, consistency.min_latency(),
            rel.must_from_triple("doc:gc7", "read", "user:gw"),
            zookie=zks[-1],
        )
        assert got == [True]
        dup = rel.Txn()
        dup.create(rel.must_from_triple("doc:gc0", "reader", "user:gw"))
        ok = rel.Txn()
        ok.touch(rel.must_from_triple("doc:gc8", "reader", "user:gw"))
        out = router.write_group(ctx, [dup, ok])
        assert isinstance(out[0], BaseException)
        assert zookie.parse(out[1]) == base + 9
    finally:
        router.close()
        r0.close()


def test_group_commit_replica_kill_replays_without_double_apply():
    router = FleetRouter(config=CFG)
    _world(router)
    r0 = _replica(router, "gk0")
    router.add_replica(r0.host, r0.port, wait_ready_s=5.0)
    r0b = None
    try:
        ctx = background()

        def _group(tag, k=6):
            txns = []
            for n in range(k):
                txn = rel.Txn()
                txn.touch(rel.must_from_triple(f"doc:{tag}{n}", "reader", "user:gk"))
                txns.append(txn)
            return txns

        zks = router.write_group(ctx, _group("gka"))
        assert not any(isinstance(z, BaseException) for z in zks)
        _kill_over_wire(r0)
        for tag in ("gkb", "gkc"):
            zks = router.write_group(ctx, _group(tag))
            assert not any(isinstance(z, BaseException) for z in zks)
        r0b = _replica(router, "gk0b")
        router.add_replica(r0b.host, r0b.port, wait_ready_s=5.0)
        assert _wait(lambda: r0b.head == router.head_revision, 8.0)
        assert (
            sorted(map(str, r0b._store.live_relationships()))
            == sorted(map(str, router.store.live_relationships()))
        )
        got = router.check(
            ctx, consistency.min_latency(),
            rel.must_from_triple("doc:gkc5", "read", "user:gk"),
            zookie=zks[-1],
        )
        assert got == [True]
    finally:
        router.close()
        r0.close()
        if r0b is not None:
            r0b.close()


# -- satellites ---------------------------------------------------------------


def test_transport_errors_classify_retriable():
    for e in (
        ConnectionError("boom"),
        ConnectionResetError("reset"),
        BrokenPipeError("pipe"),
        socket.timeout("slow"),
        TimeoutError("slow"),
        fwire.WireClosed("closed mid-frame"),
    ):
        c = classify_dispatch_exception(e)
        assert isinstance(c, UnavailableError), e
        assert c.__cause__ is e
    assert classify_dispatch_exception(ValueError("nope")) is None


def test_watch_config_storm_threshold_and_cursor(tmp_path):
    c = new_evaluator(with_host_only_evaluation())
    ctx = background()
    c.write_schema(ctx, SCHEMA)
    txn = rel.Txn()
    txn.touch(rel.must_from_triple("doc:w0", "reader", "user:w"))
    c.write(ctx, txn)
    rec = trace.install_recorder(trace.FlightRecorder(
        incident_dir=str(tmp_path), grace_s=0.0, cooldown_s=0.0,
    ))
    watch_ctx = background().with_cancel()
    stream = c.updates_since_revision(
        watch_ctx, rel.UpdateFilter(), "gtz1.1",
        config=WatchConfig(max_resumes=16, storm_resumes=3),
    )
    seen = [next(stream)]
    with faults.armed("watch.stream", probability=1.0, times=4, seed=1):
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:w1", "reader", "user:w"))
        c.write(ctx, txn)
        seen.append(next(stream))
    watch_ctx.cancel()
    rec.flush()
    storms = [
        e for e in rec.incident_index()
        if e["trigger"] == "watch.resume_storm"
    ]
    assert storms, "configured storm threshold (3) never fired"
    assert storms[0]["info"]["no_progress"] == 3
    assert storms[0]["info"]["cursor_rev"] == 2
    assert "cursor_offset" in storms[0]["info"]
    assert [u.relationship.resource_id for u in seen] == ["w0", "w1"]


def test_watch_config_max_resumes_surfaces():
    c = new_evaluator(with_host_only_evaluation())
    ctx = background()
    c.write_schema(ctx, SCHEMA)
    txn = rel.Txn()
    txn.touch(rel.must_from_triple("doc:m0", "reader", "user:m"))
    c.write(ctx, txn)
    watch_ctx = background().with_cancel()
    stream = c.updates_since_revision(
        watch_ctx, rel.UpdateFilter(), "gtz1.1",
        config=WatchConfig(max_resumes=2, storm_resumes=99),
    )
    with faults.armed("watch.stream", probability=1.0, seed=2):
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:m1", "reader", "user:m"))
        c.write(ctx, txn)
        with pytest.raises(UnavailableError):
            next(stream)
    watch_ctx.cancel()


def test_decision_log_carries_replica_identity():
    from gochugaru_tpu_torch.utils.decisions import DecisionLog

    log = _decisions.install(DecisionLog())
    _decisions.set_identity("replica-test-7")
    try:
        c = new_evaluator(with_host_only_evaluation())
        ctx = background()
        c.write_schema(ctx, SCHEMA)
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:dl", "reader", "user:dl"))
        c.write(ctx, txn)
        c.check(
            ctx, consistency.full(),
            rel.must_from_triple("doc:dl", "read", "user:other"),
        )
        entries = log.tail(10)
        assert entries, "no decision entries recorded"
        assert all(e["replica"] == "replica-test-7" for e in entries)
    finally:
        _decisions.set_identity(None)
        _decisions.install(None)


# -- the port's entry points: on the card unless told otherwise ---------------


def test_replica_serves_on_cuda_unless_told_cpu(monkeypatch):
    """``Replica(...)`` with no device and ``main`` with no ``--device``
    take ``cuda``, which raises without a card; ``device="cpu"`` and
    ``--device cpu`` run the plain versions; ``--host-only`` builds no
    engine."""
    router = FleetRouter(config=CFG)
    _world(router)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            Replica(("127.0.0.1", router.port), replica_id="nocard", config=CFG)
        r = _replica(router, "cpu", mode="device")
        try:
            assert str(r._client.device) == "cpu"
        finally:
            r.close()
        seen = {}

        class Stop(Exception):
            pass

        def fake(*a, **kw):
            seen.update(kw)
            raise Stop

        monkeypatch.setattr(freplica, "Replica", fake)
        up = f"127.0.0.1:{router.port}"
        for argv, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
            with pytest.raises(Stop):
                freplica.main(["--upstream", up] + argv)
            assert seen["device"] == want
        with pytest.raises(Stop):
            freplica.main(["--upstream", up, "--host-only", "--latency-mode"])
        names = [type(o).__qualname__ for o in seen["client_options"]]
        assert len(names) == 3
    finally:
        router.close()
        _decisions.set_identity(None)


# -- parity with the reference ------------------------------------------------


def _frame_bytes(send, obj):
    a, b = socket.socketpair()
    try:
        send(a, obj)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def _rels(r):
    exp = dt.datetime(2031, 5, 6, 7, 8, 9, 123456, tzinfo=dt.timezone.utc)
    return [
        r.must_from_triple("doc:d1", "reader", "user:u1"),
        r.must_from_tuple("doc:d0#reader", "team:core#member"),
        r.must_from_triple("doc:d2", "owner", "user:o").with_caveat(
            "tod", {"hour": 9, "zone": "utc", "ok": True}),
        r.must_from_triple("doc:d3", "reader", "user:x").with_expiration(exp),
        r.must_from_triple("doc:é", "reader", "user:ü"),
    ]


def test_wire_frames_and_zookies_byte_identical_to_reference():
    """The same relationships, updates and strategies encode to the same
    frame bytes; tokens minted for the same revision (and key) are the
    same string, and each package verifies the other's."""
    for pr, jr in zip(_rels(rel), _rels(jrel)):
        assert fwire.rel_to_wire(pr) == jwire.rel_to_wire(jr)
        for pt, jt in ((rel.UpdateType.TOUCH, jrel.UpdateType.TOUCH),
                       (rel.UpdateType.DELETE, jrel.UpdateType.DELETE)):
            pf = _frame_bytes(fwire.send_frame, {"rev": 7, "updates": [
                fwire.update_to_wire(rel.Update(pt, pr))]})
            jf = _frame_bytes(jwire.send_frame, {"rev": 7, "updates": [
                jwire.update_to_wire(jrel.Update(jt, jr))]})
            assert pf == jf
    for pcs, jcs in ((consistency.full(), jconsistency.full()),
                     (consistency.min_latency(), jconsistency.min_latency()),
                     (consistency.at_least("gtz1.5"), jconsistency.at_least("gtz1.5")),
                     (consistency.snapshot("gtz1.9"), jconsistency.snapshot("gtz1.9"))):
        assert _frame_bytes(fwire.send_frame, fwire.strategy_to_wire(pcs)) == (
            _frame_bytes(jwire.send_frame, jwire.strategy_to_wire(jcs)))
    for rev in (0, 1, 42, 10**9):
        for key in (zookie.DEFAULT_KEY, b"other-deployment"):
            tok = zookie.mint(rev, key)
            assert tok == jzookie.mint(rev, key)
            assert jzookie.parse(tok, key) == zookie.parse(tok, key) == rev
    assert zookie.mint("gtz1.7") == jzookie.mint("gtz1.7")
    err = fwire.error_frame(zookie.InvalidZookieError("bad"))
    assert err == jwire.error_frame(jzookie.InvalidZookieError("bad"))
    assert fwire.FRAME_MAX == jwire.FRAME_MAX


def test_port_replica_tails_a_reference_router():
    """Wire compatibility end to end: a port replica (device path on
    ``cpu``) bootstraps from a REFERENCE router, tails its stream, and
    answers as the reference's host oracle does, writes included."""
    jcfg = replace(JFleetConfig(), probe_interval_s=0.05, probe_timeout_s=0.5,
                   heartbeat_s=0.05)
    jrouter = JFleetRouter(config=jcfg)
    _world(jrouter, jrel)
    r = Replica(("127.0.0.1", jrouter.port), replica_id="port-on-ref", config=CFG,
                **MODES["device"])
    try:
        jrouter.add_replica(r.host, r.port, wait_ready_s=10.0)
        ctx = j_background()
        txn = jrel.Txn()
        txn.touch(jrel.must_from_triple("doc:x", "reader", "user:xr"))
        txn.delete(jrel.must_from_triple("doc:d3", "owner", "user:u3"))
        zk = jrouter.write(ctx, txn)
        oracle = j_new(j_with_store(jrouter.store), j_host_only())
        qs = _queries(jrel) + [jrel.must_from_triple("doc:x", "read", "user:xr"),
                               jrel.must_from_triple("doc:d3", "read", "user:u3")]
        want = oracle.check(ctx, jconsistency.full(), *qs)
        assert jrouter.check(ctx, jconsistency.min_latency(), *qs, zookie=zk) == want
        assert jrouter.check(ctx, jconsistency.full(), *qs) == want
        assert r.head == jrouter.head_revision
    finally:
        jrouter.close()
        r.close()


def test_port_fleet_verdicts_equal_reference_fleet():
    """One world, one write sequence, through a reference fleet
    (host-only replicas, as its tests run) and a port fleet (device
    path on ``cpu``): equal zookies, equal verdicts under every
    strategy."""
    jcfg = replace(JFleetConfig(), probe_interval_s=0.05, probe_timeout_s=0.5,
                   heartbeat_s=0.05)
    jrouter = JFleetRouter(config=jcfg)
    _world(jrouter, jrel)
    jreps = [JReplica(("127.0.0.1", jrouter.port), replica_id=f"j{i}", config=jcfg,
                      client_options=(j_with_vcache(), j_host_only()))
             for i in range(2)]
    router = FleetRouter(config=CFG)
    _world(router)
    reps = [_replica(router, f"p{i}", mode="device") for i in range(2)]
    try:
        for jr in jreps:
            jrouter.add_replica(jr.host, jr.port, wait_ready_s=10.0)
        for r in reps:
            router.add_replica(r.host, r.port, wait_ready_s=10.0)
        rng = random.Random(5)
        for n in range(4):
            edits = [(f"doc:d{rng.randrange(16)}", "reader", f"user:r{rng.randrange(7)}"),
                     (f"doc:n{n}", "owner", f"user:u{rng.randrange(5)}")]
            ptx, jtx = rel.Txn(), jrel.Txn()
            for t in edits:
                ptx.touch(rel.must_from_triple(*t))
                jtx.touch(jrel.must_from_triple(*t))
            ptx.delete(rel.must_from_triple(f"doc:d{n}", "owner", f"user:u{n % 5}"))
            jtx.delete(jrel.must_from_triple(f"doc:d{n}", "owner", f"user:u{n % 5}"))
            zk = router.write(background(), ptx)
            assert zk == jrouter.write(j_background(), jtx)
            trip = [(f"doc:{d}", f"user:{u}") for d in
                    [f"d{i}" for i in range(16)] + [f"n{i}" for i in range(n + 1)]
                    for u in ("u0", "u1", "u3", "r1", "r2", "tm")]
            pq = [rel.must_from_triple(a, "read", b) for a, b in trip]
            jq = [jrel.must_from_triple(a, "read", b) for a, b in trip]
            for pcs, jcs, kw in (
                (consistency.full(), jconsistency.full(), {}),
                (consistency.min_latency(), jconsistency.min_latency(), {"zookie": zk}),
            ):
                got = router.check(background().with_timeout(20.0), pcs, *pq, **kw)
                want = jrouter.check(j_background().with_timeout(20.0), jcs, *jq, **kw)
                assert got == want, (n, pcs)
    finally:
        router.close()
        jrouter.close()
        for r in reps + jreps:
            r.close()


# -- a short run of the reference's fleet chaos soak, on the port -------------

CHAOS_SEED = 20260803
CHAOS_ROUNDS = 3
FLEET_SITES = (
    ("router.dispatch", 0.15),
    ("router.health", 0.05),
    ("replica.apply", 0.20),
    ("replica.kill", 0.01),
)


def _fixed_world(c):
    ctx = background()
    c.write_schema(ctx, SCHEMA)
    txn = rel.Txn()
    for i in range(8):
        txn.touch(rel.must_from_triple(f"doc:base{i}", "owner", f"user:own{i % 3}"))
        txn.touch(rel.must_from_triple(f"doc:base{i}", "reader", f"user:rd{i % 5}"))
    txn.touch(rel.must_from_triple("team:core", "member", "user:tm1"))
    txn.touch(rel.must_from_tuple("doc:base0#reader", "team:core#member"))
    txn.touch(rel.must_from_triple("doc:base1", "banned", "user:rd1"))
    c.write(ctx, txn)


def test_fleet_chaos_soak_short():
    """tests/test_chaos.py::test_fleet_chaos_soak at CHAOS_ROUNDS rounds:
    router + 2 replicas (device path on ``cpu``) under all four fleet
    fault sites, a deterministic replica kill in the middle round, and
    supervised restarts.  Every returned verdict matches the host oracle,
    zookie read-your-writes holds, every surfaced failure is a
    classified AuthzError.  Three rounds of seeded coins may all miss, so
    the first round's first router dispatch fails for certain (a
    reroute) before ``router.dispatch`` takes its coin for the rest."""
    rng = random.Random(CHAOS_SEED ^ 0xF1EE7)
    m = _metrics.default
    router = FleetRouter(config=CFG)
    _fixed_world(router)
    oracle = _oracle(router)

    def spawn(rid):
        return _replica(router, rid, mode="device")

    reps = {}
    for i in range(2):
        reps[i] = spawn(f"f{i}")
        router.add_replica(reps[i].host, reps[i].port, wait_ready_s=10.0)
    users = [f"user:fu{i}" for i in range(5)]
    mismatches, unclassified = [], []
    sheds = restarts = 0
    injected_before = m.counter("faults.injected")
    deaths_before = m.counter("fleet.replica_deaths")
    try:
        for site, p in FLEET_SITES:
            faults.arm(site, probability=p, seed=CHAOS_SEED ^ zlib.crc32(site.encode()))
        faults.arm("router.dispatch", times=1)
        for rnd in range(CHAOS_ROUNDS):
            if rnd == 1:
                faults.arm("router.dispatch", probability=FLEET_SITES[0][1],
                           seed=CHAOS_SEED ^ zlib.crc32(b"router.dispatch"))
            txn = rel.Txn()
            fresh = rel.must_from_triple(f"doc:fr{rnd}", "reader", rng.choice(users))
            txn.touch(fresh)
            zk = router.write(background(), txn)
            if rnd == CHAOS_ROUNDS // 2:
                victim = reps[0]
                conn = fwire.Conn((victim.host, victim.port))
                try:
                    with pytest.raises(ConnectionError):
                        conn.request({"op": "kill"})
                finally:
                    conn.close()
            queries = [
                rel.must_from_triple(
                    rng.choice([f"doc:base{rng.randrange(8)}", f"doc:fr{rnd}"]),
                    "read",
                    rng.choice(users + ["user:own0", "user:rd1", "user:tm1"]),
                )
                for _ in range(rng.randint(2, 5))
            ]
            ryw = rel.must_from_triple(
                fresh.resource_type + ":" + fresh.resource_id, "read",
                fresh.subject_type + ":" + fresh.subject_id,
            )
            ctx = background().with_timeout(15.0)
            try:
                if router.check(ctx, consistency.min_latency(), ryw, zookie=zk) != [True]:
                    mismatches.append((rnd, "zookie-ryw"))
                got = router.check(ctx, consistency.full(), *queries)
                want = oracle.check(background(), consistency.full(), *queries)
                if got != want:
                    mismatches.append((rnd, got, want))
            except (UnavailableError, DeadlineExceededError):
                sheds += 1
            except BaseException as e:
                if not isinstance(e, AuthzError):
                    unclassified.append((rnd, repr(e)))
            for i, r in list(reps.items()):
                if r._dead:
                    r.close()
                    nr = spawn(f"f{i}g{rnd}")
                    try:
                        router.add_replica(nr.host, nr.port, wait_ready_s=10.0)
                        reps[i] = nr
                        restarts += 1
                    except (AuthzError, ConnectionError):
                        # killed during admission (its first probe reset):
                        # the next round restarts it
                        nr.close()
    finally:
        for site, _ in FLEET_SITES:
            faults.disarm(site)
    _wait(lambda: bool(router.status()["ring"]), 10.0)
    final_q = [rel.must_from_triple(f"doc:fr{r}", "read", "user:fu0")
               for r in range(CHAOS_ROUNDS)]
    got = router.check(background().with_timeout(20.0), consistency.full(), *final_q)
    want = oracle.check(background(), consistency.full(), *final_q)
    try:
        assert not unclassified, f"unclassified exceptions: {unclassified}"
        assert not mismatches, f"oracle mismatches: {mismatches[:3]}"
        assert got == want
        assert m.counter("faults.injected") > injected_before
        assert m.counter("fleet.replica_deaths") > deaths_before
        assert restarts >= 1
        assert router.status()["ring"], "fleet never recovered"
        assert sheds <= 1, f"{sheds}/{CHAOS_ROUNDS} rounds shed"
    finally:
        router.close()
        for r in reps.values():
            r.close()
