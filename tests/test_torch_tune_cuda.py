"""The tuned non-pow2 latency ladder and the fleet on the card.

A tuned ladder (192, 576, 1344) captures one CUDA graph per
(permissions, tier), on both layouts, and every replay equals the eager
kernel planes and the plain planes; the placement budget counts what
other tenants of the card hold; two engines capture and replay from
their own threads at once with no capture failure; a router with two
``cuda`` replicas answers as the host oracle, writes included.

The module imports only the port (no JAX), so it runs on a machine with an
NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_tune_cuda.py`` from the repository root.  Here, without a
card, every test skips.  All outputs are int or bool: the tolerance is
exact equality.
"""

import gc
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch

from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build

from test_torch_latency_cuda import EPOCH, _queries, _rbac, _same

TUNED_TIERS = (192, 576, 1344)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
def test_tuned_ladder_captures_once_per_key_and_replays_eager(cuda_device, aligned):
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    cfg = dict(latency_tiers=TUNED_TIERS, flat_aligned=aligned)
    pe = PEngine(cs, PConfig(kernels=True, **cfg), device=cuda_device)
    pp = PEngine(cs, PConfig(kernels=False, **cfg), device=cuda_device)
    ds = pe.prepare(snap)
    lp = pe.latency_path(ds)
    keys = set()
    for rep in range(3):
        for B, tier in ((1, 192), (150, 192), (192, 192), (193, 576), (576, 576),
                        (900, 1344), (1344, 1344)):
            q = _queries(users, repos, slot, B, seed=B + 7 * rep)
            got = lp.dispatch_columns(*q, now_us=EPOCH)
            assert lp.last_budget.tier == tier
            keys.add((tuple(np.unique(q[1])), tier))
            assert _same(got, pe.check_columns(ds, *q, now_us=EPOCH)), B
            assert _same(got, pp.check_columns(ds, *q, now_us=EPOCH)), B
    pins = lp.pins()
    assert lp.compile_count == len(pins) == len(keys)
    assert all(pin.graph is not None for pin in pins.values())
    assert sorted({k[1] for k in pins}) == list(TUNED_TIERS)
    modes = {}
    for pin in pins.values():
        for k, n in pin.modes.items():
            modes[k] = modes.get(k, 0) + n
    pre = "aligned." if aligned else ""
    assert modes.get(pre + "block") and modes.get(pre + "gate"), modes


@pytest.mark.cuda
def test_snapshot_placement_budget_counts_other_tenants(cuda_device):
    """On ``cuda`` the tuner's placement budget is the card's free memory
    when the snapshot is taken (the allocator's unused cache included)
    plus the tables' own bytes, so memory that another tenant of the card
    holds is outside it."""
    from gochugaru_tpu_torch.tune import collect_snapshot
    from gochugaru_tpu_torch.utils import metrics

    cs, snap, *_ = _rbac(p_compile, p_parse, PInterner(), p_build)
    ds = PEngine(cs, PConfig(), device=cuda_device).prepare(snap)
    tables = sum(v.nbytes for v in ds.arrays.values())
    card = torch.cuda.get_device_properties(0).total_memory

    def budget():
        return collect_snapshot(metrics.default, dsnap=ds)["bytes"]["device_budget"]

    alone = budget()
    assert tables <= alone <= card
    other = torch.empty(1 << 30, dtype=torch.uint8, device=cuda_device)
    try:
        assert budget() <= alone - (1 << 30) + (64 << 20)
    finally:
        del other
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_no_collection_runs_inside_a_capture(cuda_device):
    """A collection inside a capture may destroy an earlier graph held by
    cyclic garbage (a dropped snapshot and its latency path), which the
    capturing thread may not do while its stream records: the capture is
    invalidated (the aligned ladder above, run after the off+interleave
    one, failed so before the engine paused the collector).  With the
    collector set to run at every allocation, no collection starts while
    a stream captures, the collector is on again afterwards, and the
    replay equals the eager planes."""
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    old = PEngine(cs, PConfig(kernels=True), device=cuda_device)
    ds = old.prepare(snap)
    lp = old.latency_path(ds)
    lp.dispatch_columns(*_queries(users, repos, slot, 100, seed=1), now_us=EPOCH)
    assert any(pin.graph is not None for pin in lp.pins().values())
    del old, ds, lp
    pe = PEngine(cs, PConfig(kernels=True, latency_tiers=TUNED_TIERS),
                 device=cuda_device)
    ds2 = pe.prepare(snap)
    lp2 = pe.latency_path(ds2)
    inside = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            inside.append(info["generation"])

    th = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    try:
        outs = [(q, lp2.dispatch_columns(*q, now_us=EPOCH)) for q in (
            _queries(users, repos, slot, B, seed=B) for B in (100, 500, 1000))]
    finally:
        gc.set_threshold(*th)
        gc.callbacks.remove(watch)
    assert inside == []
    assert gc.isenabled()
    assert lp2.compile_count == 3
    for q, got in outs:
        assert _same(got, pe.check_columns(ds2, *q, now_us=EPOCH))


@pytest.mark.cuda
def test_two_engines_capture_and_replay_from_their_own_threads(cuda_device):
    """Each thread owns an engine over its own world and walks the
    tuned ladder, capturing while the other replays or runs eagerly:
    every answer equals its eager planes, no capture fails."""
    worlds = []
    for seed in (7, 8):
        cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build,
                                             seed=seed)
        pe = PEngine(cs, PConfig(kernels=True, latency_tiers=TUNED_TIERS),
                     device=cuda_device)
        worlds.append((pe, pe.prepare(snap), users, repos, slot))
    errors, checked = [], [0, 0]

    def run(i):
        pe, ds, users, repos, slot = worlds[i]
        lp = pe.latency_path(ds)
        rng = np.random.default_rng(i)
        try:
            for k in range(120):
                B = int(rng.integers(1, TUNED_TIERS[-1] + 1))
                q = _queries(users, repos, slot, B, seed=int(rng.integers(1 << 30)))
                got = lp.dispatch_columns(*q, now_us=EPOCH)
                if k % 3 == 0:
                    if not _same(got, pe.check_columns(ds, *q, now_us=EPOCH)):
                        errors.append((i, k, "planes"))
                checked[i] += 1
        except BaseException as e:  # surfaced below
            errors.append((i, repr(e)))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    assert checked == [120, 120]
    assert not torch.cuda.is_current_stream_capturing()


@pytest.mark.cuda
def test_fleet_of_two_cuda_replicas_answers_as_the_oracle(cuda_device):
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_host_only_evaluation, with_latency_mode, with_store,
        with_verdict_cache,
    )
    from gochugaru_tpu_torch.fleet import FleetConfig, FleetRouter, Replica
    from gochugaru_tpu_torch.utils.context import background

    cfg = replace(FleetConfig(), probe_interval_s=0.05, probe_timeout_s=2.0,
                  heartbeat_s=0.05, freshness_wait_s=20.0)
    router = FleetRouter(config=cfg)
    reps = []
    try:
        ctx = background()
        router.write_schema(ctx, """
        definition user {}
        definition team { relation member: user }
        definition doc {
            relation reader: user | team#member
            relation banned: user
            permission read = reader - banned
        }""")
        txn = rel.Txn()
        for i in range(200):
            txn.touch(rel.must_from_triple(f"doc:d{i}", "reader", f"user:u{i % 17}"))
            txn.touch(rel.must_from_tuple(f"doc:d{i}#reader", f"team:t{i % 5}#member"))
        for u in range(40):
            txn.touch(rel.must_from_triple(f"team:t{u % 5}", "member", f"user:u{u}"))
        router.write(ctx, txn)
        for i in range(2):
            r = Replica(("127.0.0.1", router.port), replica_id=f"c{i}", config=cfg,
                        client_options=(with_verdict_cache(), with_latency_mode()))
            reps.append(r)
            assert r._client.device.type == "cuda"
            router.add_replica(r.host, r.port, wait_ready_s=120.0)
        oracle = new_evaluator(with_store(router.store), with_host_only_evaluation())
        rng = np.random.default_rng(3)
        for k in range(12):
            t = (f"doc:d{rng.integers(200)}", "banned", f"user:u{rng.integers(40)}")
            txn = rel.Txn()
            txn.touch(rel.must_from_triple(*t))
            zk = router.write(ctx, txn)
            qs = [rel.must_from_triple(f"doc:d{rng.integers(200)}", "read",
                                       f"user:u{rng.integers(40)}") for _ in range(64)]
            qs.append(rel.must_from_triple(t[0], "read", t[2]))
            want = oracle.check(ctx, consistency.full(), *qs)
            assert router.check(ctx, consistency.min_latency(), *qs, zookie=zk) == want
            assert router.check(ctx, consistency.full(), *qs) == want
    finally:
        router.close()
        for r in reps:
            r.close()
