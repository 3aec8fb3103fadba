"""The port's self-tuning package (gochugaru_tpu_torch/tune/) against the
reference's (gochugaru_tpu/tune/).

First the reference's own tests of tests/test_tune.py, on the port: the
offline tuner's fixed-point and JSON round-trip contracts, the
no-recapture and parity invariants on tuned NON-pow2 tier ladders (on
``cpu`` a pin runs the eager program over its static buffers, with the
plain versions), and the online controller's safety envelope.  The
reference's ``pallas`` knob is the port's ``kernels``; the rule's veto is
"the kernels cannot launch here" (no CUDA device or kernel library),
since ``kernels=True`` raises where the reference's ``pallas=True``
degraded.

Then parity with the reference: identical events fed into both
packages' ``Metrics`` give equal ``collect_snapshot`` dicts (apart from
the ``pallas``/``kernels`` section and config keys), ``propose`` gives
equal diffs and ``apply_diff`` equal targets on 50 snapshots made from
numpy seeds (knob name, and the evidence wording of the kernels and
placement rules, mapped), ``placement_split`` equal splits, the
controller an equal trajectory, and the tuned ladder (192, 576, 1344) the
reference latency path's planes with ``pallas=False``.  All compared
values are exact (ints, bools, strings, floats computed by the same
arithmetic): the tolerance is equality.
"""

import json
import urllib.request
from dataclasses import fields, replace

import numpy as np
import pytest

from gochugaru_tpu.engine.device import DeviceEngine as JEngine
from gochugaru_tpu.engine.flat import placement_split as j_placement_split
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.serve import ServeConfig as JServeConfig
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.snapshot import build_snapshot_from_columns as j_build
from gochugaru_tpu import tune as JT
from gochugaru_tpu.tune import tuner as JTuner
from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils import perf as jperf

from gochugaru_tpu_torch import consistency, rel
from gochugaru_tpu_torch.client import (
    new_evaluator,
    with_engine_config,
    with_host_only_evaluation,
    with_latency_mode,
    with_store,
)
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.flat import placement_split
from gochugaru_tpu_torch.engine.latency import tier_for
from gochugaru_tpu_torch.engine.plan import EngineConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.serve import ServeConfig
from gochugaru_tpu_torch.store.delta import apply_delta as p_apply
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from gochugaru_tpu_torch.tune import (
    OnlineController,
    TuneDiff,
    TuneTarget,
    apply_diff,
    collect_snapshot,
    propose,
)
from gochugaru_tpu_torch.tune import snapshot as TS
from gochugaru_tpu_torch.tune import tuner as TT
from gochugaru_tpu_torch.utils import faults, metrics, perf, slo, trace
from gochugaru_tpu_torch.utils.context import background
from gochugaru_tpu_torch.utils.telemetry import TelemetryServer

from test_torch_latency_cuda import EPOCH, _queries, _rbac, _same

#: a ladder the offline tuner could emit: nothing pow2-aligned
TUNED_TIERS = (192, 576, 1344)


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The port's process-globals (the conftest resets the reference's)."""
    trace.disable()
    faults.reset()
    yield
    trace.disable()
    trace.install_recorder(None)
    slo.install_engine(None)
    faults.reset()


def _synthetic_registry():
    """A registry describing a workload with an oversized 1024 tier,
    clock-bound flushes, and near-zero duplicate checks."""
    m = metrics.Metrics()
    for _ in range(40):
        m.observe_hist(
            "serve.occupancy.t1024", 120.0, (64, 128, 256, 512, 1024)
        )
        m.inc("serve.flush_maxhold")
    for _ in range(4):
        m.inc("serve.flush_full")
    m.inc("serve.checks", 1000)
    m.inc("serve.unique_checks", 990)
    return m


# ---------------------------------------------------------------------------
# offline tuner (tests/test_tune.py, on the port)
# ---------------------------------------------------------------------------

def test_propose_fixed_point_and_json_roundtrip():
    m = _synthetic_registry()
    eng = EngineConfig(latency_tiers=(256, 1024, 4096))
    srv = ServeConfig()
    snap = collect_snapshot(m, engine_config=eng, serve_config=srv)
    target = TuneTarget(engine=eng, serve=srv, cache_bytes=None)
    diff = propose(snap, target)
    assert diff, "the synthetic workload must produce proposals"
    knobs = {k.knob for k in diff.knobs}
    assert "latency_tiers" in knobs and "hold_max_s" in knobs
    for k in diff.knobs:
        assert k.evidence, f"{k.knob} proposal carries no evidence"
        assert k.predicted, f"{k.knob} proposal carries no prediction"
    tuned = apply_diff(target, diff)
    assert not propose(snap, tuned), "re-propose after apply must be empty"
    rt = TuneDiff.from_json(diff.to_json())
    assert rt == diff


def test_propose_quiet_on_thin_evidence():
    m = metrics.Metrics()
    snap = collect_snapshot(
        m, engine_config=EngineConfig(), serve_config=ServeConfig()
    )
    assert not propose(
        snap,
        TuneTarget(engine=EngineConfig(), serve=ServeConfig(),
                   cache_bytes=None),
    )


def test_kernels_rule_proposes_from_byte_model_and_fixed_point(monkeypatch):
    """The kernels knob follows the flat_packed discipline: evidence is
    the one-pass byte model prepare publishes (``perf.kernels.*`` gauges
    in the measured registry), the proposal carries the saved fraction,
    and applying it reaches the fixed point.  ``available`` is the probe
    of a card with its kernel library, stood in for here."""
    monkeypatch.setattr(K, "available", lambda: True)
    m = metrics.Metrics()
    m.set_gauge("perf.kernels.bytes_per_check", 300.0)
    m.set_gauge("perf.kernels.bytes_saved_per_check", 900.0)  # 75% saved
    eng = EngineConfig(kernels=False)
    snap = collect_snapshot(m, engine_config=eng, serve_config=ServeConfig())
    assert snap["config"]["kernels_resolved"] is False
    assert snap["kernels"]["available"] is True
    target = TuneTarget(engine=eng, serve=ServeConfig(), cache_bytes=None)
    diff = propose(snap, target)
    kd = next(k for k in diff.knobs if k.knob == "kernels")
    assert kd.layer == "engine" and kd.proposed is True
    assert "byte model" in kd.evidence
    assert kd.predicted["bytes_per_check_frac"] == pytest.approx(-0.75)
    tuned = apply_diff(target, diff)
    assert tuned.engine.kernels is True
    assert not propose(snap, tuned), "re-propose after apply must be empty"


def test_kernels_rule_vetoes_when_unavailable_and_silent_without_model(
    monkeypatch,
):
    """Where the kernels cannot launch the knob is vetoed however good
    the model looks; with no fused prepare measured the rule stays
    silent rather than guessing."""
    monkeypatch.setattr(K, "available", lambda: False)
    m = metrics.Metrics()
    m.set_gauge("perf.kernels.bytes_per_check", 300.0)
    m.set_gauge("perf.kernels.bytes_saved_per_check", 900.0)
    eng = EngineConfig(kernels=True)
    snap = collect_snapshot(m, engine_config=eng, serve_config=ServeConfig())
    assert "degraded" not in snap["kernels"]
    target = TuneTarget(engine=eng, serve=ServeConfig(), cache_bytes=None)
    diff = propose(snap, target)
    kd = next(k for k in diff.knobs if k.knob == "kernels")
    assert kd.proposed is False and "vetoed" in kd.evidence
    assert apply_diff(target, diff).engine.kernels is False
    monkeypatch.setattr(K, "available", lambda: True)
    m2 = metrics.Metrics()
    snap2 = collect_snapshot(
        m2, engine_config=EngineConfig(), serve_config=ServeConfig()
    )
    assert not any(
        k.knob == "kernels"
        for k in propose(
            snap2,
            TuneTarget(engine=EngineConfig(), serve=ServeConfig(),
                       cache_bytes=None),
        ).knobs
    )


def test_tiers_rule_emits_non_pow2():
    m = metrics.Metrics()
    for _ in range(32):
        m.observe_hist(
            "serve.occupancy.t1024", 131.0,
            (64, 131, 256, 512, 1024),
        )
    eng = EngineConfig(latency_tiers=(1024, 4096))
    snap = collect_snapshot(m, engine_config=eng, serve_config=ServeConfig())
    diff = propose(
        snap, TuneTarget(engine=eng, serve=ServeConfig(), cache_bytes=None)
    )
    kd = diff.get("latency_tiers")
    assert kd is not None
    assert 320 in kd.proposed, kd.proposed
    assert "131" in kd.evidence


def test_tiers_rule_inserts_below_shared_tier():
    m = metrics.Metrics()
    for _ in range(32):
        m.observe_hist(
            "serve.occupancy.t1024", 20.0, (64, 131, 256, 512, 1024)
        )
    for _ in range(40):
        perf.record_pad(1024, 800, m)
    for _ in range(32):
        perf.record_pad(1024, 20, m)
    eng = EngineConfig(latency_tiers=(1024, 4096))
    snap = collect_snapshot(m, engine_config=eng, serve_config=ServeConfig())
    diff = propose(
        snap, TuneTarget(engine=eng, serve=ServeConfig(), cache_bytes=None)
    )
    kd = diff.get("latency_tiers")
    assert kd is not None
    assert kd.proposed == (128, 1024, 4096), kd.proposed
    assert "insert" in kd.evidence and "stays" in kd.evidence


# ---------------------------------------------------------------------------
# tuned non-pow2 ladders keep the latency-path contracts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tuned_world():
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    engine = DeviceEngine(
        cs, EngineConfig(latency_tiers=TUNED_TIERS), device="cpu"
    )
    dsnap = engine.prepare(snap)
    return engine, dsnap, snap, users, repos, slot


def test_nonpow2_tier_for_routing():
    assert tier_for(TUNED_TIERS, 1) == 192
    assert tier_for(TUNED_TIERS, 192) == 192
    assert tier_for(TUNED_TIERS, 193) == 576
    assert tier_for(TUNED_TIERS, 1344) == 1344
    assert tier_for(TUNED_TIERS, 1345) is None


def test_nonpow2_ladder_no_recapture_and_parity(tuned_world):
    """110 warm dispatches on a tuned (192, 576, 1344) ladder pay zero
    additional captures and zero ``latency.retraces``, with answers
    identical to the throughput path."""
    engine, dsnap, snap, users, repos, slot = tuned_world
    lp = engine.latency_path(dsnap)
    q_res, q_perm, q_subj = _queries(users, repos, slot, 500, seed=23)
    retr0 = metrics.default.counter("latency.retraces")
    out = lp.dispatch_columns(q_res, q_perm, q_subj, now_us=EPOCH)
    assert out is not None
    assert lp.last_budget.tier == 576
    warm = lp.compile_count
    for i in range(110):
        d, p, o = lp.dispatch_columns(
            np.roll(q_res, i), q_perm, np.roll(q_subj, i), now_us=EPOCH
        )
        if i % 37 == 0:
            dd, pp, oo = engine.check_columns(
                dsnap, np.roll(q_res, i), q_perm, np.roll(q_subj, i),
                now_us=EPOCH,
            )
            assert (d == dd).all() and (p == pp).all() and (o == oo).all()
    assert lp.compile_count == warm, "non-pow2 ladder recaptured"
    assert metrics.default.counter("latency.retraces") == retr0
    lp.dispatch_columns(q_res[:100], q_perm[:100], q_subj[:100], now_us=EPOCH)
    assert lp.last_budget.tier == 192
    warm2 = lp.compile_count
    lp.dispatch_columns(q_res[:150], q_perm[:150], q_subj[:150], now_us=EPOCH)
    assert lp.compile_count == warm2


def test_nonpow2_ladder_pins_shared_along_a_delta_chain(tuned_world):
    """The revisions of a delta chain in one shape band share the
    tuned-tier pin its first revision captured: zero new captures, each
    revision its own answers.  (A FULL re-prepare ships new tensors,
    which a captured graph cannot rebind, so there the port captures
    anew: tests/test_torch_latency.py::
    test_full_reprepare_and_grown_band_capture_anew.)"""
    engine, dsnap, snap, users, repos, slot = tuned_world
    q_res, q_perm, q_subj = _queries(users, repos, slot, 150, seed=29)
    prev, paths = dsnap, []
    for k, user in enumerate(("user:u1", "user:u2")):
        snap = p_apply(snap, snap.revision + 1,
                       [rel.must_from_triple(f"repo:r{k}", "reader", user)], [],
                       interner=snap.interner)
        prev = engine.prepare(snap, prev=prev)
        assert prev.flat_meta.delta is not None
        lp = engine.latency_path(prev)
        out = lp.dispatch_columns(q_res, q_perm, q_subj, now_us=EPOCH)
        assert out is not None and lp.last_budget.tier == 192
        assert _same(out, engine.check_columns(prev, q_res, q_perm, q_subj,
                                               now_us=EPOCH))
        paths.append(lp)
    assert paths[0].dsnap.flat_meta == paths[1].dsnap.flat_meta
    assert [lp.compile_count for lp in paths] == [1, 0], (
        "tuned-tier pins were not shared")


def test_serving_on_tuned_ladder_parity_and_occupancy():
    cfg = replace(EngineConfig(), latency_tiers=(48, 192, 576))
    c = new_evaluator(with_latency_mode(), with_engine_config(cfg), device="cpu")
    ctx = background()
    c.write_schema(ctx, """
    definition user {}
    definition doc { relation reader: user  permission read = reader }
    """)
    txn = rel.Txn()
    for i in range(40):
        txn.touch(rel.must_from_triple(f"doc:d{i}", "reader", f"user:u{i % 9}"))
    c.write(ctx, txn)
    oracle = new_evaluator(with_host_only_evaluation(), with_store(c.store))
    cs = consistency.full()
    rng = np.random.default_rng(31)
    retr0 = metrics.default.counter("latency.retraces")
    with c.with_serving() as h:
        for _ in range(12):
            qs = [
                rel.must_from_triple(
                    f"doc:d{rng.integers(40)}", "read",
                    f"user:u{rng.integers(9)}",
                )
                for _ in range(6)
            ]
            assert list(h.check(ctx, *qs)) == list(oracle.check(ctx, cs, *qs))
    assert metrics.default.counter("latency.retraces") == retr0
    occ = [
        n for n in metrics.default.hist_snapshot()
        if n.startswith("serve.occupancy.t")
    ]
    assert "serve.occupancy.t48" in occ, occ


# ---------------------------------------------------------------------------
# online controller
# ---------------------------------------------------------------------------

class FakeBatcher:
    def __init__(self, config_cls=ServeConfig, **kw):
        self.config = config_cls(**kw)
        self._top = 4096
        self.applies = 0

    def apply_config(self, cfg):
        self.config = cfg
        self.applies += 1


class FakeVcache:
    def __init__(self, max_bytes):
        self.max_bytes = max_bytes

    def set_max_bytes(self, n):
        self.max_bytes = int(n)


def _deadline_window(m, n=10):
    for _ in range(n):
        m.inc("serve.flush_deadline")


def test_controller_hysteresis_dead_band():
    m = metrics.Metrics()
    b = FakeBatcher()
    c = OnlineController(b, registry=m, cooldown_steps=0)
    for _ in range(5):
        for _ in range(5):
            m.inc("serve.flush_maxhold")
        for _ in range(2):
            m.inc("serve.flush_deadline")
        for _ in range(3):
            m.inc("serve.flush_full")
        for _ in range(4):
            m.observe_hist(
                "serve.occupancy.t1024", 410.0, (64, 128, 256, 512, 1024)
            )
        assert c.step() == 0
    assert b.applies == 0 and b.config == ServeConfig()


def test_controller_cooldown_blocks_next_move():
    m = metrics.Metrics()
    b = FakeBatcher()
    c = OnlineController(b, registry=m, cooldown_steps=1)
    _deadline_window(m)
    assert c.step() == 1 and b.config.hold_max_s == 0.001
    _deadline_window(m)
    assert c.step() == 0, "cooldown must block the very next tick"
    _deadline_window(m)
    assert c.step() == 1 and b.config.hold_max_s == 0.0005


def test_controller_converges_bounded_under_load_shift():
    m = metrics.Metrics()
    b = FakeBatcher()
    c = OnlineController(b, registry=m, cooldown_steps=0,
                         hold_bounds=(0.0005, 0.008))
    trajectory = [b.config.hold_max_s]
    for _ in range(8):
        _deadline_window(m)
        c.step()
        trajectory.append(b.config.hold_max_s)
    assert trajectory[0] == 0.002
    assert all(a >= z for a, z in zip(trajectory, trajectory[1:]))
    assert trajectory[-1] == 0.0005
    assert c.moves == 2
    assert m.counter("tune.moves") == 2
    assert m.gauge("tune.hold_max_s") == 0.0005
    assert "hold_max_s" not in c._frozen


def test_controller_cache_knob_grow_shrink_clamped():
    m = metrics.Metrics()
    b = FakeBatcher()
    vc = FakeVcache(32 << 20)
    c = OnlineController(b, vcache=vc, registry=m, cooldown_steps=0,
                         cache_bounds=(16 << 20, 64 << 20))
    m.inc("cache.hits", 50)
    m.inc("cache.misses", 50)
    m.inc("cache.evicted_revisions", 2)
    m.set_gauge("cache.bytes", float(int(0.9 * (32 << 20))))
    assert c.step() == 1 and vc.max_bytes == 64 << 20
    m.inc("cache.hits", 50)
    m.inc("cache.misses", 50)
    m.inc("cache.evicted_revisions", 2)
    m.set_gauge("cache.bytes", float(int(0.9 * (64 << 20))))
    assert c.step() == 0
    for _ in range(3):
        m.inc("cache.misses", 100)
        m.set_gauge("cache.bytes", 1024.0)
        c.step()
    assert vc.max_bytes == 16 << 20
    assert m.gauge("tune.vcache_bytes") == float(16 << 20)


def test_controller_dedup_off_only_on_measured_uniqueness():
    m = metrics.Metrics()
    b = FakeBatcher()
    c = OnlineController(b, registry=m, cooldown_steps=0)
    m.inc("serve.checks", 1000)
    m.inc("serve.unique_checks", 700)
    assert c.step() == 0 and b.config.dedup is True
    m.inc("serve.checks", 1000)
    m.inc("serve.unique_checks", 999)
    assert c.step() == 1 and b.config.dedup is False
    m.inc("serve.checks", 1000)
    assert c.step() == 0 and b.config.dedup is False


def test_controller_oscillation_trips_incident_and_freezes():
    m = metrics.Metrics()
    rec = trace.install_recorder(
        trace.FlightRecorder(grace_s=0.0, cooldown_s=0.0)
    )
    b = FakeBatcher()
    c = OnlineController(b, registry=m, cooldown_steps=0, osc_flips=3)
    for i in range(12):
        if "hold_max_s" in c._frozen:
            break
        if i % 2 == 0:
            _deadline_window(m)
        else:
            for _ in range(10):
                m.inc("serve.flush_maxhold")
            for _ in range(5):
                m.observe_hist(
                    "serve.occupancy.t1024", 900.0,
                    (64, 128, 256, 512, 1024),
                )
        c.step()
    assert "hold_max_s" in c._frozen
    assert m.counter("tune.oscillations") >= 1
    assert m.gauge("tune.frozen_knobs") == 1.0
    assert any(
        i["trigger"] == "tune.oscillation" for i in rec.incident_index()
    )
    held = b.config.hold_max_s
    _deadline_window(m)
    assert c.step() == 0 and b.config.hold_max_s == held


def test_controller_revert_restores_preset():
    m = metrics.Metrics()
    b = FakeBatcher()
    vc = FakeVcache(32 << 20)
    c = OnlineController(b, vcache=vc, registry=m, cooldown_steps=0)
    _deadline_window(m)
    c.step()
    m.inc("serve.checks", 1000)
    m.inc("serve.unique_checks", 999)
    c.step()
    for _ in range(3):
        m.inc("cache.misses", 100)
        m.set_gauge("cache.bytes", 1024.0)
        c.step()
    c._frozen.add("hold_max_s")
    assert b.config.hold_max_s != 0.002 or not b.config.dedup
    c.revert()
    assert b.config == ServeConfig()
    assert vc.max_bytes == 32 << 20
    assert c._frozen == set()
    assert m.counter("tune.reverts") == 1
    assert m.gauge("tune.hold_max_s") == 0.002
    assert m.gauge("tune.dedup") == 1.0
    _deadline_window(m)
    assert c.step() == 1


# ---------------------------------------------------------------------------
# the port's own surface: the device budget, /tune, the no-JAX import
# ---------------------------------------------------------------------------

def test_placement_budget_is_the_snapshots_device_memory():
    """A snapshot prepared on ``cuda`` carries its placement budget (the
    card's free memory when it was taken plus the tables' resident
    bytes); one that names no device falls back to
    ``NO_DEVICE_BUDGET_BYTES``; an explicit budget wins over both."""
    base = {"config": {"placement": "routed"},
            "bytes": {"total": 6 << 30, "sharded": 1 << 30}}
    kd = propose(base).get("placement")
    assert kd.proposed == "replicated"
    assert f"{TT.NO_DEVICE_BUDGET_BYTES >> 20}MiB device memory budget" in kd.evidence
    assert "exceed" in kd.evidence
    card = {"config": {"placement": "routed"},
            "bytes": dict(base["bytes"], device_budget=80 << 30)}
    kd = propose(card).get("placement")
    assert "fit the 81920MiB device memory budget" in kd.evidence
    shared = {"config": {"placement": "routed"},
              "bytes": dict(base["bytes"], device_budget=5 << 30)}
    kd = propose(shared).get("placement")
    assert "5120MiB" in kd.evidence and "exceed" in kd.evidence
    kd = propose(card, hbm_budget_bytes=2 << 30).get("placement")
    assert "2048MiB" in kd.evidence and "exceed" in kd.evidence


def test_kernels_resolved_reads_the_switch_without_raising():
    assert TS.kernels_resolved(EngineConfig(kernels=None), "cpu") is False
    assert TS.kernels_resolved(EngineConfig(kernels=None), "cuda") is True
    assert TS.kernels_resolved(EngineConfig(kernels=True), "cpu") is True
    assert TS.kernels_resolved(EngineConfig(kernels=False), "cuda") is False
    assert K.available() is False  # this machine: no CUDA device


def test_tune_endpoint_serves_the_controller():
    """``TelemetryServer(controller=...)`` answers /tune with
    ``enabled: true``, the live and frozen knobs and the ``tune.*``
    counters; without a controller ``enabled: false``."""
    m = metrics.Metrics()
    b = FakeBatcher()
    c = OnlineController(b, registry=m, cooldown_steps=0)
    _deadline_window(m)
    assert c.step() == 1
    for ctl, want in ((c, True), (None, False)):
        srv = TelemetryServer(port=0, registry=m, controller=ctl)
        try:
            with urllib.request.urlopen(srv.url + "/tune", timeout=10) as r:
                body = json.loads(r.read())
        finally:
            srv.close()
        assert body["enabled"] is want
        assert body["counters"]["tune.moves"] == 1.0
        if want:
            st = body["status"]
            assert st["hold_max_s"] == 0.001 and st["frozen"] == []
            assert st["preset_hold_max_s"] == 0.002


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _feed(m, rng_seed):
    """One seeded event stream into a registry (either package's)."""
    rng = np.random.default_rng(rng_seed)
    buckets = (64, 128, 256, 512, 1024)
    for tier in (256, 1024):
        for v in rng.integers(1, tier + 1, 30):
            m.observe_hist(f"serve.occupancy.t{tier}", float(v), buckets)
    for r, n in zip(("full", "maxhold", "deadline", "drain"),
                    rng.integers(0, 40, 4)):
        m.inc(f"serve.flush_{r}", int(n))
    for name in ("serve.checks", "serve.unique_checks", "serve.submissions",
                 "serve.batches", "serve.sheds", "serve.dedup_parked",
                 "cache.hits", "cache.misses", "cache.evicted_revisions",
                 "store.bg_compactions", "write.groups"):
        m.inc(name, int(rng.integers(0, 500)))
    for s in rng.random(50) * 1e-3:
        m.observe("serve.queue_wait_s", float(s))
    m.set_gauge("store.lsm_overlay_rows", float(rng.integers(0, 9000)))
    m.set_gauge("store.lsm_chain_len", float(rng.integers(0, 9)))


def _mapped(d):
    """A port snapshot dict in the reference's names, minus the section
    and config keys that differ by design."""
    d = json.loads(json.dumps(d))
    d.pop("kernels", None)
    d.pop("pallas", None)
    for k in ("kernels", "kernels_resolved", "pallas", "pallas_resolved"):
        d.get("config", {}).pop(k, None)
    return d


def test_collect_snapshot_matches_reference(monkeypatch):
    jm, pm = jmetrics.Metrics(), metrics.Metrics()
    for m in (jm, pm):
        _feed(m, 5)
    for mod in (jperf, perf):
        monkeypatch.setattr(mod, "last_model", lambda: None)
        monkeypatch.setattr(mod, "last_wall", lambda: None)
    for m, mod in ((jm, jperf), (pm, perf)):
        mod.record_pad(1024, 300, m)
        mod.record_pad(256, 40, m)
    from gochugaru_tpu.engine.vcache import VerdictCache as JVC
    from gochugaru_tpu_torch.engine.vcache import VerdictCache as PVC

    jsnap = JT.collect_snapshot(
        jm, engine_config=JConfig(latency_tiers=(256, 1024)),
        serve_config=JServeConfig(hold_max_s=0.004), vcache=JVC(1 << 24, registry=jm),
        packed_candidates={"packed": 10.0, "unpacked": 30.0},
    )
    psnap = collect_snapshot(
        pm, engine_config=EngineConfig(latency_tiers=(256, 1024)),
        serve_config=ServeConfig(hold_max_s=0.004), vcache=PVC(1 << 24, registry=pm),
        packed_candidates={"packed": 10.0, "unpacked": 30.0},
    )
    assert _mapped(psnap) == _mapped(jsnap)
    assert psnap["config"]["kernels"] is None
    assert psnap["config"]["kernels_resolved"] is False
    assert set(psnap["kernels"]) == {"available", "bytes_per_check",
                                     "bytes_saved_per_check"}
    assert jsnap["pallas"]["bytes_per_check"] == psnap["kernels"]["bytes_per_check"]


#: the reference's evidence wording -> the port's (the kernel switch's
#: name, what it is weighed against, the budget's name)
_WORDING = (("pallas=", "kernels="), (" vs XLA ", " vs plain "),
            ("MiB HBM budget", "MiB device memory budget"),
            ("jax.experimental.pallas unavailable on this jaxlib",
             "no CUDA device or kernel library"))


def _port_words(s):
    for a, b in _WORDING:
        s = s.replace(a, b)
    return s


def _seeded_snapshot(seed):
    """A reference-shaped and a port-shaped snapshot dict from one seed:
    occupancy histograms, flush mixes, cache stats, chain gauges, byte
    models and placement bytes, drawn so that every rule fires on some
    seeds and stays silent on others."""
    rng = np.random.default_rng(seed)
    tiers = sorted({int(t) for t in rng.choice([64, 128, 192, 256, 512, 576,
                                                1024, 1344, 4096],
                                               rng.integers(1, 4), replace=False)})
    occ = {}
    for t in tiers:
        if rng.random() < 0.8:
            n = int(rng.integers(0, 60))
            bk = sorted({int(b) for b in (t // 8, t // 4, t // 2, t)} - {0})
            live = rng.integers(1, max(2, int(t * rng.random()) + 1), n)
            counts = [int(((live <= b) & (live > (bk[i - 1] if i else 0))).sum())
                      for i, b in enumerate(bk)]
            occ[str(t)] = {"buckets": [float(b) for b in bk], "counts": counts,
                           "count": n, "sum": float(live.sum())}
    flush = {r: int(x) for r, x in zip(("full", "maxhold", "deadline", "drain"),
                                       rng.integers(0, 30, 4))}
    checks = int(rng.integers(0, 3000))
    serve = {"checks": checks,
             "unique_checks": int(checks * rng.choice([1.0, 0.999, 0.98, 0.5])),
             "submissions": 0, "batches": 0, "sheds": 0,
             "dedup_parked": int(rng.integers(0, 50))}
    mx = int(rng.choice([4 << 20, 8 << 20, 64 << 20, 256 << 20]))
    hits, misses = int(rng.integers(0, 400)), int(rng.integers(0, 400))
    cache = {"bytes": int(mx * rng.random()), "max_bytes": mx, "hits": hits,
             "misses": misses,
             "hit_rate": round(hits / (hits + misses), 4) if hits + misses else 0.0,
             "evicted_revisions": int(rng.integers(0, 3))}
    pad = {}
    per_tier = {}
    for t in tiers:
        if rng.random() < 0.5:
            tot = float(t * rng.integers(1, 80))
            per_tier[str(t)] = {"live": float(tot * rng.random()), "total": tot}
    if per_tier:
        pad["per_tier"] = per_tier
    fused = float(rng.choice([0.0, 300.0, 1000.0]))
    saved = float(rng.choice([0.0, 50.0, 900.0]))
    avail = bool(rng.random() < 0.8)
    total = int(rng.integers(1, 12)) << 30
    by = {"total": total, "sharded": int(total * rng.random()),
          "per_check": 123.0}
    by["replicated"] = by["total"] - by["sharded"]
    if rng.random() < 0.5:
        by["candidates"] = {"packed": float(rng.integers(1, 100)),
                            "unpacked": float(rng.integers(1, 100))}
    cm = int(rng.choice([4096, 65_536, 1 << 20]))
    chain = {"overlay_rows": float(rng.integers(0, 2 * cm)),
             "chain_len": float(rng.integers(0, 9)),
             "bg_compactions": int(rng.choice([0, 2, 6])),
             "batch_applies": 0, "groups": 1}
    cfg = {"placement": str(rng.choice(["replicated", "routed"])),
           "latency_tiers": tiers, "flat_packed": None,
           "flat_packed_resolved": bool(rng.random() < 0.5),
           "lsm_compact_min": cm, "hold_max_s": float(rng.choice(JTuner.HOLD_LADDER)),
           "dedup": bool(rng.random() < 0.5), "cache_max_bytes": mx}
    knob = rng.choice([None, True, False])
    knob = None if knob is None else bool(knob)
    resolved = bool(knob) if knob is not None else False
    common = {"version": 1, "occupancy": occ, "flush": flush, "serve": serve,
              "cache": cache, "pad": pad, "bytes": by, "chain": chain}
    j = dict(common, config=dict(cfg, pallas=knob, pallas_resolved=resolved),
             pallas={"available": avail, "bytes_per_check": fused,
                     "bytes_saved_per_check": saved, "degraded": 0})
    p = dict(common, config=dict(cfg, kernels=knob, kernels_resolved=resolved),
             kernels={"available": avail, "bytes_per_check": fused,
                      "bytes_saved_per_check": saved})
    targets = (
        TuneTarget(engine=EngineConfig(latency_tiers=tuple(tiers),
                                       flat_packed=cfg["flat_packed_resolved"],
                                       kernels=knob, lsm_compact_min=cm),
                   serve=ServeConfig(hold_max_s=cfg["hold_max_s"], dedup=cfg["dedup"]),
                   cache_bytes=mx, placement=cfg["placement"]),
        JTuner.TuneTarget(engine=JConfig(latency_tiers=tuple(tiers),
                                         flat_packed=cfg["flat_packed_resolved"],
                                         pallas=knob, lsm_compact_min=cm),
                          serve=JServeConfig(hold_max_s=cfg["hold_max_s"],
                                             dedup=cfg["dedup"]),
                          cache_bytes=mx, placement=cfg["placement"]),
    )
    return j, p, targets, int(rng.integers(1, 12)) << 30


def _same_diff(pd, jd):
    assert len(pd.knobs) == len(jd.knobs), (pd.render(), jd.render())
    for pk, jk in zip(pd.knobs, jd.knobs):
        assert pk.knob == ("kernels" if jk.knob == "pallas" else jk.knob)
        assert (pk.layer, pk.current, pk.proposed, dict(pk.predicted)) == (
            jk.layer, jk.current, jk.proposed, dict(jk.predicted))
        assert pk.evidence == _port_words(jk.evidence)


def _same_target(pt, jt):
    """Field by field over the tunable surface (the two packages'
    EngineConfig defaults differ elsewhere by design, e.g. the aligned
    layout is auto on a TPU and off in the port)."""
    for name in ("latency_tiers", "flat_packed", "lsm_compact_min"):
        assert getattr(pt.engine, name) == getattr(jt.engine, name), name
    assert pt.engine.kernels == jt.engine.pallas
    for f in fields(JServeConfig):
        assert getattr(pt.serve, f.name) == getattr(jt.serve, f.name), f.name
    assert (pt.cache_bytes, pt.placement) == (jt.cache_bytes, jt.placement)


@pytest.mark.parametrize("seed", range(50))
def test_propose_and_apply_match_reference_on_seeded_snapshots(seed):
    j, p, (pt, jt), budget = _seeded_snapshot(seed)
    for kw in ({"hbm_budget_bytes": budget}, {"hbm_budget_bytes": 4 << 30}):
        jd = JTuner.propose(j, jt, **kw)
        pd = propose(p, pt, **kw)
        _same_diff(pd, jd)
        _same_target(apply_diff(pt, pd), JTuner.apply_diff(jt, jd))
        _same_diff(propose(p, None, **kw), JTuner.propose(j, None, **kw))
        assert TuneDiff.from_json(pd.to_json()) == pd
        assert pd.to_json() == _port_words(jd.to_json()).replace(
            '"knob": "pallas"', '"knob": "kernels"')


def test_controller_trajectory_matches_reference():
    """The same counter windows, tick by tick, move both controllers'
    knobs identically (the port's controller is the reference's)."""
    jm, pm = jmetrics.Metrics(), metrics.Metrics()
    jb, pb = FakeBatcher(JServeConfig), FakeBatcher()
    jv, pv = FakeVcache(32 << 20), FakeVcache(32 << 20)
    jc = JT.OnlineController(jb, vcache=jv, registry=jm, cooldown_steps=1)
    pc = OnlineController(pb, vcache=pv, registry=pm, cooldown_steps=1)
    rng = np.random.default_rng(17)
    for _ in range(30):
        ev = rng.integers(0, 12, 6)
        fill = float(rng.integers(1, 1024))
        for m in (jm, pm):
            m.inc("serve.flush_deadline", int(ev[0]))
            m.inc("serve.flush_maxhold", int(ev[1]))
            m.inc("serve.flush_full", int(ev[2]))
            m.inc("cache.hits", int(ev[3]) * 10)
            m.inc("cache.misses", int(ev[4]) * 10)
            m.inc("serve.checks", 100)
            m.inc("serve.unique_checks", 100 - int(ev[5]) // 6)
            m.set_gauge("cache.bytes", float(int(ev[5]) << 20))
            for _ in range(4):
                m.observe_hist("serve.occupancy.t1024", fill,
                               (64, 128, 256, 512, 1024))
        assert pc.step() == jc.step()
        assert pb.config.hold_max_s == jb.config.hold_max_s
        assert pb.config.dedup == jb.config.dedup
        assert pv.max_bytes == jv.max_bytes
    assert pc.status() == jc.status()


def _rbac_both(**cfg):
    jcs, jsnap, users, repos, slot = _rbac(j_compile, j_parse, JInterner(), j_build)
    pcs, psnap, pusers, _pr, pslot = _rbac(p_compile, p_parse, PInterner(), p_build)
    assert np.array_equal(users, pusers) and slot == pslot
    je = JEngine(jcs, JConfig.for_schema(jcs, pallas=False, **cfg))
    pe = DeviceEngine(pcs, EngineConfig(**cfg), device="cpu")
    return je, je.prepare(jsnap), pe, pe.prepare(psnap), users, repos, slot


def test_placement_split_matches_reference():
    je, jd, pe, pd, *_ = _rbac_both()
    want = j_placement_split(jd)
    got = placement_split(pd)
    assert got == want and got["sharded"] > 0 and got["replicated"] > 0
    assert got["total"] == sum(v.nbytes for v in pd.arrays.values())


@pytest.mark.parametrize("aligned", [False, True])
def test_tuned_ladder_planes_match_reference_latency_path(aligned):
    """The tuned ladder on ``cpu``: each tier's planes equal the
    reference latency path's with ``pallas=False``, and the port's own
    check_columns; each (permissions, tier) pins once."""
    cfg = {"latency_tiers": TUNED_TIERS}
    if aligned:
        cfg["flat_aligned"] = True
    je, jd, pe, pd, users, repos, slot = _rbac_both(**cfg)
    jlp, plp = je.latency_path(jd), pe.latency_path(pd)
    for B, tier in ((1, 192), (150, 192), (192, 192), (193, 576), (576, 576),
                    (900, 1344), (1344, 1344)):
        q = _queries(users, repos, slot, B, seed=B)
        got = plp.dispatch_columns(*q, now_us=EPOCH)
        assert plp.last_budget.tier == tier
        want = jlp.dispatch_columns(*q, now_us=EPOCH)
        assert _same(got, want), B
        assert _same(got, pe.check_columns(pd, *q, now_us=EPOCH)), B
    assert plp.dispatch_columns(*_queries(users, repos, slot, 1345, 3),
                                now_us=EPOCH) is None
    assert sorted({k[1] for k in plp.pins()}) == list(TUNED_TIERS)
    assert plp.compile_count == plp.pin_count == len(plp.pins())
