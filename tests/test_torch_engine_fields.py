"""Two engine-level details the port takes from the reference.

``snapshot.device_bytes``: every prepare, full or delta, publishes the
resident footprint as one total gauge and a per-table breakdown
(``DeviceEngine.record_device_bytes``, as the reference's), the breakdown
summing to the total even after a delta prepare that drops tables, and
the flight recorder's bundle head carries the total.

The aligned layout's ``EngineConfig.flat_aligned_max_bytes`` and
``flat_aligned_cover``: the reference's defaults, and a non-default
ladder builds the reference's tables bit for bit.  Byte counts and table
contents are ints: the tolerance is equality.
"""

import dataclasses
import json

import numpy as np
import pytest

from gochugaru_tpu import rel as jrel
from gochugaru_tpu.engine.device import DeviceEngine as JEngine
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.delta import apply_delta as j_apply
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.snapshot import build_snapshot_from_columns as j_build

from gochugaru_tpu_torch import rel
from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.delta import apply_delta as p_apply
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from gochugaru_tpu_torch.utils import metrics, trace

from test_torch_latency_cuda import _rbac

PREFIX = "snapshot.device_bytes."


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    trace.disable()
    trace.install_recorder(None)


def _per_table():
    _c, gauges, _t = metrics.default.typed_snapshot()
    return {k[len(PREFIX):]: v for k, v in gauges.items() if k.startswith(PREFIX)}


def _check_gauges(ds):
    total = metrics.default.gauge("snapshot.device_bytes")
    per = _per_table()
    assert set(per) == set(ds.arrays)
    assert per == {k: float(v.nbytes) for k, v in ds.arrays.items()}
    assert sum(per.values()) == total == sum(v.nbytes for v in ds.arrays.values())
    return total


def test_full_prepare_publishes_device_bytes():
    cs, snap, *_ = _rbac(p_compile, p_parse, PInterner(), p_build)
    pe = DeviceEngine(cs, device="cpu")
    ds = pe.prepare(snap)
    assert _check_gauges(ds) > 0


def test_delta_prepare_that_drops_tables_keeps_the_breakdown_summing():
    """A delta adds an edge (the dl_* overlay tables of adds); the next
    deletes it again, so the accumulated delta holds no add and its
    prepare drops the add overlays: no stale per-table gauge survives,
    and the breakdown sums to the new total."""
    cs, snap, *_ = _rbac(p_compile, p_parse, PInterner(), p_build)
    pe = DeviceEngine(cs, device="cpu")
    ds = pe.prepare(snap)
    edge = rel.must_from_triple("repo:r0", "reader", "user:u1")
    snap2 = p_apply(snap, 2, [edge], [], interner=snap.interner)
    ds2 = pe.prepare(snap2, prev=ds)
    assert ds2.flat_meta.delta is not None
    t2 = _check_gauges(ds2)
    dl = {k for k in ds2.arrays if k.startswith("dl_")}
    assert dl and dl <= set(_per_table())
    snap3 = p_apply(snap2, 3, [], [edge], interner=snap.interner)
    ds3 = pe.prepare(snap3, prev=ds2)
    assert ds2.flat_meta.delta.has_adds and not ds3.flat_meta.delta.has_adds
    dropped = set(ds2.arrays) - set(ds3.arrays)
    assert dropped and dropped <= dl
    t3 = _check_gauges(ds3)
    assert not dropped & set(_per_table())
    assert t3 != t2


def test_incident_bundle_head_carries_device_bytes():
    cs, snap, *_ = _rbac(p_compile, p_parse, PInterner(), p_build)
    ds = DeviceEngine(cs, device="cpu").prepare(snap)
    total = sum(v.nbytes for v in ds.arrays.values())
    trace.configure(sample_rate=0.0)
    rec = trace.install_recorder(trace.FlightRecorder(grace_s=0.0, cooldown_s=0.0))
    iid = trace.trigger_incident("breaker.trip", consecutive=1)
    rec.flush()
    head = json.loads(rec.bundle(iid).splitlines()[0])
    assert head["kind"] == "incident"
    assert head["device_bytes"] == total


def test_aligned_fields_default_to_the_reference():
    p, j = EngineConfig(), JConfig()
    assert p.flat_aligned_max_bytes == j.flat_aligned_max_bytes == 3 << 30
    assert p.flat_aligned_cover == tuple(j.flat_aligned_cover) == (0.999,)


def _both(**cfg):
    jcs, jsnap, *_ = _rbac(j_compile, j_parse, JInterner(), j_build)
    pcs, psnap, *_ = _rbac(p_compile, p_parse, PInterner(), p_build)
    jd = JEngine(jcs, JConfig(pallas=False, spmm=False, **cfg)).prepare(jsnap)
    arrays, meta = DeviceEngine(pcs, EngineConfig(**cfg), device="cpu").prepare_host(psnap)
    return {k: np.asarray(v) for k, v in jd.arrays.items()}, jd.flat_meta, arrays, meta


@pytest.mark.parametrize("cover", [(0.5, 0.9), (0.3, 0.6, 0.9)])
def test_non_default_cover_builds_the_reference_ladder(cover):
    """``flat_aligned_cover`` reaches the full prepare's build_aligned:
    the ladder has its spill levels (the default has none on this
    world) and every table equals the reference's, key for key and bit
    for bit.  (Three levels on the docs world:
    tests/test_torch_aligned.py::test_three_level_ladder_reaches_the_planes.)"""
    want, jmeta, got, meta = _both(flat_aligned=True, flat_aligned_cover=cover)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert dataclasses.asdict(meta) == {
        k: v for k, v in dataclasses.asdict(jmeta).items()
        if k in dataclasses.asdict(meta)}
    assert max(len(caps) for _t, _w, caps in meta.aligned) >= 2
    _w, _m, base, base_meta = _both(flat_aligned=True)
    assert max(len(caps) for _t, _w, caps in base_meta.aligned) == 1


def test_aligned_byte_budget_keeps_tables_off_interleave_like_the_reference():
    want, jmeta, got, meta = _both(flat_aligned=True, flat_aligned_max_bytes=1)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    assert meta.aligned == tuple(jmeta.aligned)
    assert "ehx" in got and "ehx" not in {t for t, _w, _c in meta.aligned}


def test_delta_reship_reads_the_cover_field():
    """The delta path's build_aligned (closure-derived point tables)
    rebuilds with the engine's cover: on a world whose closure table has
    a two-level ladder under the cover (one level under the default), a
    team-membership delta re-ships that table and stays a delta prepare,
    keeps the base's geometry, its tables and meta equal the reference's
    delta prepare with the same cover, key for key and bit for bit, and
    its planes equal a full prepare's of the same revision."""
    cover, world = (0.5, 0.9), dict(n_users=100, n_teams=30)
    jcs, jsnap, *_ = _rbac(j_compile, j_parse, JInterner(), j_build, **world)
    je = JEngine(jcs, JConfig(pallas=False, spmm=False, flat_aligned=True,
                              flat_aligned_cover=cover))
    jsnap2 = j_apply(jsnap, 2, [jrel.must_from_triple("team:t0", "member", "user:u9")],
                     [], interner=jsnap.interner)
    jd2 = je.prepare(jsnap2, prev=je.prepare(jsnap))
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build,
                                         **world)
    cfg = EngineConfig(flat_aligned=True, flat_aligned_cover=cover)
    pe = DeviceEngine(cs, cfg, device="cpu")
    ds = pe.prepare(snap)
    snap2 = p_apply(snap, 2, [rel.must_from_triple("team:t0", "member", "user:u9")],
                    [], interner=snap.interner)
    ds2 = pe.prepare(snap2, prev=ds)
    assert ds2.flat_meta.delta is not None and jd2.flat_meta.delta is not None
    assert ds2.flat_meta.aligned == ds.flat_meta.aligned
    assert dict((t, c) for t, _w, c in ds2.flat_meta.aligned)["clx"] == (4, 2)
    assert ds2.arrays["clx_al"] is not ds.arrays["clx_al"] and "clx_als" in ds2.arrays
    want = {k: np.asarray(v) for k, v in jd2.arrays.items()}
    assert set(ds2.arrays) == set(want)
    for k, v in want.items():
        # uint16 lanes are int16 tensors in the port: compare their bits
        got = ds2.arrays[k].numpy()
        if v.dtype == np.uint16:
            got = got.view(np.uint16)
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    meta = dataclasses.asdict(ds2.flat_meta)
    assert meta == {k: v for k, v in dataclasses.asdict(jd2.flat_meta).items()
                    if k in meta}
    full = DeviceEngine(cs, cfg, device="cpu").prepare(snap2)
    from test_torch_latency_cuda import EPOCH, _queries

    q = _queries(users, repos, slot, 300, seed=4)
    a = pe.check_columns(ds2, *q, now_us=EPOCH)
    b = pe.check_columns(full, *q, now_us=EPOCH)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
