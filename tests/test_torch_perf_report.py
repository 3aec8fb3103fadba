"""The rest of the port's ``utils/perf.py`` against the reference's: the
gathered-bytes model published at prepare, the CUDA kernels' bytes model
beside the reference's Pallas model, the lazy cost entries of the batch
program and the lookup frontier, the ``/perf`` report and the flight
recorder's context (same keys), the bandwidth meter with its cache, and
the module's CLI.

The same seeded world (tests/test_torch_latency_cuda.py) is prepared by
both packages: the reference by ``DeviceEngine`` with ``pallas=False``
(JAX on the CPU, as its own tests run it), the port on ``cpu``.  Byte
figures are float sums of integer products: the tolerance is exact
equality.  No number here is a device measurement: the meter runs on the
CPU and says so."""

import json

import pytest

from gochugaru_tpu.engine.device import DeviceEngine as JEngine
from gochugaru_tpu.engine.plan import EngineConfig as JConfig
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.snapshot import build_snapshot_from_columns as j_build
from gochugaru_tpu.utils import metrics as jmetrics
from gochugaru_tpu.utils import perf as jperf

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import new_evaluator
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from gochugaru_tpu_torch.utils import metrics as pmetrics
from gochugaru_tpu_torch.utils import perf as pperf
from gochugaru_tpu_torch.utils.context import background as p_background
from test_torch_latency_cuda import EPOCH, _queries, _rbac


def _worlds(aligned):
    """(reference dsnap, port dsnap, port engine, users, repos, slot)."""
    jcs, jsnap, users, repos, slot = _rbac(j_compile, j_parse, JInterner(), j_build)
    pcs, psnap, *_ = _rbac(p_compile, p_parse, PInterner(), p_build)
    je = JEngine(jcs, JConfig.for_schema(jcs, pallas=False, flat_aligned=aligned))
    pe = PEngine(pcs, config=PConfig.for_schema(pcs, flat_aligned=aligned),
                 device="cpu")
    return je.prepare(jsnap), pe.prepare(psnap), pe, users, repos, slot


@pytest.fixture(scope="module", params=[False, True], ids=["off", "aligned"])
def worlds(request):
    return _worlds(request.param)


def test_publish_model_equals_the_reference(worlds):
    """The gauges ``publish_model`` leaves, and ``last_model``, equal the
    reference's on the same snapshot."""
    jds, pds, *_ = worlds
    jm, pm = jmetrics.Metrics(), pmetrics.Metrics()
    want = jperf.publish_model(jds, registry=jm)
    got = pperf.publish_model(pds, registry=pm)
    assert (got.per_table, got.per_level, got.total) == (
        want.per_table, want.per_level, want.total)
    assert pperf.last_model() is got
    assert pm.typed_snapshot()[1] == jm.typed_snapshot()[1]
    assert pm.gauge("perf.bytes_per_check") == got.total > 0


def test_kernel_model_against_the_reference_pallas_model(worlds, tmp_path,
                                                         monkeypatch):
    """Table by table: the plain figures are the reference's ``xla``
    ones; the kernels save the decoded blocks of the block tables they
    probe (the reference's ``saved`` there) and nothing on the offsets,
    which the port keeps in device memory (no residency plan)."""
    jds, pds, *_ = worlds
    want = jperf.pallas_bytes_model(jds)
    got = pperf.kernel_bytes_model(pds)
    assert sorted(got) == sorted(want)
    blocks = pperf._KERNEL_BLOCK_TBLS | {
        f"rc{ts}gx" for ts, _c, _f in pds.flat_meta.rc_slots}
    saved_any = False
    for t, row in got.items():
        assert row["plain"] == want[t]["xla"], t
        assert row["plain"] - row["kernels"] == row["saved"], t
        if t in blocks:
            assert row["saved"] == want[t]["saved"], t
            saved_any |= row["saved"] > 0
        else:
            assert row["saved"] == 0.0, t
    assert saved_any
    m = pmetrics.Metrics()
    pperf.publish_kernel_model(pds, registry=m)
    monkeypatch.setattr(pperf, "ROOFLINE_CACHE_PATH", str(tmp_path / "bw.json"))
    assert m.gauge("perf.kernels.bytes_per_check") == sum(
        r["kernels"] for r in got.values())
    assert m.gauge("perf.kernels.bytes_saved_per_check") == sum(
        r["saved"] for r in got.values())
    cols = pperf.roofline_columns(0.0, bytes_per_check=1.0, registry=m)
    assert cols["bytes_accessed_per_check"] == round(
        m.gauge("perf.kernels.bytes_per_check"), 1)
    assert "kernels_bytes_saved_per_check" in cols


def test_batch_program_registers_a_lazy_entry(worlds):
    """A batch dispatch registers its program's entry lazily under the
    reference's key; realizing it takes the decline path (no cost
    analysis for an eager torch program) with the program's identity."""
    _jds, pds, pe, users, repos, slot = worlds
    pperf.reset_cost_ledger()
    m = pmetrics.Metrics()
    pe.check_columns(pds, *_queries(users, repos, slot, 64, seed=3), now_us=EPOCH)
    pend = [e for e in pperf.cost_entries() if e["kind"] == "batch"]
    assert len(pend) == 1 and pend[0]["pending"]
    slots = tuple(sorted({slot["read"], slot["admin"]}))
    assert pend[0]["key"].startswith(f"slots={slots};B=64;meta=")
    got = [e for e in pperf.cost_entries(realize=True, registry=m)
           if e["kind"] == "batch"]
    assert len(got) == 1 and got[0]["unavailable"] is True
    assert got[0]["slots"] == list(slots) and got[0]["B"] == 64
    assert got[0]["tables"] == {k: [list(v.shape), str(v.dtype)]
                                for k, v in pds.arrays.items()}
    assert m.gauge("perf.cost_analysis_unavailable") == 1.0
    # the next dispatch of the same shape registers nothing new
    pe.check_columns(pds, *_queries(users, repos, slot, 64, seed=4), now_us=EPOCH)
    assert [e["kind"] for e in pperf.cost_entries()] == ["batch"]
    pperf.reset_cost_ledger()


def test_lookup_frontier_registers_lazy_entries():
    """A lookup registers its program's lazy cost entry: the fused K-hop
    program (kind ``spmm``) by default, the looped frontier's probes
    (kind ``spmv``) with ``spmm=False``."""
    from gochugaru_tpu_torch.client import with_engine_config

    for spmm, kind in ((True, "spmm"), (False, "spmv")):
        pperf.reset_cost_ledger()
        c = new_evaluator(with_engine_config(PConfig(spmm=spmm)), device="cpu")
        ctx = p_background()
        c.write_schema(ctx, """
definition user {}
definition doc { relation reader: user  permission read = reader }
""")
        txn = prel.Txn()
        for i in range(12):
            txn.touch(prel.must_from_triple(f"doc:d{i}", "reader", f"user:u{i % 3}"))
        c.write(ctx, txn)
        assert sorted(c.lookup_resources(ctx, pcons.full(), "doc#read", "user:u1")) == [
            "d1", "d10", "d4", "d7"]
        ents = [e for e in pperf.cost_entries(realize=True) if e["kind"] == kind]
        assert ents and all(e["unavailable"] and e["F"] > 0 for e in ents), kind
    pperf.reset_cost_ledger()


def test_report_and_context_keys_equal_the_reference(worlds):
    jds, pds, *_ = worlds
    jperf.publish_model(jds, registry=jmetrics.Metrics())
    pperf.publish_model(pds, registry=pmetrics.Metrics())
    sect = {"probe": lambda: {"ok": 1}, "broken": lambda: 1 / 0}
    for name, fn in sect.items():
        jperf.register_report_section(name, fn)
        pperf.register_report_section(name, fn)
    try:
        got = pperf.render_report(pmetrics.Metrics())
        want = jperf.render_report(jmetrics.Metrics())
        extra = set(pperf._EXTRA_REPORT) | set(jperf._EXTRA_REPORT)
        assert set(got) - extra == set(want) - extra
        assert got["probe"] == want["probe"] == {"ok": 1}
        assert got["broken"]["error"] == want["broken"]["error"]
        assert got["bytes_model"] == want["bytes_model"]
        assert set(pperf.context_state()) == set(jperf.context_state())
    finally:
        for name in sect:
            jperf._EXTRA_REPORT.pop(name, None)
            pperf._EXTRA_REPORT.pop(name, None)


def test_bandwidth_meter_caches_per_fingerprint(tmp_path, monkeypatch):
    """On the CPU (explicitly): a fresh measurement, then the cached
    one; a scrape without ``bench`` reads the cache by the remembered
    fingerprint."""
    monkeypatch.setattr(pperf, "ROOFLINE_CACHE_PATH", str(tmp_path / "bw.json"))
    m = pmetrics.Metrics()
    a = pperf.measure_bandwidth(size_mb=1.0, reps=2, registry=m, device="cpu")
    assert a["cached"] is False and a["gbps"] > 0 and a["platform"] == "cpu"
    assert a["bytes_moved"] == 3 * 250_000 * 4
    assert "device=cpu" in a["fingerprint"]
    b = pperf.measure_bandwidth(size_mb=1.0, reps=2, registry=m, device="cpu")
    assert b["cached"] is True and b["gbps"] == a["gbps"]
    assert m.gauge("perf.roofline_gbps") == a["gbps"]
    assert json.loads((tmp_path / "bw.json").read_text())["cached"] is False
    assert pperf.render_report(m)["roofline"] == b
    c = pperf.measure_bandwidth(refresh=True, size_mb=1.0, reps=1, registry=m,
                                device="cpu")
    assert c["cached"] is False


def test_cli_prints_the_measurement(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(pperf, "ROOFLINE_CACHE_PATH", str(tmp_path / "bw.json"))
    assert pperf._main(["--device", "cpu", "--size-mb", "1", "--reps", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["platform"] == "cpu" and out["gbps"] > 0
    assert out["cache_path"] == str(tmp_path / "bw.json")
