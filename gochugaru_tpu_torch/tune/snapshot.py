"""Telemetry snapshot: everything the tuner reads, in one JSON blob.

A snapshot is a pure data capture -- no proposals, no judgment -- of the
serving telemetry a measurement window produced, stamped with the
config it was measured under.  Stamping the config into the snapshot is
what makes the tuner's fixed-point property structural: ``propose`` is
a pure function of the snapshot (plus constants), so applying its diff
and re-proposing against the SAME snapshot can only converge.

Sections (all JSON-serializable; absent sections simply disable the
rules that read them):

- ``config``   -- the knob values the window ran under
- ``occupancy``-- per-tier live-lane histograms (``serve.occupancy.t*``)
- ``flush``    -- formed-batch flush-reason counts
- ``serve``    -- check/unique/shed/batch counters
- ``queue_wait``-- submit->form wait quantiles
- ``cache``    -- verdict-cache stats (engine/vcache.py ``stats()``)
- ``pad``      -- pinned-tier pad-waste ledger (utils/perf.py)
- ``cost``     -- per-tier expected dispatch cost (utils/admission.py)
- ``bytes``    -- gathered-bytes model, device-table placement split and,
  on ``cuda``, the placement rule's budget: the card's free memory at
  snapshot time (the allocator's unused cache included) plus the
  tables' own bytes
- ``kernels``  -- fused-probe kernel evidence: whether the kernels can
  launch here, and the one-pass byte-model gauges prepare publishes
  (utils/perf.py ``publish_kernel_model``).  There is no degrade
  counter: ``EngineConfig(kernels=True)`` raises where the kernels
  cannot run instead of falling back to the plain versions
- ``wall``     -- last closed wall-ledger window's bucket fractions
- ``chain``    -- write-path delta-chain depth (store/group.py gauges:
  overlay rows, chain length in revisions, background compactions,
  batched closure advances) -- the lsm_compact_min rule's evidence
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..engine import kernels as _K
from ..utils import metrics as _metrics
from ..utils import perf as _perf

#: snapshot format version (bumped on breaking shape changes)
SNAPSHOT_VERSION = 1

#: the flush reasons serve/batcher.py counts (drain excluded from rule
#: denominators -- it is lifecycle, not workload)
FLUSH_REASONS = ("full", "maxhold", "deadline", "drain")


def kernels_resolved(config, device=None) -> bool:
    """The engine's kernel switch (engine/device.py ``_resolve_kernels``)
    read without raising: None is on exactly when the device is
    ``cuda`` (no device named: when CUDA is there, as an engine built
    without one); True and False are themselves."""
    if config.kernels is None:
        if device is None:
            return torch.cuda.is_available()
        return torch.device(device).type == "cuda"
    return bool(config.kernels)


def _occupancy_of(registry: _metrics.Metrics) -> Dict[str, Dict[str, Any]]:
    """``serve.occupancy.t{tier}`` histograms -> {tier: {buckets, counts,
    count, sum}} -- the per-tier live-lane distributions the ladder rule
    reads (exemplars dropped: they are trace pointers, not data)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, (buckets, counts, count, total, _ex) in (
        registry.hist_snapshot().items()
    ):
        if not name.startswith("serve.occupancy.t"):
            continue
        tier = name[len("serve.occupancy.t"):]
        out[tier] = {
            "buckets": [float(b) for b in buckets],
            "counts": [int(c) for c in counts],
            "count": int(count),
            "sum": float(total),
        }
    return out


def collect_snapshot(
    registry: Optional[_metrics.Metrics] = None,
    *,
    engine_config=None,
    serve_config=None,
    vcache=None,
    cost=None,
    dsnap=None,
    placement: str = "replicated",
    packed_candidates: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Capture one tuner input from live telemetry.

    ``engine_config``/``serve_config``/``vcache`` stamp the measured-
    under config; any left None stamps that knob as unknown and the
    rules needing it stay silent.  ``dsnap`` (a prepared
    DeviceSnapshot) enables the bytes/placement section and, on
    ``cuda``, records the placement budget (free device memory now
    plus the tables' resident bytes);
    ``packed_candidates`` ({"packed": bytes/check, "unpacked": ...}
    from an offline A/B prepare) enables the pack-spec rule -- a live
    snapshot can only see the layout it runs, so the counterfactual is
    collected offline or not at all.  ``kernels=None`` resolves against
    ``dsnap``'s device (without one: ``cuda`` when there is one)."""
    m = registry or _metrics.default
    snap: Dict[str, Any] = {"version": SNAPSHOT_VERSION}
    dev = dsnap.tid_map.device if dsnap is not None else None

    cfg: Dict[str, Any] = {"placement": placement}
    if engine_config is not None:
        cfg["latency_tiers"] = [int(t) for t in engine_config.latency_tiers]
        cfg["flat_packed"] = engine_config.flat_packed
        cfg["flat_packed_resolved"] = bool(engine_config.packed_on())
        cfg["kernels"] = engine_config.kernels
        cfg["kernels_resolved"] = kernels_resolved(engine_config, dev)
        cfg["lsm_compact_min"] = int(engine_config.lsm_compact_min)
    if serve_config is not None:
        cfg["hold_max_s"] = float(serve_config.hold_max_s)
        cfg["dedup"] = bool(serve_config.dedup)
    if vcache is not None:
        cfg["cache_max_bytes"] = int(vcache.max_bytes)
    snap["config"] = cfg

    snap["occupancy"] = _occupancy_of(m)
    snap["flush"] = {
        r: int(m.counter(f"serve.flush_{r}")) for r in FLUSH_REASONS
    }
    snap["serve"] = {
        "checks": int(m.counter("serve.checks")),
        "unique_checks": int(m.counter("serve.unique_checks")),
        "submissions": int(m.counter("serve.submissions")),
        "batches": int(m.counter("serve.batches")),
        "sheds": int(m.counter("serve.sheds")),
        "dedup_parked": int(m.counter("serve.dedup_parked")),
    }
    qw: Dict[str, Any] = {"count": m.timer_counts("serve.queue_wait_s")[0]}
    for q, key in ((0.5, "p50_s"), (0.99, "p99_s")):
        v = m.percentile("serve.queue_wait_s", q)
        if v is not None:
            qw[key] = round(float(v), 6)
    snap["queue_wait"] = qw

    if vcache is not None:
        c = dict(vcache.stats())
        c["evicted_revisions"] = int(m.counter("cache.evicted_revisions"))
        snap["cache"] = c

    snap["pad"] = _perf.pad_stats(m)
    snap["kernels"] = {
        "available": bool(_K.available()),
        "bytes_per_check": float(m.gauge("perf.kernels.bytes_per_check")),
        "bytes_saved_per_check": float(
            m.gauge("perf.kernels.bytes_saved_per_check")
        ),
    }
    if cost is not None:
        snap["cost"] = cost.state()

    by: Dict[str, Any] = {}
    model = _perf.last_model()
    if dsnap is not None:
        try:
            model = _perf.gathered_bytes_model(dsnap)
        except Exception:
            pass
        from ..engine.flat import placement_split

        by.update(placement_split(dsnap))
        if dev.type == "cuda" and "total" in by:
            # what the tables may grow to: the card's free memory now, the
            # blocks this process's allocator caches unused, and what the
            # tables hold already; what other tenants of the card (another
            # engine, another replica) hold counts against it
            free, _total = torch.cuda.mem_get_info(dev)
            cached = (torch.cuda.memory_reserved(dev)
                      - torch.cuda.memory_allocated(dev))
            by["device_budget"] = int(free) + int(cached) + int(by["total"])
    if model is not None:
        by["per_check"] = round(float(model.total), 2)
    if packed_candidates:
        by["candidates"] = {
            k: round(float(v), 2) for k, v in packed_candidates.items()
        }
    if by:
        snap["bytes"] = by

    wall = _perf.last_wall()
    if wall is not None:
        snap["wall"] = dict(wall.get("fracs") or {})

    # write-path chain depth: only present once the compactor (or a
    # write) has published anything -- an all-zero section would make
    # the lsm_compact_min rule read "no chain" as evidence
    chain = {
        "overlay_rows": float(m.gauge("store.lsm_overlay_rows")),
        "chain_len": float(m.gauge("store.lsm_chain_len")),
        "bg_compactions": int(m.counter("store.bg_compactions")),
        "batch_applies": int(m.counter("closure.batch_applies")),
        "groups": int(m.counter("write.groups")),
    }
    if any(chain.values()):
        snap["chain"] = chain
    return snap
