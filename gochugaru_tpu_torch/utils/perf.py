"""Performance attribution: where the bytes and microseconds go.

The observability stack answers "why was THIS check slow" (utils/trace.py)
and "what was happening when the breaker tripped" (the flight recorder);
this module answers the third question — "where do the bytes and the
wall time go" — with three legs:

1. **Device cost ledger.**  Every program the engine runs registers an
   entry: each latency-mode pin at capture time (``record_cost``), the
   batch-path flat program and the lookup frontier's probe steps as a
   LAZY thunk (``register_cost_thunk``) realized only when a consumer
   asks (``/perf?compile=1``, ``cost_entries(realize=True)``).  An eager
   torch program or a captured CUDA graph has no cost analysis, so
   every entry takes the reference's decline path: it carries the
   program's identity (kind, key, slots, batch, table-meta hash) with
   ``unavailable: true`` and bumps ``perf.cost_analysis_unavailable``,
   and the meta model below is the bytes figure.

   Alongside it the ledger keeps the EXACT meta-driven gathered-bytes
   model (``gathered_bytes_model``): per-level, per-table device bytes
   gathered per check from the FlatMeta geometry and the device
   tensors' widths and element sizes.  ``kernel_bytes_model`` states
   what the CUDA probe kernels change in it.  Pad-waste accounting
   (``record_pad``: live vs padded lanes per pinned-tier dispatch)
   completes it: wasted lanes are gathered bytes too.

2. **Roofline meter.**  ``measure_bandwidth`` runs a one-shot triad
   (out = x + 0.5·y over float32 arrays far larger than the L2 cache:
   2 streams read, 1 written) on the engine's device and caches the
   measured GB/s per backend fingerprint (torch + CUDA version + device
   name + device count).  achieved GB/s = bytes/check × measured
   checks/s; ``roofline_frac`` = achieved / measured ceiling
   (``roofline_columns``).  ``python -m gochugaru_tpu_torch.utils.perf``
   prints the measurement.

3. **Closed wall-time ledger** (``WallLedger``): per measurement window,
   every instant of wall time in exactly one named bucket, from the SAME
   perf_counter stamps the latency path's stage timers publish.

Everything publishes three ways: ``perf.*`` gauges/counters on the
metrics registry, attrs on the dispatch spans, and a flight-recorder
context provider (``context_state``) so incident bundles carry the cost
state at the moment of the anomaly.  ``render_report`` backs the
``/perf`` telemetry endpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import metrics as _metrics

# ---------------------------------------------------------------------------
# device cost ledger
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
#: realized cost entries: (kind, key) -> {kind, key, captured_unix_s, ...}
_COST: "Dict[Tuple[str, str], Dict[str, Any]]" = {}
#: lazy capture thunks: (kind, key) -> () -> identity fields (realized on
#: demand)
_COST_THUNKS: "Dict[Tuple[str, str], Callable[[], Dict[str, Any]]]" = {}
#: bound on ledger entries: a qctx-shape-churning process must not grow
#: the ledger without end (FIFO, same discipline as the pin caches)
COST_LEDGER_MAX = 256


def record_cost(
    kind: str, key: str, registry: Optional[_metrics.Metrics] = None,
    **extra,
) -> Dict[str, Any]:
    """Register one program in the ledger.  An eager torch program or a
    CUDA graph has no cost analysis, so the entry takes the reference's
    decline path: ``unavailable: true`` beside the program's identity
    (``extra``), and the ``perf.cost_analysis_unavailable`` gauge counts
    it (the meta model stays the bytes figure)."""
    m = registry or _metrics.default
    entry: Dict[str, Any] = {
        "kind": kind, "key": key, "captured_unix_s": round(time.time(), 3),
        **extra, "unavailable": True,
    }
    m.inc("perf.cost.captures")
    m.inc("perf.cost_analysis_unavailable_total")
    with _LOCK:
        m.set_gauge(
            "perf.cost_analysis_unavailable",
            m.gauge("perf.cost_analysis_unavailable", 0.0) + 1.0,
        )
        while len(_COST) >= COST_LEDGER_MAX:
            _COST.pop(next(iter(_COST)))
        _COST[(kind, key)] = entry
    return entry


def cost_registered(kind: str, key: str) -> bool:
    """Whether (kind, key) already has an entry or a pending thunk —
    hot paths guard their (per-call) thunk construction on this."""
    with _LOCK:
        return (kind, key) in _COST or (kind, key) in _COST_THUNKS


def register_cost_thunk(
    kind: str, key: str, thunk: Callable[[], Dict[str, Any]]
) -> None:
    """Register a lazy capture: ``thunk()`` returns the program's
    identity fields.  Realized only by ``cost_entries(realize=True)`` —
    never on a serving path."""
    with _LOCK:
        if (kind, key) in _COST or (kind, key) in _COST_THUNKS:
            return
        while len(_COST_THUNKS) >= COST_LEDGER_MAX:
            _COST_THUNKS.pop(next(iter(_COST_THUNKS)))
        _COST_THUNKS[(kind, key)] = thunk


def cost_entries(
    realize: bool = False, registry: Optional[_metrics.Metrics] = None
) -> List[Dict[str, Any]]:
    """The ledger's entries.  ``realize=True`` runs pending thunks first
    (the /perf endpoint only on ``?compile=1``); each realizes through
    ``record_cost``'s decline path, and a thunk that raises records its
    error instead."""
    if realize:
        with _LOCK:
            pending = list(_COST_THUNKS.items())
            _COST_THUNKS.clear()
        for (kind, key), thunk in pending:
            try:
                fields = thunk()
            except Exception as e:
                record_cost(kind, key, registry,
                            error=f"{type(e).__name__}: {e}"[:200])
                continue
            record_cost(kind, key, registry, **fields)
    with _LOCK:
        return [dict(v) for v in _COST.values()] + [
            {"kind": k, "key": key, "pending": True}
            for (k, key) in _COST_THUNKS
        ]


def shapes_of(args) -> Any:
    """Nested args -> the same nesting with each tensor replaced by
    ``[shape, dtype]``: what a lazy cost thunk closes over instead of
    the tensors (holding them would pin multi-GB snapshots to the
    ledger).  Non-tensor leaves pass through."""
    if isinstance(args, dict):
        return {k: shapes_of(v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return [shapes_of(v) for v in args]
    if hasattr(args, "shape") and hasattr(args, "dtype"):
        return [list(args.shape), str(args.dtype)]
    return args


def reset_cost_ledger() -> None:
    """Test hygiene: drop every entry and pending thunk."""
    with _LOCK:
        _COST.clear()
        _COST_THUNKS.clear()


# ---------------------------------------------------------------------------
# gathered-bytes model: the exact meta-driven roofline numerator
# ---------------------------------------------------------------------------

def _itemsize(a) -> int:
    """Bytes of one element of a device tensor."""
    return int(a.element_size())


@dataclass(frozen=True)
class BytesModel:
    """HBM bytes gathered per check, decomposed.

    ``per_table`` charges each device array; ``per_level`` splits the
    total by recursion level — level 0 is the root dispatch (the old
    ``est_bytes_per_check`` scope), level 1+ are the flattened
    rc-closure probes and the arrow unroll the old model excluded.
    ``total == sum(per_level) == sum(per_table.values())``."""

    per_table: Dict[str, float]
    per_level: Tuple[float, ...]
    total: float


def table_bytes(dsnap) -> int:
    """Resident device-table bytes of a DeviceSnapshot (the arrays
    actually shipped; HBM-lean snapshots keep raw columns host-side and
    those are correctly NOT counted — they never reach the device)."""
    return sum(v.numel() * v.element_size() for v in dsnap.arrays.values())


def gathered_bytes_model(dsnap) -> BytesModel:
    """Static estimate of HBM bytes GATHERED per check, per table and
    per recursion level, from the FlatMeta geometry and the ACTUAL
    device array widths/dtypes (so packed and unpacked layouts are
    compared by what truly crosses HBM).

    Level 0 mirrors the root dispatch sites: bucket-offset reads +
    candidate blocks at the e/T/KU/fold probes, wildcard doubling
    included.  Deeper levels close the old model's documented gap:

    - each flattened rc hierarchy (``meta.rc_slots``) adds ONE ancestor
      range probe + fan rows at level 1, then the rest-expression's
      leaf tests at the fan ancestors at level 2;
    - snapshots whose arrows did NOT fold into rc closure unroll to the
      measured ``meta.ar_data_depth``: each level probes the arrow
      range-group view and re-runs the leaf sites at a frontier widened
      by the per-slot arrow fanout (pow2-bucketed, exactly the lattice
      the kernel compiles).
    """
    meta = dsnap.flat_meta
    if meta is None:
        return BytesModel({}, (0.0,), 0.0)
    arrs = dsnap.arrays
    per_table: Dict[str, float] = {}

    def charge(key: str, nbytes: float) -> float:
        if nbytes:
            per_table[key] = per_table.get(key, 0.0) + float(nbytes)
        return float(nbytes)

    def row(k: str) -> int:
        """Bytes of one table row (packed lanes or int32 cols)."""
        a = arrs.get(k)
        if a is None:
            return 0
        return int(a.shape[-1]) * _itemsize(a)

    def off(k: str) -> int:
        """One bucket-offset read (+ the int32 anchor when packed)."""
        a = arrs.get(k)
        if a is None:
            return 0
        return _itemsize(a) + (
            4 if (k + "_a") in arrs else 0
        )

    wc = 2 if meta.has_wc_edges else 1
    wcc = 2 if meta.has_wc_closure else 1

    def e_block(width: float) -> float:
        """The direct-edge probe at ``width`` lattice nodes."""
        if not meta.e_slots:
            return 0.0
        al = arrs.get("ehx_al")
        if al is not None:
            b = int(al.shape[1]) * _itemsize(al)
            # width-stratum ladder: one row gather per level
            extra = sum(
                int(arrs[k].shape[1]) * _itemsize(arrs[k])
                for k in arrs
                if k.startswith("ehx_als")
            )
            return charge("ehx_al", wc * width * (b + extra))
        return charge("eh_off", wc * width * off("eh_off")) + charge(
            "ehx", wc * width * meta.e_cap * row("ehx")
        )

    def t_block(width: float) -> float:
        if not meta.has_tindex:
            return 0.0
        return charge("th_off", wcc * width * off("th_off")) + charge(
            "tx", wcc * width * meta.t_cap * row("tx")
        )

    def cl_block(width: float) -> float:
        """One closure-containment probe (per userset candidate)."""
        if not meta.has_closure:
            return 0.0
        return charge("clh_off", wcc * width * off("clh_off")) + charge(
            "clx", wcc * width * meta.cl_cap * row("clx")
        )

    def ku_block(width: float, fan: int) -> float:
        """The userset (KU) expansion: range probe + fan candidate rows,
        each candidate tested against the closure."""
        if fan <= 0:
            return 0.0
        return (
            charge("usr_off", width * off("usr_off"))
            + charge("usgx", width * meta.usr_cap * row("usgx"))
            + charge("usx", width * fan * row("usx"))
            + cl_block(width * fan)
        )

    def fold_block(width: float) -> float:
        if not meta.fold_pairs:
            return 0.0
        total = 0.0
        if meta.pf_has_e:
            total += charge("pfh_off", wc * width * off("pfh_off"))
            total += charge("pfx", wc * width * meta.pf_e_cap * row("pfx"))
        if meta.pf_has_u:
            if meta.pf_direct:
                total += charge("pfu_start", width * 2 * off("pfu_start"))
                total += charge(
                    "pfu_gk", width * meta.pf_u_fan * row("pfu_gk")
                )
                if not meta.pf_u_alllive:
                    total += charge(
                        "pfu_u", width * meta.pf_u_fan * row("pfu_u")
                    )
            else:
                total += charge("pfu_off", width * off("pfu_off"))
                total += charge(
                    "pfugx", width * meta.pf_u_cap * row("pfugx")
                )
                total += charge("pfux", width * meta.pf_u_fan * row("pfux"))
            # subject-side closure slice: once per dispatch, not per node
            if meta.pf_s_direct:
                total += charge("csr_start", 2 * off("csr_start"))
                total += charge("csr_gk", meta.pf_s_fan * row("csr_gk"))
                if not meta.pf_s_alllive:
                    total += charge("csr_d", meta.pf_s_fan * row("csr_d"))
                    total += charge("csr_p", meta.pf_s_fan * row("csr_p"))
            else:
                total += charge("csr_off", off("csr_off"))
                total += charge("csrgx", meta.pf_s_cap * row("csrgx"))
                total += charge("csrx", meta.pf_s_fan * row("csrx"))
        return total

    us_fan = max((f for _s, f in meta.us_fanout_by_slot), default=0)

    def leaf_sites(width: float) -> float:
        """The full leaf test battery at ``width`` lattice nodes: the
        direct edge probe, then the T fast path where it covers, else
        the KU expansion."""
        total = e_block(width)
        if meta.has_tindex:
            total += t_block(width)
            if meta.has_ovf and us_fan:
                # T incomplete for overflowed sources: the usr range
                # probe still runs to flag `used`
                total += charge("usr_off", width * off("usr_off"))
                total += charge("usgx", width * meta.usr_cap * row("usgx"))
        elif us_fan:
            total += ku_block(width, us_fan)
        return total

    levels: List[float] = []
    # ---- level 0: the root dispatch --------------------------------------
    levels.append(leaf_sites(1.0) + fold_block(1.0))

    # ---- level 1+: flattened rc hierarchies ------------------------------
    l1 = 0.0
    l2 = 0.0
    for ts_slot, cap, fan in meta.rc_slots:
        gx, x, o = f"rc{ts_slot}gx", f"rc{ts_slot}x", f"rc{ts_slot}_off"
        l1 += charge(o, off(o)) + charge(gx, cap * row(gx))
        l1 += charge(x, fan * row(x))
        # the rest expression evaluates at the fan ancestors
        l2 += leaf_sites(float(fan))
    if l1:
        levels.append(l1)
    if l2:
        levels.append(l2)

    # ---- level 1+: the arrow unroll (hierarchies NOT folded into rc) -----
    ar_fans = dict(meta.ar_fanout_by_slot)
    unrolled = {s for s in ar_fans if s not in {t for t, _, _ in meta.rc_slots}}
    depth = max(int(getattr(meta, "ar_data_depth", -1)), 0)
    if unrolled and depth > 0:
        fan = max(ar_fans[s] for s in unrolled)
        width = 1.0
        for lvl in range(1, depth + 1):
            a = (
                charge("arr_off", width * off("arr_off"))
                + charge("argx", width * meta.arr_cap * row("argx"))
                + charge("arx", width * fan * row("arx"))
            )
            width *= fan
            a += leaf_sites(width)
            if len(levels) <= lvl:
                levels.append(a)
            else:
                levels[lvl] += a
    total = float(sum(levels))
    return BytesModel(per_table, tuple(levels), total)


def est_bytes_per_check(dsnap) -> float:
    """The gathered-bytes model's total — the roofline numerator next
    to checks/s."""
    return gathered_bytes_model(dsnap).total


#: the last published model and the device of its snapshot (per-process;
#: the /perf endpoint, the flight-recorder context and the bandwidth
#: meter's default device read them)
_LAST_MODEL: "List[Tuple[float, BytesModel]]" = []
_LAST_DEVICE: "List[Any]" = []


def publish_model(
    dsnap, registry: Optional[_metrics.Metrics] = None
) -> Optional[BytesModel]:
    """Compute + publish the snapshot's gathered-bytes model as
    ``perf.bytes_per_check`` (+ per-level gauges).  Called at prepare;
    never fails the prepare (a geometry the model can't read publishes
    nothing)."""
    try:
        model = gathered_bytes_model(dsnap)
    except Exception:
        return None
    m = registry or _metrics.default
    m.clear_gauges("perf.bytes_per_check")
    m.set_gauge("perf.bytes_per_check", model.total)
    for i, v in enumerate(model.per_level):
        m.set_gauge(f"perf.bytes_per_check.level{i}", v)
    dev = next((v.device for v in dsnap.arrays.values()), None)
    with _LOCK:
        _LAST_MODEL.clear()
        _LAST_MODEL.append((time.time(), model))
        if dev is not None:
            _LAST_DEVICE.clear()
            _LAST_DEVICE.append(dev)
    return model


def last_model() -> Optional[BytesModel]:
    with _LOCK:
        return _LAST_MODEL[0][1] if _LAST_MODEL else None


# ---------------------------------------------------------------------------
# the CUDA probe kernels' bytes model (engine/kernels, csrc/)
# ---------------------------------------------------------------------------

#: block tables the fused probe kernels serve (the ``psite`` sites of
#: engine/flat.py).  Tables outside this set (emission rows, csr slices,
#: delta overlays, probed by the plain ``probe_block``) keep identical
#: charges and show saved == 0
_KERNEL_BLOCK_TBLS = frozenset(
    {"ehx", "ehx_al", "tx", "clx", "pusx", "ovfx", "pfx", "usgx", "argx"}
)


def kernel_bytes_model(dsnap) -> Dict[str, Dict[str, float]]:
    """Per-table bytes per check of the plain twins against the CUDA
    kernels: ``{table: {"plain": b, "kernels": b', "saved": b - b'}}``.

    The model, stated so the tests can assert its structure (the device
    time of each kernel is chip_smoke.py's measurement, not this one):

    - the plain chain charges the gathered source bytes
      (:func:`gathered_bytes_model`) PLUS one write + read of the decoded
      int32 block per probed block table — the gathered block the plain
      twin materializes between the gather and its compare/gate
      consumers (packed tables inflate it by the int32-width/packed-lane
      ratio);
    - the kernels charge the raw block bytes ONCE: they decode in
      registers and shared memory;
    - bucket offsets and anchors keep their charge on both sides: the
      port keeps no table resident on chip, so the kernels read them
      from device memory as the plain twin does;
    - tables the kernels do not serve keep identical charges.
    """
    base = gathered_bytes_model(dsnap)
    meta = dsnap.flat_meta
    arrs = dsnap.arrays
    pk = dict(meta.packed) if meta is not None else {}
    rc_gx = {f"rc{ts}gx" for ts, _c, _f in getattr(meta, "rc_slots", ())}
    out: Dict[str, Dict[str, float]] = {}
    for t, b in base.per_table.items():
        a = arrs.get(t)
        if t not in (_KERNEL_BLOCK_TBLS | rc_gx) or a is None:
            out[t] = {"plain": b, "kernels": b, "saved": 0.0}
            continue
        spec = pk.get(t[:-3] if t.endswith("_al") else t)
        if spec is not None:
            factor = (4.0 * int(spec[0])) / float(spec[1] * _itemsize(a))
        else:
            factor = 1.0
        inter = 2.0 * b * factor  # decoded block: one write + read
        out[t] = {"plain": b + inter, "kernels": b, "saved": inter}
    return out


def publish_kernel_model(
    dsnap, registry: Optional[_metrics.Metrics] = None
) -> Optional[Dict[str, Dict[str, float]]]:
    """Publish the kernels' bytes delta next to the base model:
    ``perf.kernels.bytes_per_check`` / ``.bytes_saved_per_check`` totals
    + per-table ``perf.kernels.saved.<table>`` gauges.  Called at
    prepare when ``EngineConfig.kernels`` resolves on; never fails the
    prepare."""
    try:
        model = kernel_bytes_model(dsnap)
    except Exception:
        return None
    m = registry or _metrics.default
    m.clear_gauges("perf.kernels.")
    m.set_gauge(
        "perf.kernels.bytes_per_check",
        sum(v["kernels"] for v in model.values()),
    )
    m.set_gauge(
        "perf.kernels.bytes_saved_per_check",
        sum(v["saved"] for v in model.values()),
    )
    for t, v in model.items():
        if v["saved"]:
            m.set_gauge(f"perf.kernels.saved.{t}", v["saved"])
    return model


# ---------------------------------------------------------------------------
# pad-waste accounting (live vs padded lanes per pinned-tier dispatch)
# ---------------------------------------------------------------------------

#: tiers record_pad has seen — lets pad_stats read the per-tier
#: counters by NAME instead of snapshotting the whole registry (a
#: snapshot copies+sorts every timer ring; pad_stats runs inside the
#: "cheap by contract" incident context provider and per /perf scrape)
_PAD_TIERS: "set" = set()


def record_pad(
    tier: int, live: int, registry: Optional[_metrics.Metrics] = None
) -> None:
    """One pinned-tier dispatch padded ``live`` queries to ``tier``
    lanes.  Fed from the latency path per dispatch."""
    m = registry or _metrics.default
    m.inc("perf.pad.live_lanes", live)
    m.inc("perf.pad.total_lanes", tier)
    m.inc(f"perf.pad.live_lanes.t{tier}", live)
    m.inc(f"perf.pad.total_lanes.t{tier}", tier)
    if tier not in _PAD_TIERS:
        with _LOCK:
            _PAD_TIERS.add(int(tier))


def pad_stats(registry: Optional[_metrics.Metrics] = None) -> Dict[str, Any]:
    """{live_lanes, total_lanes, pad_fraction, per_tier} cumulative —
    ``pad_fraction`` is the share of dispatched lanes that carried
    padding, the roofline's wasted-bytes column (lower is better).
    Reads only the pad counters by name — never a full registry
    snapshot."""
    m = registry or _metrics.default
    live = m.counter("perf.pad.live_lanes")
    total = m.counter("perf.pad.total_lanes")
    with _LOCK:
        tiers = sorted(_PAD_TIERS)
    per_tier: Dict[str, Dict[str, float]] = {}
    for t in tiers:
        tt = m.counter(f"perf.pad.total_lanes.t{t}")
        if not tt:
            continue
        lt = m.counter(f"perf.pad.live_lanes.t{t}")
        per_tier[str(t)] = {
            "live": lt, "total": tt,
            "pad_fraction": round(1.0 - lt / tt, 4),
        }
    return {
        "live_lanes": live,
        "total_lanes": total,
        "pad_fraction": round(1.0 - live / total, 4) if total else 0.0,
        "per_tier": per_tier,
    }



# ---------------------------------------------------------------------------
# roofline meter: measured memory-bandwidth denominator
# ---------------------------------------------------------------------------

#: on-disk bandwidth cache, keyed by backend fingerprint: a re-run of the
#: microbench tells nothing new about the same card.  The port's own
#: file, so the reference package's cache is never overwritten
ROOFLINE_CACHE_PATH = os.environ.get(
    "GOCHUGARU_TORCH_ROOFLINE_CACHE_PATH",
    os.path.join(tempfile.gettempdir(), "gochugaru_torch_roofline.json"),
)

#: the last fingerprint computed in THIS process — lets a plain /perf
#: scrape key its cache read without touching the device (computing a
#: fingerprint initializes CUDA, which a scrape must never pay)
_LAST_FP: "List[str]" = []


def _meter_device(device=None):
    """The device the meter runs on: the one given, else the device of
    the last prepared snapshot (``publish_model``), else ``cuda``."""
    import torch

    if device is None:
        with _LOCK:
            device = _LAST_DEVICE[0] if _LAST_DEVICE else "cuda"
    return torch.device(device)


def backend_fingerprint(device=None) -> str:
    """torch version + CUDA version + device name + device count: the
    cache key under which one bandwidth measurement stands for a
    machine.  Initializes CUDA on a ``cuda`` device — callers on scrape
    paths use the remembered in-process value instead (``_LAST_FP``)."""
    import torch

    dev = _meter_device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        n = torch.cuda.device_count()
    else:
        kind, n = dev.type, 1
    fp = (f"torch={torch.__version__};cuda={torch.version.cuda}"
          f";device={dev.type};kind={kind};n={n}")
    with _LOCK:
        _LAST_FP.clear()
        _LAST_FP.append(fp)
    return fp


def _bandwidth_cache_read(fp: str) -> Optional[Dict[str, Any]]:
    if os.environ.get("GOCHUGARU_ROOFLINE_CACHE", "1") == "0":
        return None
    try:
        with open(ROOFLINE_CACHE_PATH) as f:
            blob = json.load(f)
        if blob.get("fingerprint") != fp:
            return None
        # the blob persists with cached=False (it was fresh when
        # written); anything served FROM the cache must say so
        return {**blob, "cached": True}
    except (OSError, ValueError):
        return None


def _bandwidth_cache_write(blob: Dict[str, Any]) -> None:
    if os.environ.get("GOCHUGARU_ROOFLINE_CACHE", "1") == "0":
        return
    try:
        tmp = ROOFLINE_CACHE_PATH + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, ROOFLINE_CACHE_PATH)
    except OSError:
        pass  # best-effort; next run re-measures


def measure_bandwidth(
    refresh: bool = False,
    size_mb: float = 64.0,
    reps: int = 7,
    registry: Optional[_metrics.Metrics] = None,
    device=None,
) -> Dict[str, Any]:
    """The roofline denominator: measured device memory bandwidth via a
    triad (out = x + 0.5·y, one ``torch.add(..., alpha=0.5, out=)``
    kernel over float32 arrays of ``size_mb`` each, larger than the
    card's L2 — 2 streams read, 1 written, 12 B/element), best of
    ``reps``, cached per backend fingerprint.  On a ``cuda`` device each
    rep is timed by CUDA events and ends in ``torch.cuda.synchronize``;
    on the CPU by the host clock.

    Returns {gbps, bytes_moved, best_s, reps, fingerprint, platform,
    device, cached}; publishes ``perf.roofline_gbps``."""
    import torch

    m = registry or _metrics.default
    dev = _meter_device(device)
    fp = backend_fingerprint(dev)
    if not refresh:
        cached = _bandwidth_cache_read(fp)
        if cached is not None and cached.get("gbps"):
            m.set_gauge("perf.roofline_gbps", cached["gbps"])
            return cached
    n = max(int(size_mb * 1e6 / 4), 1 << 16)
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = x * 0.25
    out = torch.empty_like(x)
    torch.add(x, y, alpha=0.5, out=out)  # warm-up
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(max(reps, 1)):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            torch.add(x, y, alpha=0.5, out=out)
            e1.record()
            torch.cuda.synchronize(dev)
            dt = e0.elapsed_time(e1) / 1e3
        else:
            t0 = time.perf_counter()
            torch.add(x, y, alpha=0.5, out=out)
            dt = time.perf_counter() - t0
        best = min(best, dt)
    bytes_moved = 3 * n * 4  # 2 read + 1 written
    gbps = bytes_moved / best / 1e9
    blob = {
        "gbps": round(gbps, 2),
        "bytes_moved": bytes_moved,
        "best_s": round(best, 9),
        "reps": int(reps),
        "fingerprint": fp,
        "platform": "gpu" if cuda else dev.type,
        "device": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "measured_unix_s": round(time.time(), 3),
        "cached": False,
    }
    _bandwidth_cache_write(blob)
    m.set_gauge("perf.roofline_gbps", blob["gbps"])
    return blob


def roofline_columns(
    rate: float,
    dsnap=None,
    bytes_per_check: Optional[float] = None,
    registry: Optional[_metrics.Metrics] = None,
) -> Dict[str, float]:
    """The bench columns: achieved GB/s = bytes/check × checks/s against
    the MEASURED bandwidth ceiling.  Works from a DeviceSnapshot (model
    computed here) or a precomputed bytes_per_check.

    ``bytes_accessed_per_check`` is the ACTIVE path's modeled traffic:
    when the prepare that produced ``dsnap`` resolved the CUDA kernels
    on, :func:`publish_kernel_model` left the kernels' per-check bytes
    in the ``perf.kernels.bytes_per_check`` gauge and the row carries
    that (plus the delta in ``kernels_bytes_saved_per_check``);
    otherwise it equals the gather model's ``bytes_per_check`` and the
    delta column is absent."""
    if bytes_per_check is None:
        bytes_per_check = est_bytes_per_check(dsnap) if dsnap is not None else 0.0
    bw = measure_bandwidth(registry=registry)
    m = registry or _metrics.default
    fused = m.gauge("perf.kernels.bytes_per_check")
    saved = m.gauge("perf.kernels.bytes_saved_per_check")
    eff = fused if fused > 0 else float(bytes_per_check)
    achieved = eff * max(rate, 0.0) / 1e9
    ceiling = float(bw.get("gbps") or 0.0)
    m.set_gauge("perf.achieved_gbps", achieved)
    out = {
        "bytes_per_check": round(float(bytes_per_check), 1),
        "bytes_accessed_per_check": round(eff, 1),
        "achieved_gbps": round(achieved, 3),
        "roofline_gbps": round(ceiling, 2),
        "roofline_frac": round(achieved / ceiling, 4) if ceiling else 0.0,
    }
    if fused > 0:
        out["kernels_bytes_saved_per_check"] = round(saved, 1)
    return out


# ---------------------------------------------------------------------------
# closed wall-time ledger
# ---------------------------------------------------------------------------

#: attribution priority, highest first: an instant covered by several
#: reported intervals belongs to the FIRST listed bucket that covers it
#: (the device stages own their windows; host-side bookkeeping fills
#: around them; waiting only counts where nothing is running)
WALL_BUCKETS = (
    "kernel", "h2d", "d2h", "host_prep", "filter", "form", "queue_wait",
    "backoff",
)
_BUCKET_INDEX = {b: i for i, b in enumerate(WALL_BUCKETS)}

#: bound on reported intervals per window (a runaway window degrades to
#: a counted drop, never unbounded memory)
WALL_INTERVAL_MAX = 400_000

#: the armed window (one per process; benches own the lifecycle).  A
#: PLAIN reference assigned/cleared atomically — reporters on other
#: threads read it once, so a concurrent stop() can never race a
#: check-then-index (the reporter either sees the window or None)
_WALL: "Optional[WallLedger]" = None
#: the last CLOSED window's result (the /perf endpoint serves it);
#: same single-reference discipline
_LAST_WALL: "Optional[Dict[str, Any]]" = None


def report_wall(bucket: str, t0: float, t1: float) -> None:
    """Report one (bucket, start, end) interval on the perf_counter
    timeline.  A single reference-read + None-check when no window is
    armed — safe on the latency path's per-dispatch budget."""
    w = _WALL
    if w is not None:
        w._report(bucket, t0, t1)


def report_wall_stages(t0: float, t1: float, t2: float, t3: float, t4: float) -> None:
    """The latency path's four stage intervals from the SAME t0..t4
    stamps the DispatchBudget subtracts — ledger and budget agree
    exactly."""
    w = _WALL
    if w is not None:
        w._report("host_prep", t0, t1)
        w._report("h2d", t1, t2)
        w._report("kernel", t2, t3)
        w._report("d2h", t3, t4)


class WallLedger:
    """One measurement window's wall-time attribution.

    ``start()`` arms the process-global report hook; ``stop()`` disarms
    it and sweeps the reported intervals into per-bucket seconds by the
    fixed priority order — every instant of [start, stop] lands in
    exactly one bucket (uncovered time is ``idle``), so the buckets sum
    to the window length BY CONSTRUCTION (``closure_frac`` states it).
    Because idle is a residual, closure alone cannot catch LOST
    intervals — the accounting's real teeth are ``dropped == 0`` plus
    the named buckets the consumer expects being nonzero
    (``named_frac``); the tests assert those too."""

    def __init__(self, registry: Optional[_metrics.Metrics] = None) -> None:
        self._m = registry or _metrics.default
        self._lock = threading.Lock()
        self._intervals: List[Tuple[int, float, float]] = []
        self.dropped = 0
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.result: Optional[Dict[str, Any]] = None

    def _report(self, bucket: str, t0: float, t1: float) -> None:
        bi = _BUCKET_INDEX.get(bucket)
        if bi is None or t1 <= t0:
            return
        with self._lock:
            if len(self._intervals) >= WALL_INTERVAL_MAX:
                self.dropped += 1
                return
            self._intervals.append((bi, t0, t1))

    def start(self) -> "WallLedger":
        global _WALL
        self.t_start = time.perf_counter()
        _WALL = self
        return self

    def stop(self) -> Dict[str, Any]:
        global _WALL, _LAST_WALL
        if _WALL is self:
            _WALL = None
        self.t_stop = time.perf_counter()
        with self._lock:
            intervals = list(self._intervals)
        self.result = _attribute_wall(
            intervals, self.t_start, self.t_stop, self.dropped
        )
        _publish_wall(self.result, self._m)
        _LAST_WALL = self.result
        return self.result


def _attribute_wall(
    intervals: List[Tuple[int, float, float]],
    t0: float,
    t1: float,
    dropped: int = 0,
) -> Dict[str, Any]:
    """Priority sweep: at every instant the highest-priority bucket with
    an active interval owns the time; no active bucket → idle."""
    W = max(t1 - t0, 1e-12)
    sec = {b: 0.0 for b in WALL_BUCKETS}
    events: List[Tuple[float, int, int]] = []
    for bi, s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            events.append((s, 1, bi))
            events.append((e, -1, bi))
    events.sort(key=lambda ev: ev[0])
    active = [0] * len(WALL_BUCKETS)
    prev = t0
    for t, d, bi in events:
        if t > prev:
            own = next((i for i, c in enumerate(active) if c > 0), None)
            if own is not None:
                sec[WALL_BUCKETS[own]] += t - prev
            prev = t
        active[bi] += d
    named = sum(sec.values())
    idle = max(W - named, 0.0)
    # closure from the UNROUNDED sums: rounding bucket seconds to a µs
    # quantum first would make a sub-100µs window's closure read
    # percent-level noise (a flaky test, not a property)
    closure = (named + idle) / W
    sec["idle"] = idle
    fracs = {b: round(v / W, 4) for b, v in sec.items()}
    return {
        "window_s": round(W, 6),
        "seconds": {b: round(v, 6) for b, v in sec.items()},
        "fracs": fracs,
        "closure_frac": round(closure, 4),
        "named_frac": round(named / W, 4),
        "intervals": len(intervals),
        "dropped": int(dropped),
    }


def _publish_wall(result: Dict[str, Any], m: _metrics.Metrics) -> None:
    m.clear_gauges("perf.wall.")
    m.set_gauge("perf.wall.window_s", result["window_s"])
    m.set_gauge("perf.wall.closure_frac", result["closure_frac"])
    for b, v in result["seconds"].items():
        m.set_gauge(f"perf.wall.{b}_s", v)
        m.set_gauge(f"perf.wall.{b}_frac", result["fracs"][b])


def last_wall() -> Optional[Dict[str, Any]]:
    return _LAST_WALL


# ---------------------------------------------------------------------------
# export surface: /perf report + flight-recorder context
# ---------------------------------------------------------------------------

def render_report(
    registry: Optional[_metrics.Metrics] = None,
    realize: bool = False,
    bench: bool = False,
) -> Dict[str, Any]:
    """The ``/perf`` payload: the whole ledger as one JSON document.
    ``realize`` runs pending cost thunks (explicit opt-in); ``bench``
    runs the bandwidth microbench when no cached verdict exists
    (otherwise the cached one is served)."""
    m = registry or _metrics.default
    model = last_model()
    with _LOCK:
        fp = _LAST_FP[0] if _LAST_FP else None
    bw = None
    try:
        # a plain scrape must never initialize CUDA: without ?bench=1
        # the fingerprint only keys a cache read, so it uses the value
        # some in-process measurement already computed — a process that
        # never measured serves roofline: null until the operator
        # explicitly asks with ?bench=1
        if bench:
            bw = measure_bandwidth(registry=m)
            fp = bw.get("fingerprint", fp)
        elif fp is not None:
            bw = _bandwidth_cache_read(fp)
    except Exception:
        pass
    return {
        "cost": cost_entries(realize=realize, registry=m),
        "cost_analysis_unavailable": m.gauge(
            "perf.cost_analysis_unavailable", 0.0
        ),
        "bytes_model": None if model is None else {
            "total": round(model.total, 1),
            "per_level": [round(v, 1) for v in model.per_level],
            "per_table": {
                k: round(v, 1) for k, v in sorted(model.per_table.items())
            },
        },
        "pad": pad_stats(m),
        "roofline": bw,
        "fingerprint": fp,
        "wall": last_wall(),
        **{
            k: _safe_section(fn) for k, fn in sorted(_EXTRA_REPORT.items())
        },
    }


#: extra /perf report sections registered by other subsystems (the
#: verdict cache registers its stats here — engine/vcache.py — and the
#: group committer its ``write_path``).  Cheap-by-contract, same rule as
#: context providers
_EXTRA_REPORT: Dict[str, Any] = {}


def register_report_section(name: str, fn) -> None:
    """Attach a callable whose result rides /perf under ``name``
    (last registration per name wins)."""
    _EXTRA_REPORT[name] = fn


def _safe_section(fn):
    try:
        return fn()
    except Exception as e:  # a broken section must not break the scrape
        return {"error": repr(e)}


def context_state() -> Dict[str, Any]:
    """Flight-recorder context provider: the cost state an incident
    bundle carries.  Cheap by contract — realized entries only, cached
    bandwidth only, no microbench."""
    m = _metrics.default
    model = last_model()
    entries = cost_entries(realize=False)
    return {
        "bytes_per_check": None if model is None else round(model.total, 1),
        "bytes_per_level": None if model is None else [
            round(v, 1) for v in model.per_level
        ],
        "pad": pad_stats(m),
        "cost_entries": len(entries),
        "cost_pending": sum(1 for e in entries if e.get("pending")),
        "cost_analysis_unavailable": m.gauge(
            "perf.cost_analysis_unavailable", 0.0
        ),
        "roofline_gbps": m.gauge("perf.roofline_gbps", 0.0) or None,
        "wall": last_wall(),
    }


def _main(argv=None) -> int:
    """``python -m gochugaru_tpu_torch.utils.perf``: run (or read) the
    bandwidth microbench and print the roofline JSON."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--refresh", action="store_true",
                    help="re-measure even with a cached verdict")
    ap.add_argument("--size-mb", type=float, default=64.0)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure (default: cuda)")
    args = ap.parse_args(argv)
    bw = measure_bandwidth(
        refresh=args.refresh, size_mb=args.size_mb, reps=args.reps,
        device=args.device,
    )
    print(json.dumps({**bw, "cache_path": ROOFLINE_CACHE_PATH}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
