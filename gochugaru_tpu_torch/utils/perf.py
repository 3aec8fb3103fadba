"""Performance attribution: the ledger functions of the latency path.

The part of the reference package's ``utils/perf.py`` that the latency
path (engine/latency.py) and the client call; its roofline meter, its
backend fingerprint and its report CLI are not part of the port yet.
Three legs:

1. **Device cost ledger.**  Each latency-mode pin registers an entry
   (``record_cost``).  The reference records XLA's ``cost_analysis`` of
   the compiled executable there; a captured CUDA graph has no such
   analysis, so the port's entry carries the pin's identity only (kind,
   key, tier, slots) and the meta model below is the bytes figure.
2. **Gathered-bytes model** (``gathered_bytes_model``): per-level,
   per-table device bytes gathered per check, from the FlatMeta geometry
   and the device tensors' widths and element sizes.  Pad-waste
   accounting (``record_pad``: live vs padded lanes per pinned-tier
   dispatch) completes it: wasted lanes are gathered bytes too.
3. **Closed wall-time ledger** (``WallLedger``): per measurement window,
   every instant of wall time in exactly one named bucket, from the SAME
   perf_counter stamps the latency path's stage timers publish.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as _metrics

# ---------------------------------------------------------------------------
# device cost ledger
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
#: cost entries: (kind, key) -> {kind, key, captured_unix_s, ...}
_COST: "Dict[Tuple[str, str], Dict[str, Any]]" = {}
#: bound on ledger entries: a qctx-shape-churning process must not grow
#: the ledger without end (FIFO, same discipline as the pin caches)
COST_LEDGER_MAX = 256


def record_cost(
    kind: str, key: str, registry: Optional[_metrics.Metrics] = None,
    **extra,
) -> Dict[str, Any]:
    """Register one pinned program in the ledger.  A CUDA graph has no
    cost analysis, so the entry holds its identity and ``extra`` (the
    reference's XLA flops / bytes fields are absent)."""
    m = registry or _metrics.default
    entry: Dict[str, Any] = {
        "kind": kind, "key": key, "captured_unix_s": round(time.time(), 3),
        **extra,
    }
    m.inc("perf.cost.captures")
    with _LOCK:
        while len(_COST) >= COST_LEDGER_MAX:
            _COST.pop(next(iter(_COST)))
        _COST[(kind, key)] = entry
    return entry


def cost_entries() -> List[Dict[str, Any]]:
    """The ledger's entries, oldest first."""
    with _LOCK:
        return [dict(v) for v in _COST.values()]


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

