"""The offline tune pass: snapshot in, reviewable config diff out.

Every rule here is DETERMINISTIC and EXPLAINABLE: a proposal is a pure
function of the snapshot (plus the constants below), and each emitted
``KnobDiff`` carries the measured evidence it was derived from plus the
predicted deltas a re-run under the tuned config can verify.  Purity
buys the fixed-point property the round-trip test asserts:
``propose(snap, apply_diff(t, propose(snap, t)))`` is empty, because a
desired value depends only on the snapshot, never on the target it is
being compared against.

Quantization keeps proposals reviewable and stable: tiers round up to
multiples of ``TIER_QUANTUM`` (non-pow2 is fine -- the latency path
captures one CUDA graph per plain int tier, engine/latency.py),
hold-back snaps to ``HOLD_LADDER``, cache budgets move in powers of two.

Rules and their inputs:

- ``latency_tiers``  ← per-tier occupancy histograms: a tier whose p90
  live-lane count sits at or below half the tier is paying pure pad
  waste; propose the p90 rounded up to the quantum.  The TOP tier never
  shrinks (it is the ladder's coverage guarantee).
- ``hold_max_s``     ← flush-reason mix + occupancy: maxhold-dominated
  flushes at low occupancy mean the hold only adds latency; at high
  occupancy more hold converts maxhold flushes into full ones.
- ``cache_max_bytes``← hit rate + byte pressure + shard evictions.
- ``dedup``          ← measured duplicate fraction, with an on/off
  hysteresis band so borderline workloads don't flap.
- ``flat_packed``    ← offline A/B byte models only (a live snapshot
  sees one layout; the counterfactual comes from an offline dual
  prepare, or the rule stays silent).
- ``kernels``        ← the fused-probe one-pass byte model prepare
  publishes (utils/perf.py ``publish_kernel_model``) against the plain
  versions' modeled traffic, vetoed where the kernels cannot launch --
  the rule never proposes a backend the engine cannot serve.
- ``placement``      ← device-table placement split (engine/flat.py
  ``placement_split``) against the device memory budget.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..engine.plan import EngineConfig
from ..serve.batcher import ServeConfig
from .snapshot import kernels_resolved

#: minimum histogram mass before the ladder rule trusts a tier's shape
MIN_HIST_SAMPLES = 16
#: minimum flushes before the hold rule reads the reason mix
MIN_FLUSHES = 8
#: minimum cache lookups / served checks before those rules speak
MIN_CACHE_LOOKUPS = 100
MIN_CHECKS = 200
#: proposed tiers round UP to this quantum (compile-count hygiene: a
#: quantum bounds distinct pinned shapes without forcing pow2 waste)
TIER_QUANTUM = 64
#: occupancy p90 at or below this fraction of the tier marks pad waste
TIER_SHRINK_AT = 0.5
#: the shrunk tier is sized at p90 × this headroom: one coalescing
#: burst (two typical submissions landing inside the hold window) must
#: still fit, or the burst spills past the shrunk rung into the next
#: pinned tier and its dispatch cost shows up as a p99 cliff
TIER_HEADROOM = 2.0
#: the hold-back knob's quantized ladder (seconds)
HOLD_LADDER = (0.00025, 0.0005, 0.001, 0.002, 0.004, 0.008)
#: cache budget clamp (bytes); moves are ×2 / ÷2
CACHE_MIN_BYTES = 8 << 20
CACHE_MAX_BYTES = 256 << 20
#: dedup hysteresis watermarks on the measured duplicate fraction
DEDUP_ON_FRAC = 0.05
DEDUP_OFF_FRAC = 0.005
#: pack-layout A/B margin: the cheaper layout must win by this much
PACKED_MARGIN = 0.10
#: fused-probe margin: the modeled one-pass saving must be at least
#: this fraction of the plain versions' bytes/check before the backend
#: switch is worth proposing
KERNELS_MARGIN = 0.10
#: the placement rule's device memory budget for a snapshot that names
#: no device (one prepared on ``cuda`` carries its own,
#: ``bytes.device_budget``: the card's free memory when it was taken
#: plus the tables' resident bytes)
NO_DEVICE_BUDGET_BYTES = 4 << 30
#: chain-depth rule: clamp for the host LSM materialization floor
#: (EngineConfig.lsm_compact_min) and the evidence watermarks it moves
#: on — raise only after this many background merges in one window,
#: lower only when a merge-free window left a chain this deep relative
#: to the floor
LSM_COMPACT_FLOOR = 4_096
LSM_COMPACT_CEIL = 1 << 20
MIN_BG_COMPACTIONS = 4
CHAIN_DEEP_FRAC = 0.75
#: routing must shard at least this share of the bytes to be worth
#: partitioning (membership-dominated snapshots replicate everywhere)
PLACEMENT_MIN_SHARD_FRAC = 0.25


@dataclass(frozen=True)
class KnobDiff:
    """One reviewable knob change: what, from, to, WHY (measured), and
    what the tuner predicts the change buys."""

    knob: str
    layer: str  # "engine" | "serve" | "cache" | "deploy"
    current: Any
    proposed: Any
    evidence: str
    predicted: Mapping[str, float] = field(default_factory=dict)

    def to_obj(self) -> Dict[str, Any]:
        cur = self.current
        prop = self.proposed
        return {
            "knob": self.knob, "layer": self.layer,
            "current": list(cur) if isinstance(cur, tuple) else cur,
            "proposed": list(prop) if isinstance(prop, tuple) else prop,
            "evidence": self.evidence,
            "predicted": dict(self.predicted),
        }


@dataclass(frozen=True)
class TuneDiff:
    """The emitted proposal set — JSON round-trippable, so a diff can
    be reviewed, stored, and applied in a different process."""

    knobs: Tuple[KnobDiff, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.knobs)

    def get(self, knob: str) -> Optional[KnobDiff]:
        for k in self.knobs:
            if k.knob == knob:
                return k
        return None

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(
            {"version": 1, "knobs": [k.to_obj() for k in self.knobs]},
            indent=indent,
        )

    @staticmethod
    def from_json(blob: str) -> "TuneDiff":
        doc = json.loads(blob)
        knobs = []
        for k in doc.get("knobs", ()):
            cur, prop = k["current"], k["proposed"]
            if k["knob"] == "latency_tiers":
                cur = tuple(int(t) for t in cur)
                prop = tuple(int(t) for t in prop)
            knobs.append(KnobDiff(
                knob=k["knob"], layer=k["layer"], current=cur,
                proposed=prop, evidence=k.get("evidence", ""),
                predicted=dict(k.get("predicted", {})),
            ))
        return TuneDiff(tuple(knobs))

    def render(self) -> str:
        """Human-readable review table."""
        if not self.knobs:
            return "tune: no changes proposed — config matches workload"
        lines = []
        for k in self.knobs:
            pred = ", ".join(
                f"{n} {v:+g}" for n, v in sorted(k.predicted.items())
            )
            lines.append(
                f"[{k.layer}] {k.knob}: {k.current!r} -> {k.proposed!r}"
                + (f"  (predicted: {pred})" if pred else "")
            )
            lines.append(f"    {k.evidence}")
        return "\n".join(lines)


@dataclass(frozen=True)
class TuneTarget:
    """The full tunable surface as one value.  EngineConfig and
    ServeConfig carry their own knobs; cache budget and placement are
    deploy-level choices with no config field (the cache budget is a
    VerdictCache constructor arg, placement a deployment's layout), so
    they ride alongside."""

    engine: EngineConfig
    serve: ServeConfig
    cache_bytes: Optional[int] = None
    placement: str = "replicated"


# ---------------------------------------------------------------------------
# snapshot readers
# ---------------------------------------------------------------------------

def hist_quantile(h: Mapping[str, Any], q: float) -> float:
    """Bucket-upper at the q-th cumulative count of a snapshot
    histogram ({buckets, counts, count, sum}).  Overflow (+Inf) mass
    reports as the last finite upper — the per-tier occupancy hists top
    out at the tier itself, so overflow cannot occur there by
    construction."""
    count = int(h.get("count") or 0)
    if count <= 0:
        return 0.0
    target = q * count
    cum = 0
    uppers = list(h["buckets"])
    for u, c in zip(uppers, h["counts"]):
        cum += int(c)
        if cum >= target:
            return float(u)
    return float(uppers[-1]) if uppers else 0.0


def _occ_fill_frac(snap: Mapping[str, Any]) -> Optional[float]:
    """COUNT-weighted mean fill fraction across the per-tier occupancy
    hists: the typical formed batch's live/tier ratio — None without
    data.  Count-weighted (each batch votes once), not lane-weighted: a
    mixed workload's few big-tier batches would otherwise drown the many
    near-empty small-tier ones the hold decision is actually about."""
    fill = 0.0
    n_total = 0
    for tier, h in (snap.get("occupancy") or {}).items():
        n = int(h.get("count") or 0)
        if n:
            fill += float(h["sum"]) / float(int(tier))
            n_total += n
    return (fill / n_total) if n_total else None


def _ladder_step(ladder: Tuple[float, ...], v: float, up: bool) -> float:
    """Nearest quantized step above/below ``v`` — ``v`` itself when
    already at the ladder's edge."""
    if up:
        above = [x for x in ladder if x > v * 1.0001]
        return min(above) if above else v
    below = [x for x in ladder if x < v * 0.9999]
    return max(below) if below else v


# ---------------------------------------------------------------------------
# per-knob rules: snapshot -> Optional[(desired, evidence, predicted)]
# ---------------------------------------------------------------------------

def _rule_tiers(snap):
    cfg = snap.get("config") or {}
    ladder = cfg.get("latency_tiers")
    occ = snap.get("occupancy") or {}
    if not ladder or not occ:
        return None
    ladder = sorted(int(t) for t in ladder)
    pad_tiers = (snap.get("pad") or {}).get("per_tier") or {}
    # when the hold rule is simultaneously dropping the hold to its
    # floor (maxhold-dominated flushes at near-empty fill), the
    # occupancy tail above the typical batch is a COALESCING ARTIFACT
    # of the very hold this diff removes — size tiers to the p50
    # typical batch then, not the p90 of a distribution that won't
    # exist under the proposed config
    f = snap.get("flush") or {}
    ftot = sum(int(f.get(k, 0)) for k in ("full", "maxhold", "deadline"))
    fillc = _occ_fill_frac(snap)
    hold_dropping = (
        ftot >= MIN_FLUSHES
        and int(f.get("maxhold", 0)) / ftot >= 0.6
        and int(f.get("deadline", 0)) / ftot < 0.3
        and fillc is not None and fillc <= 0.2
    )
    q = 0.5 if hold_dropping else 0.9
    out: List[int] = []
    notes: List[str] = []
    live = lanes_now = lanes_new = 0.0
    for i, t in enumerate(ladder):
        h = occ.get(str(t))
        keep = t
        insert = None
        if (
            h is not None and int(h["count"]) >= MIN_HIST_SAMPLES
            and i < len(ladder) - 1
        ):
            p90 = hist_quantile(h, q)
            if p90 <= TIER_SHRINK_AT * t:
                nt = max(
                    TIER_QUANTUM,
                    int(math.ceil(p90 * TIER_HEADROOM / TIER_QUANTUM))
                    * TIER_QUANTUM,
                )
                if nt < t:
                    mean = h["sum"] / h["count"]
                    # the occupancy histogram only sees the batcher's
                    # formed batches, but the ladder serves EVERY
                    # dispatch path — the pad ledger does see them all,
                    # so its excess over the batcher's share tells us
                    # whether lookups/direct calls still fill this rung
                    # past the shrunk size.  If they do, INSERT the
                    # small rung below instead of replacing.
                    pt = pad_tiers.get(str(t))
                    ns_batches = ns_live = 0.0
                    if pt:
                        ns_batches = max(
                            0.0, float(pt["total"]) / t - float(h["count"])
                        )
                        ns_live = max(
                            0.0, float(pt["live"]) - float(h["sum"])
                        )
                    ql = f"p{int(q * 100)}"
                    if ns_batches >= 4 and ns_live / ns_batches > nt:
                        insert = nt
                        notes.append(
                            f"tier {t} {ql} batcher occupancy {p90:.0f}"
                            f" (mean {mean:.0f}, n={h['count']}) ->"
                            f" insert tier {nt}; non-batcher dispatches"
                            f" still fill {ns_live / ns_batches:.0f}"
                            f" lanes so tier {t} stays"
                        )
                    else:
                        keep = nt
                        notes.append(
                            f"tier {t} {ql} occupancy {p90:.0f} (mean"
                            f" {mean:.0f}, n={h['count']}) -> tier {nt}"
                            + (" (sized to the typical batch: the"
                               " occupancy tail is coalescing under the"
                               " hold this diff also drops)"
                               if hold_dropping else "")
                        )
        if h is not None and int(h["count"]):
            n = int(h["count"])
            live += float(h["sum"])
            lanes_now += float(t) * n
            # batcher traffic lands on the new small rung either way;
            # the kept big rung keeps serving the non-batcher paths
            lanes_new += float(insert if insert is not None else keep) * n
        if insert is not None:
            out.append(insert)
        out.append(keep)
    desired = tuple(sorted(set(out)))
    if desired == tuple(ladder) or not lanes_now:
        return None
    pad_now = 1.0 - live / lanes_now
    pad_new = max(0.0, 1.0 - live / lanes_new)
    rel = (pad_new - pad_now) / pad_now if pad_now > 0 else 0.0
    evidence = (
        "; ".join(notes)
        + f" — predicted pad-waste {pad_now:.2f} -> {pad_new:.2f}"
        f" ({rel:+.0%})"
    )
    return desired, evidence, {"pad_waste_frac": round(pad_new - pad_now, 4)}


def _rule_hold(snap):
    cfg = snap.get("config") or {}
    H = cfg.get("hold_max_s")
    f = snap.get("flush") or {}
    tot = int(f.get("full", 0)) + int(f.get("maxhold", 0)) + int(
        f.get("deadline", 0)
    )
    if H is None or tot < MIN_FLUSHES:
        return None
    H = float(H)
    mh = f.get("maxhold", 0) / tot
    dl = f.get("deadline", 0) / tot
    occ = _occ_fill_frac(snap)
    if dl >= 0.3 or (mh >= 0.6 and occ is not None and occ <= 0.25):
        # the offline pass can jump, unlike the online controller's
        # one-rung bounded steps: when flushes are maxhold-bound at
        # near-empty fill the hold buys NO coalescing at any length —
        # the evidence supports the ladder floor directly
        if mh >= 0.6 and occ is not None and occ <= 0.2 and dl < 0.3:
            desired = HOLD_LADDER[0]
        else:
            desired = _ladder_step(HOLD_LADDER, H, up=False)
        if desired >= H:
            return None
        why = (
            f"deadline flushes {dl:.0%}" if dl >= 0.3
            else f"maxhold flushes {mh:.0%} at {occ:.2f} mean fill"
        )
        evidence = (
            f"{why} under hold {H * 1000:g}ms — batches flush on the"
            f" clock, not on fill: hold {desired * 1000:g}ms trims the"
            " wait without losing coalescing"
        )
        # requests flushing at maxhold waited the full hold; they save
        # the difference (scaled by how often that path fired)
        return desired, evidence, {
            "p99_ms": round(-(H - desired) * 1000.0 * mh, 3)
        }
    if mh >= 0.6 and occ is not None and occ >= 0.6:
        desired = _ladder_step(HOLD_LADDER, H, up=True)
        if desired <= H:
            return None
        occ_new = min(1.0, occ * desired / H)
        evidence = (
            f"maxhold flushes {mh:.0%} at {occ:.2f} mean fill under hold"
            f" {H * 1000:g}ms — batches nearly fill: hold"
            f" {desired * 1000:g}ms converts clock flushes to full ones"
        )
        return desired, evidence, {
            "pad_waste_frac": round((1 - occ_new) - (1 - occ), 4)
        }
    return None


def _rule_cache(snap):
    c = snap.get("cache")
    if not c or c.get("max_bytes") is None:
        return None
    lookups = int(c.get("hits", 0)) + int(c.get("misses", 0))
    if lookups < MIN_CACHE_LOOKUPS:
        return None
    mx = int(c["max_bytes"])
    used = int(c.get("bytes", 0))
    hr = float(c.get("hit_rate", 0.0))
    ev = int(c.get("evicted_revisions", 0))
    if hr >= 0.2 and used >= 0.85 * mx and ev > 0 and mx < CACHE_MAX_BYTES:
        desired = min(mx * 2, CACHE_MAX_BYTES)
        evidence = (
            f"hit rate {hr:.0%} with {used / mx:.0%} of {mx >> 20}MiB"
            f" used and {ev} revision shards evicted — the budget, not"
            f" the workload, is the ceiling: grow to {desired >> 20}MiB"
        )
        return desired, evidence, {"cache_bytes": desired - mx}
    if hr < 0.02 and used <= 0.25 * mx and mx > CACHE_MIN_BYTES:
        desired = max(mx // 2, CACHE_MIN_BYTES)
        evidence = (
            f"hit rate {hr:.1%} with only {used / mx:.0%} of"
            f" {mx >> 20}MiB used — reclaim host memory:"
            f" {desired >> 20}MiB"
        )
        return desired, evidence, {"cache_bytes": desired - mx}
    return None


def _rule_dedup(snap):
    cfg = snap.get("config") or {}
    if cfg.get("dedup") is None:
        return None
    s = snap.get("serve") or {}
    checks = int(s.get("checks", 0))
    unique = int(s.get("unique_checks", 0))
    if checks < MIN_CHECKS or unique <= 0:
        # duplicate fraction is only measured while dedup runs (the
        # unique-work count comes from the singleflight key pass) —
        # no measurement, no proposal
        return None
    # serve.checks already counts parked twins (the singleflight window
    # settles them as served checks), so unique/checks is the honest
    # duplicate fraction across both in-batch and cross-batch dedup
    parked = int(s.get("dedup_parked", 0))
    dup = max(0.0, 1.0 - unique / checks)
    if dup >= DEDUP_ON_FRAC:
        desired = True
        evidence = (
            f"duplicate fraction {dup:.1%} over {checks} checks"
            f" ({parked} parked on in-flight twins) — dedup collapses"
            " that work before it reaches a tier lane"
        )
        predicted = {"goodput_frac": round(dup, 4)}
    elif dup < DEDUP_OFF_FRAC:
        desired = False
        evidence = (
            f"duplicate fraction {dup:.2%} over {checks} checks — below"
            f" {DEDUP_OFF_FRAC:.1%}: the per-batch key pass buys"
            " nothing, drop it from the dispatch path"
        )
        predicted = {"goodput_frac": 0.0}
    else:
        return None  # hysteresis band: keep whatever runs today
    return desired, evidence, predicted


def _rule_packed(snap):
    by = snap.get("bytes") or {}
    cand = by.get("candidates")
    if not cand or "packed" not in cand or "unpacked" not in cand:
        return None
    p, u = float(cand["packed"]), float(cand["unpacked"])
    if p <= 0 or u <= 0:
        return None
    if p <= (1.0 - PACKED_MARGIN) * u:
        desired = True
        rel = (p - u) / u
    elif u <= (1.0 - PACKED_MARGIN) * p:
        desired = False
        rel = 0.0
    else:
        return None  # within margin: not worth a layout change
    evidence = (
        f"gathered bytes/check packed {p:.0f} vs unpacked {u:.0f}"
        f" (offline A/B prepare) — flat_packed={desired}"
    )
    return desired, evidence, {"bytes_per_check_frac": round(rel, 4)}


def _rule_kernels(snap):
    """Propose the fused probe kernels from the one-pass byte model
    prepare publishes (utils/perf.publish_kernel_model gauges): fused
    device bytes/check against the plain versions' gather + decode
    traffic.  The veto runs first: where the kernels cannot launch (no
    CUDA device, or the kernel library does not build) the knob is
    proposed off however good the model looks -- ``kernels=True`` would
    raise there, since the engine never falls back."""
    kn = snap.get("kernels")
    if not kn:
        return None
    if not kn.get("available"):
        return (False,
                "fused probe vetoed: no CUDA device or kernel library"
                " — kernels=False",
                {"bytes_per_check_frac": 0.0})
    fused = float(kn.get("bytes_per_check") or 0.0)
    saved = float(kn.get("bytes_saved_per_check") or 0.0)
    if fused <= 0:
        return None  # no fused prepare measured this window: stay silent
    plain = fused + saved
    if plain <= 0:
        return None
    frac = saved / plain
    if frac >= KERNELS_MARGIN:
        desired, rel = True, -frac
    elif frac <= 0.0:
        desired, rel = False, 0.0
    else:
        return None  # within margin: not worth a backend change
    evidence = (
        f"one-pass byte model: fused {fused:.0f} vs plain {plain:.0f}"
        f" bytes/check ({frac:.0%} saved) — kernels={desired}"
    )
    return desired, evidence, {"bytes_per_check_frac": round(rel, 4)}


def _rule_lsm_compact(snap):
    """Move the host LSM materialization floor off chain-depth
    telemetry (store/group.py ChainCompactor gauges): merge churn means
    the floor is too low (each merge rewrites the O(E) base), a deep
    merge-free resident chain means it is too high (every probe pays
    the chain's extra binary search).  Moves are ×2 / ÷2, clamped —
    the cache rule's quantization discipline."""
    cfg = snap.get("config") or {}
    cm = cfg.get("lsm_compact_min")
    ch = snap.get("chain") or {}
    if cm is None or not ch:
        return None
    cm = int(cm)
    rows = float(ch.get("overlay_rows", 0.0))
    chain_len = float(ch.get("chain_len", 0.0))
    merges = int(ch.get("bg_compactions", 0))
    if merges >= MIN_BG_COMPACTIONS and cm < LSM_COMPACT_CEIL:
        desired = min(cm * 2, LSM_COMPACT_CEIL)
        evidence = (
            f"{merges} background chain merges in the window at floor"
            f" {cm} — each merge rewrites the whole base: doubling the"
            f" floor to {desired} halves merge frequency while the"
            " compactor's early trip keeps probe depth bounded"
        )
        return desired, evidence, {"bg_compactions": -(merges // 2)}
    if (
        merges == 0
        and rows >= CHAIN_DEEP_FRAC * cm
        and cm > LSM_COMPACT_FLOOR
    ):
        desired = max(cm // 2, LSM_COMPACT_FLOOR)
        evidence = (
            f"resident chain at {rows:.0f} overlay rows"
            f" ({chain_len:.0f} revisions, {rows / cm:.0%} of the {cm}"
            " floor) with no background merge all window — every probe"
            " pays the chain's extra binary search; halve the floor to"
            f" {desired} so compaction lands earlier"
        )
        return desired, evidence, {
            "probe_overlay_rows": round(float(desired) - rows, 1)
        }
    return None


def _rule_placement(snap, hbm_budget_bytes: Optional[int]):
    by = snap.get("bytes") or {}
    if hbm_budget_bytes is None:
        hbm_budget_bytes = int(
            by.get("device_budget") or NO_DEVICE_BUDGET_BYTES
        )
    total = by.get("total")
    sharded = by.get("sharded")
    if total is None or sharded is None or total <= 0:
        return None
    if (
        total > hbm_budget_bytes
        and sharded >= PLACEMENT_MIN_SHARD_FRAC * total
    ):
        desired = "routed"
        evidence = (
            f"replicated device tables {total >> 20}MiB exceed the"
            f" {hbm_budget_bytes >> 20}MiB device memory budget and"
            f" {sharded / total:.0%} of them are primary/fold-point"
            " tables a routed serve shards along the model axis"
        )
        predicted = {"device_bytes": -int(sharded)}
    if total > hbm_budget_bytes:
        # over budget but membership-dominated: routing can't shard
        # enough to matter — keep replicated, say why
        evidence = (
            f"device tables {total >> 20}MiB exceed the"
            f" {hbm_budget_bytes >> 20}MiB device memory budget but only"
            f" {sharded / total:.0%} are shardable primary/fold-point"
            " tables — routing buys too little, stay replicated"
        )
    else:
        evidence = (
            f"device tables {total >> 20}MiB fit the"
            f" {hbm_budget_bytes >> 20}MiB device memory budget — replicate"
            " whole, no collectives on any probe"
        )
    return "replicated", evidence, {}


# ---------------------------------------------------------------------------
# propose / apply
# ---------------------------------------------------------------------------

def _current_of(snap: Mapping[str, Any], target: Optional[TuneTarget],
                knob: str):
    """The knob's value on the comparison side: the explicit target
    when given, else the config the snapshot was measured under
    (missing → None, which suppresses the knob)."""
    cfg = snap.get("config") or {}
    if target is None:
        if knob == "latency_tiers":
            v = cfg.get("latency_tiers")
            return tuple(int(t) for t in v) if v is not None else None
        if knob == "flat_packed":
            return cfg.get("flat_packed_resolved")
        if knob == "kernels":
            return cfg.get("kernels_resolved")
        if knob == "cache_max_bytes":
            return cfg.get("cache_max_bytes")
        if knob == "placement":
            return cfg.get("placement")
        return cfg.get(knob)
    if knob == "latency_tiers":
        return tuple(target.engine.latency_tiers)
    if knob == "flat_packed":
        return bool(target.engine.packed_on())
    if knob == "kernels":
        return kernels_resolved(target.engine)
    if knob == "hold_max_s":
        return float(target.serve.hold_max_s)
    if knob == "dedup":
        return bool(target.serve.dedup)
    if knob == "cache_max_bytes":
        return target.cache_bytes
    if knob == "placement":
        return target.placement
    if knob == "lsm_compact_min":
        return int(target.engine.lsm_compact_min)
    raise KeyError(knob)


def propose(
    snapshot: Mapping[str, Any],
    target: Optional[TuneTarget] = None,
    *,
    hbm_budget_bytes: Optional[int] = None,
) -> TuneDiff:
    """Run every rule against the snapshot and emit the knobs whose
    desired value differs from the current one.  Deterministic:
    identical snapshot + target always emits the identical diff.
    ``hbm_budget_bytes`` is the placement rule's device memory budget
    (None: the snapshot's ``bytes.device_budget``, else
    ``NO_DEVICE_BUDGET_BYTES``)."""
    rules = (
        ("latency_tiers", "engine", lambda: _rule_tiers(snapshot)),
        ("flat_packed", "engine", lambda: _rule_packed(snapshot)),
        ("kernels", "engine", lambda: _rule_kernels(snapshot)),
        ("lsm_compact_min", "engine", lambda: _rule_lsm_compact(snapshot)),
        ("hold_max_s", "serve", lambda: _rule_hold(snapshot)),
        ("dedup", "serve", lambda: _rule_dedup(snapshot)),
        ("cache_max_bytes", "cache", lambda: _rule_cache(snapshot)),
        ("placement", "deploy",
         lambda: _rule_placement(snapshot, hbm_budget_bytes)),
    )
    knobs: List[KnobDiff] = []
    for knob, layer, rule in rules:
        got = rule()
        if got is None:
            continue
        desired, evidence, predicted = got
        current = _current_of(snapshot, target, knob)
        if current is None or current == desired:
            continue
        knobs.append(KnobDiff(
            knob=knob, layer=layer, current=current, proposed=desired,
            evidence=evidence, predicted=predicted,
        ))
    return TuneDiff(tuple(knobs))


def apply_diff(target: TuneTarget, diff: TuneDiff) -> TuneTarget:
    """Apply a diff to a TuneTarget — pure, returns a new target (the
    frozen-config discipline: applying is dataclasses.replace, nothing
    mutates in place)."""
    engine, serve = target.engine, target.serve
    cache_bytes, placement = target.cache_bytes, target.placement
    for k in diff.knobs:
        if k.knob == "latency_tiers":
            engine = replace(
                engine, latency_tiers=tuple(int(t) for t in k.proposed)
            )
        elif k.knob == "flat_packed":
            engine = replace(engine, flat_packed=bool(k.proposed))
        elif k.knob == "kernels":
            engine = replace(engine, kernels=bool(k.proposed))
        elif k.knob == "lsm_compact_min":
            engine = replace(engine, lsm_compact_min=int(k.proposed))
        elif k.knob == "hold_max_s":
            serve = replace(serve, hold_max_s=float(k.proposed))
        elif k.knob == "dedup":
            serve = replace(serve, dedup=bool(k.proposed))
        elif k.knob == "cache_max_bytes":
            cache_bytes = int(k.proposed)
        elif k.knob == "placement":
            placement = str(k.proposed)
        else:
            raise KeyError(f"unknown tune knob {k.knob!r}")
    return TuneTarget(
        engine=engine, serve=serve, cache_bytes=cache_bytes,
        placement=placement,
    )
