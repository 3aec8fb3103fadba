"""Online controller: the three cheap knobs, adjusted live and safely.

Hold-back deadline, verdict-cache byte budget, and the dedup window are
the knobs whose apply is a single attribute swap — no recompile, no
re-prepare — so they are safe to move while serving.  Everything else
(tier ladder, pack spec, placement) stays offline (tune/tuner.py).

Safety posture, in order of importance:

- **bounded step**: every move is ×2 or ÷2 (hold snaps to the offline
  ladder), clamped to an explicit range — a runaway signal cannot fling
  a knob across its domain in one tick.
- **hysteresis**: distinct raise/lower watermarks per signal, so a
  workload sitting ON a threshold doesn't flap the knob every tick.
- **cooldown**: after a move the knob sits out ``cooldown_steps`` ticks
  — the system must re-measure under the new value before the
  controller may judge it.
- **oscillation tripwire**: a knob whose recent moves keep reversing
  direction is frozen and a flight-recorder incident
  (``tune.oscillation``) captures the trajectory — a controller
  fighting the workload is a bug report, not a steady state.
- **one-call revert**: ``revert()`` restores the preset captured at
  construction, unfreezes everything, and counts itself.

Observability: every applied move bumps ``tune.moves`` (and the
per-knob counter), republishes the ``tune.hold_max_s`` /
``tune.vcache_bytes`` / ``tune.dedup`` gauges, and emits a
``tune.applied`` trace event — the telemetry shows the whole
trajectory, which the convergence test replays."""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import replace
from typing import Any, Dict, Optional

from ..utils import metrics as _metrics
from ..utils import trace as _trace
from .tuner import (
    CACHE_MAX_BYTES,
    CACHE_MIN_BYTES,
    DEDUP_OFF_FRAC,
    HOLD_LADDER,
    _ladder_step,
)

#: window signals need this many formed batches / cache lookups before
#: a tick will judge a knob (thin windows are noise)
MIN_WINDOW_FLUSHES = 4
MIN_WINDOW_LOOKUPS = 64
MIN_WINDOW_CHECKS = 64


class OnlineController:
    """Slow feedback loop over live telemetry deltas.

    Construct with the serving pieces to steer (``batcher`` required;
    ``vcache`` optional), then either call ``step()`` on your own
    schedule (tests drive this directly) or ``start()`` the daemon
    thread.  Signals are COUNTER DELTAS between ticks read from the
    metrics registry — the controller needs no hooks into the serving
    path itself."""

    KNOBS = ("hold_max_s", "cache_max_bytes", "dedup")

    def __init__(
        self,
        batcher,
        *,
        vcache=None,
        registry: Optional[_metrics.Metrics] = None,
        interval_s: float = 2.0,
        cooldown_steps: int = 3,
        hold_bounds=(HOLD_LADDER[0], HOLD_LADDER[-1]),
        cache_bounds=(CACHE_MIN_BYTES, CACHE_MAX_BYTES),
        osc_window: int = 8,
        osc_flips: int = 3,
    ) -> None:
        self._b = batcher
        self._vc = vcache
        self._m = registry or _metrics.default
        self.interval_s = float(interval_s)
        self.cooldown_steps = int(cooldown_steps)
        self.hold_bounds = (float(hold_bounds[0]), float(hold_bounds[1]))
        self.cache_bounds = (int(cache_bounds[0]), int(cache_bounds[1]))
        self.osc_flips = int(osc_flips)
        #: the one-call revert target: the config the serving stack was
        #: BUILT with, captured before this controller ever moves
        self._preset = (
            batcher.config,
            int(vcache.max_bytes) if vcache is not None else None,
        )
        self._cool: Dict[str, int] = {k: 0 for k in self.KNOBS}
        #: recent move directions per knob (+1/-1); flips trip the wire
        self._dirs: Dict[str, deque] = {
            k: deque(maxlen=int(osc_window)) for k in self.KNOBS
        }
        self._frozen: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.moves = 0
        self._last = self._read()
        self._publish()

    # -- signal plumbing -------------------------------------------------
    def _read(self) -> Dict[str, float]:
        m = self._m
        names = (
            "serve.flush_full", "serve.flush_maxhold",
            "serve.flush_deadline", "serve.checks", "serve.unique_checks",
            "serve.sheds", "cache.hits", "cache.misses",
            "cache.evicted_revisions",
        )
        out = {n: m.counter(n) for n in names}
        # per-tier occupancy totals for the window's fill fraction
        for name, (_b, _c, count, total, _e) in m.hist_snapshot().items():
            if name.startswith("serve.occupancy.t"):
                tier = int(name[len("serve.occupancy.t"):])
                out[f"occ.{tier}.count"] = count
                out[f"occ.{tier}.sum"] = total
        return out

    def _window(self) -> Dict[str, float]:
        cur = self._read()
        d = {k: cur.get(k, 0.0) - self._last.get(k, 0.0) for k in cur}
        self._last = cur
        # count-weighted typical-batch fill, matching the offline rule
        # (tuner._occ_fill_frac): each formed batch votes once
        fill = 0.0
        n_total = 0.0
        for k, v in d.items():
            if k.startswith("occ.") and k.endswith(".count") and v > 0:
                tier = int(k.split(".")[1])
                fill += d.get(f"occ.{tier}.sum", 0.0) / tier
                n_total += v
        d["fill_frac"] = (fill / n_total) if n_total else -1.0
        return d

    # -- the tick --------------------------------------------------------
    def step(self) -> int:
        """One control tick: read the window, maybe move knobs.
        Returns the number of moves applied this tick."""
        w = self._window()
        applied = 0
        applied += self._step_hold(w)
        applied += self._step_cache(w)
        applied += self._step_dedup(w)
        for k in self._cool:
            if self._cool[k] > 0:
                self._cool[k] -= 1
        return applied

    def _step_hold(self, w: Dict[str, float]) -> int:
        k = "hold_max_s"
        if k in self._frozen or self._cool[k] > 0:
            return 0
        flushes = w["serve.flush_full"] + w["serve.flush_maxhold"] + w[
            "serve.flush_deadline"
        ]
        if flushes < MIN_WINDOW_FLUSHES:
            return 0
        mh = w["serve.flush_maxhold"] / flushes
        dl = w["serve.flush_deadline"] / flushes
        fill = w["fill_frac"]
        cur = float(self._b.config.hold_max_s)
        want = cur
        if dl >= 0.3 or (mh >= 0.6 and 0.0 <= fill <= 0.25):
            want = max(
                self.hold_bounds[0], _ladder_step(HOLD_LADDER, cur, up=False)
            )
        elif mh >= 0.6 and fill >= 0.6:
            want = min(
                self.hold_bounds[1], _ladder_step(HOLD_LADDER, cur, up=True)
            )
        if want == cur:
            return 0
        self._b.apply_config(replace(self._b.config, hold_max_s=want))
        self._applied(
            k, cur, want, +1 if want > cur else -1,
            maxhold_frac=round(mh, 3), deadline_frac=round(dl, 3),
            fill_frac=round(fill, 3),
        )
        return 1

    def _step_cache(self, w: Dict[str, float]) -> int:
        k = "cache_max_bytes"
        vc = self._vc
        if vc is None or k in self._frozen or self._cool[k] > 0:
            return 0
        lookups = w["cache.hits"] + w["cache.misses"]
        if lookups < MIN_WINDOW_LOOKUPS:
            return 0
        hr = w["cache.hits"] / lookups
        cur = int(vc.max_bytes)
        used = self._m.gauge("cache.bytes")
        want = cur
        if (
            hr >= 0.2 and used >= 0.85 * cur
            and w["cache.evicted_revisions"] > 0
        ):
            want = min(cur * 2, self.cache_bounds[1])
        elif hr < 0.02 and used <= 0.25 * cur:
            want = max(cur // 2, self.cache_bounds[0])
        if want == cur:
            return 0
        vc.set_max_bytes(want)
        self._applied(
            k, cur, want, +1 if want > cur else -1,
            hit_rate=round(hr, 3), used_bytes=int(used),
        )
        return 1

    def _step_dedup(self, w: Dict[str, float]) -> int:
        """On→off only: the duplicate fraction is measured by the dedup
        key pass itself, so once off there is no live signal to justify
        re-enabling — that is the offline tuner's (or revert's) call."""
        k = "dedup"
        if k in self._frozen or self._cool[k] > 0:
            return 0
        if not self._b.config.dedup:
            return 0
        checks = w["serve.checks"]
        unique = w["serve.unique_checks"]
        if checks < MIN_WINDOW_CHECKS or unique <= 0:
            return 0
        dup = max(0.0, 1.0 - unique / checks)
        if dup >= DEDUP_OFF_FRAC:
            return 0
        self._b.apply_config(replace(self._b.config, dedup=False))
        self._applied(k, True, False, -1, dup_frac=round(dup, 4))
        return 1

    # -- bookkeeping -----------------------------------------------------
    def _applied(self, knob: str, frm, to, direction: int, **why) -> None:
        self.moves += 1
        # +1 because step()'s end-of-tick decrement also fires on the
        # tick that made this move — the knob must sit out exactly
        # cooldown_steps SUBSEQUENT ticks
        self._cool[knob] = self.cooldown_steps + 1
        m = self._m
        m.inc("tune.moves")
        m.inc(f"tune.moves.{knob}")
        sp = _trace.root_span(
            "tune.applied", knob=knob, frm=frm, to=to, **why
        )
        sp.end()
        dirs = self._dirs[knob]
        dirs.append(direction)
        flips = sum(
            1 for a, b in zip(list(dirs), list(dirs)[1:]) if a != b
        )
        if flips >= self.osc_flips:
            # the knob is fighting the workload: freeze it where it
            # stands and capture the trajectory for diagnosis
            self._frozen.add(knob)
            m.inc("tune.oscillations")
            _trace.trigger_incident(
                "tune.oscillation", knob=knob, moves=list(dirs),
                flips=flips,
            )
        self._publish()

    def _publish(self) -> None:
        m = self._m
        m.set_gauge("tune.hold_max_s", float(self._b.config.hold_max_s))
        m.set_gauge("tune.dedup", 1.0 if self._b.config.dedup else 0.0)
        if self._vc is not None:
            m.set_gauge("tune.vcache_bytes", float(self._vc.max_bytes))
        m.set_gauge("tune.frozen_knobs", float(len(self._frozen)))

    def status(self) -> Dict[str, Any]:
        """Current posture — /perf report section + test assertions."""
        return {
            "moves": self.moves,
            "cooldown": dict(self._cool),
            "frozen": sorted(self._frozen),
            "hold_max_s": float(self._b.config.hold_max_s),
            "dedup": bool(self._b.config.dedup),
            "vcache_bytes": (
                int(self._vc.max_bytes) if self._vc is not None else None
            ),
            "preset_hold_max_s": float(self._preset[0].hold_max_s),
        }

    # -- revert ----------------------------------------------------------
    def revert(self) -> None:
        """One call back to the static preset: serve config and cache
        budget restored, frozen knobs thawed, move history cleared."""
        cfg, cache_bytes = self._preset
        self._b.apply_config(cfg)
        if self._vc is not None and cache_bytes is not None:
            self._vc.set_max_bytes(cache_bytes)
        self._frozen.clear()
        for d in self._dirs.values():
            d.clear()
        for k in self._cool:
            self._cool[k] = 0
        self._m.inc("tune.reverts")
        self._publish()
        sp = _trace.root_span("tune.applied", knob="revert")
        sp.end()

    # -- daemon ----------------------------------------------------------
    def start(self) -> "OnlineController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="gochugaru-tune", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                # a controller crash must never take serving down with
                # it: count, stop moving, leave the knobs where they are
                self._m.inc("tune.controller_errors")
                return

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
