"""Latency-mode execution path: warm small-batch dispatch on pinned CUDA
graphs with an honest per-stage budget.

The throughput path (engine/device.py ``check_batch`` / ``check_columns``)
is shaped for large batches: padding that tracks the batch, one eager
PyTorch program launched op by op, results fetched when the batch ends.
For interactive-sized batches (the small CheckBulkPermissions batches of
the reference, client/client.go:238-266) most of that time is launching
many small ops from the host, and every such cost lands in the tail.

This path removes every per-dispatch variable cost it can:

- **pinned graphs**: the flat program (``make_flat_fn``, its bucket
  probes in the hand-written kernels) is captured ONCE per (permission
  slots, batch tier, request-context shape) into a ``torch.cuda.CUDAGraph``
  over static device buffers, then replayed: one launch for the whole
  program.  ``compile_count`` counts captures paid; warm dispatches pay
  none.
- **pins shared across a delta chain**: the engine keeps its pins
  (``DeviceEngine._latency_pins``), keyed as the reference keys its
  executables (FlatMeta, the shapes of the snapshot's tensors, the pin's
  own key) plus what a graph bakes in: the storage of the tensors it
  reads.  A graph reads the pointers it was captured on, so the
  revisions of a delta chain in one shape band share a ``_Band``: its
  private buffers for the tensors that differ between them (the ``dl_*``
  overlays, and any tensor the chain replaced since its full prepare,
  ``DeviceSnapshot.base_ptrs``), over which, and over the base tensors
  the revisions share, every pin of the band is captured.  A dispatch
  from another revision than the one the band last served copies that
  revision's tensors into the buffers on the device first, once for all
  the band's pins (``latency.rebinds``), then replays.  A full prepare
  (new base storage) or a grown overlay band (new shapes) is a new band,
  and captures.  A band lives while a path of one of its revisions
  does: when the last is freed, the engine drops the band's pins, so no
  pin outlives the snapshots it serves or keeps their base alive.
- **batch tiers**: batches pad to a small fixed ladder of tiers
  (``EngineConfig.latency_tiers``, default 256/1024/4096) instead of the
  batch's own pow2: a workload whose batch size jitters between 900 and
  1100 stays on ONE graph.  Pins are keyed by the tier value, so any
  sorted ladder works.
- **static staging**: one pinned host query-matrix buffer per tier,
  refilled in place (engine/flat.py ``fill_qm``) and copied
  asynchronously into the graph's static query matrix; the clock is a
  0-dim device tensor the kernels read by pointer, filled before each
  replay, so one graph answers at every clock.
- **budget breakdown**: every dispatch is timed in four stages: host
  lowering (query packing), H2D (staging copy and clock), kernel (the
  replay), D2H (the planes into pinned host memory), published as
  ``latency.{host_lower,h2d,kernel,d2h,dispatch}_s`` with live p50/p99
  and kept on ``last_budget``.  Those samples are warm dispatches only: a
  dispatch that captures its pin is published on its own, as
  ``latency.cold_dispatch_s``.

- **witness pins**: ``arm_witness()`` makes later dispatches run the
  armed flat program (``make_flat_fn(witness=True)``), pinned under its
  own key (the disarmed keys are exactly as without it), and copies its
  fourth output, the per-query witness codes (engine/explain.py), to
  ``last_witness`` in the same readback as the planes.  Disarmed, a
  dispatch pays one flag read.

On ``cpu`` there is no graph: a pin runs the same eager program over the
same static buffers, so the CPU tests exercise everything but the
replay.  On ``cuda`` a failed capture raises; nothing falls back to the
eager program.

Correctness contract is identical to the throughput path: the same
(definite, possible, overflow) planes; callers resolve conditional and
overflowed rows on the host oracle.  What the path cannot serve (no flat
tables, sharded tables, too many distinct permissions, a batch beyond
the top tier) returns None and the caller falls back to the throughput
path: the latency path narrows latency, never coverage.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import faults
from ..utils import metrics as _metrics
from ..utils import perf as _perf
from ..utils import trace as _trace
from . import kernels as _K
from .capture import recording
from .device import to_device_tensor
from .flat import QM_ROWS, fill_qm

def tier_for(tiers, B: int) -> Optional[int]:
    """Smallest tier in the ladder holding ``B``, or None (-> the
    throughput path)."""
    for t in sorted(tiers):
        if B <= t:
            return int(t)
    return None


@dataclass
class DispatchBudget:
    """Per-dispatch stage timings (seconds) of one latency-mode call."""

    batch: int
    tier: int
    host_lower_s: float
    h2d_s: float
    kernel_s: float
    d2h_s: float
    total_s: float
    #: True when this dispatch captured its pin (cold); warm
    #: steady-state dispatches are always False
    compiled: bool
    #: bytes this dispatch copied into its band's private buffers (shared
    #: with other revisions); 0 when they held this revision's
    rebind_bytes: int = 0

    def as_dict(self) -> Dict[str, float]:
        return {
            "batch": self.batch,
            "tier": self.tier,
            "host_lower_s": self.host_lower_s,
            "h2d_s": self.h2d_s,
            "kernel_s": self.kernel_s,
            "d2h_s": self.d2h_s,
            "total_s": self.total_s,
            "compiled": self.compiled,
            "rebind_bytes": self.rebind_bytes,
        }


def _tensors_of(dsnap, shared_names):
    """The tensors a pin reads from ``dsnap`` without owning them: the
    arrays named ``shared_names``, the type map and the decode specs."""
    out = [dsnap.arrays[k] for k in shared_names]
    out.append(dsnap.tid_map)
    for k in sorted(dsnap.specs):
        out.extend(dsnap.specs[k])
    return out


class _Band:
    """What the revisions of one shape band of a delta chain share: the
    buffers every pin of the band reads in place of the tensors that
    differ between those revisions, which revision they hold, and the
    live paths of the band's revisions (``users``).  The engine's replay
    lock covers a rebind."""

    def __init__(self, share: Tuple, dsnap) -> None:
        #: the engine-cache key part (``LatencyPath._share_key``)
        self.share = share
        #: name -> the band's own buffer for a tensor that differs
        #: between its revisions
        self.private: Dict[str, torch.Tensor] = {
            k: torch.empty_like(dsnap.arrays[k]) for k in share[2]
        }
        #: weak references to the revision tensors the buffers hold
        #: copies of (None: nothing bound yet)
        self._bound: Optional[list] = None
        #: ids of the live paths of this band's revisions
        self.users: set = set()
        #: the engine-cache keys of the band's pins
        self.pin_keys: set = set()
        #: set once the engine dropped the band (its last user died)
        self.dropped = False

    def bind(self, dsnap) -> int:
        """Copy ``dsnap``'s tensors into the buffers, on the device's
        current stream, unless they hold them already; returns the bytes
        copied."""
        srcs = [dsnap.arrays[k] for k in self.private]
        bound = self._bound
        if bound is not None and all(r() is t for r, t in zip(bound, srcs)):
            return 0
        self._bound = None  # a copy that raises leaves nothing bound
        n = 0
        for buf, src in zip(self.private.values(), srcs):
            buf.copy_(src, non_blocking=True)
            n += src.numel() * src.element_size()
        self._bound = [weakref.ref(t) for t in srcs]
        return n


def _release_band_user(engine_ref, band: _Band, path_id: int) -> None:
    """A path of ``band``'s revisions was freed: once it was the last,
    the engine drops the band's pins (their graphs and outputs) and the
    band's buffers go with them.  Runs from the garbage collector, so it
    takes no lock: each step is one atomic dict or set operation."""
    band.users.discard(path_id)
    eng = engine_ref()
    if band.users or eng is None:
        return
    eng._drop_latency_band(band)


class _Pin:
    """The flat program pinned at one (slots, tier, qctx shape) over one
    band of a delta chain: static input buffers (query matrix, clock,
    request-context tables) and on ``cuda`` the CUDA graph captured over
    them, the band's buffers and the shared base tensors, with its
    static output planes and a pinned host copy.  Each replay overwrites
    the outputs: the engine's replay lock covers a dispatch from filling
    the inputs to reading the outputs back."""

    def __init__(self, engine, fn, tier: int, qctx_np, qctx_shared,
                 band: _Band, witness: bool = False) -> None:
        dev = engine.device
        self.fn = fn
        self.band = band
        #: the armed program: a fourth output, the witness codes
        self.witness = witness
        self.qm = torch.empty((QM_ROWS, tier), dtype=torch.int32, device=dev)
        self.now = torch.zeros((), dtype=torch.int32, device=dev)
        #: the engine's context-free device tables (long-lived), or static
        #: buffers each dispatch copies its request contexts into
        self.qctx_static = qctx_shared is None
        self.qctx = qctx_shared if qctx_shared is not None else {
            k: to_device_tensor(v, dev).clone() for k, v in qctx_np.items()
        }
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.host: Optional[torch.Tensor] = None
        #: the armed pin's static witness output and its pinned host copy
        self.wout: Optional[torch.Tensor] = None
        self.whost: Optional[torch.Tensor] = None
        #: kernel launches per mode inside the capture (LAUNCHES keys)
        self.modes: Dict[str, int] = {}
        self.ready = False
        #: this pin's key in the engine's cache
        self.full_key: Optional[Tuple] = None

    def args(self, dsnap):
        arrays = dsnap.arrays
        if self.band.private:
            arrays = dict(arrays)
            arrays.update(self.band.private)
        return (arrays, dsnap.tid_map, self.now, self.qm, self.qctx,
                dsnap.specs)

    def capture(self, dsnap, pool) -> None:
        """Capture the program into a CUDA graph (``cuda``) whose memory
        comes from ``pool``; on ``cpu`` the pin runs the eager program.
        The inputs hold the first batch and ``dsnap``'s tensors are bound:
        one eager run on a side stream builds the kernels and the device
        constants (engine/consts.py), then the capture records the
        program on that stream.  Unlike the ``torch.cuda.graph`` context,
        this neither synchronises the device nor empties the allocator's
        cache, which eager batches would pay for afterwards.  Capture
        errors raise, and leave the allocator as they found it: a capture
        that fails ends in ``capture_end``'s error before it stops
        allocating from ``pool``, so that is done here, and the caller
        drops the pin (``LatencyPath._capture``)."""
        if self.qm.device.type != "cuda":
            self.ready = True
            return
        dev = self.qm.device
        args = self.args(dsnap)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.no_grad():
            self.fn(*args)
            before = dict(_K.LAUNCHES)
            with recording():
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                err = None
                try:
                    got = self.fn(*args)
                    out = torch.stack(got[:3])
                    wout = got[3] if self.witness else None
                except BaseException as e:  # the program's error to see
                    err = e
                try:
                    graph.capture_end()
                except RuntimeError:
                    index = (torch.cuda.current_device() if dev.index is None
                             else dev.index)
                    torch._C._cuda_endAllocateToPool(index, pool)
                    if err is None:
                        raise
            if err is not None:
                raise err
        torch.cuda.current_stream(dev).wait_stream(side)
        self.modes = {k: v - before[k] for k, v in _K.LAUNCHES.items()
                      if v > before[k]}
        self.graph, self.out, self.wout = graph, out, wout
        self.host = torch.empty(out.shape, dtype=torch.bool, pin_memory=True)
        if wout is not None:
            self.whost = torch.empty(wout.shape, dtype=torch.int32,
                                     pin_memory=True)
        self.ready = True

    def run(self, dsnap):
        """The [3, tier] planes of the inputs as filled and bound, and the
        [tier] witness codes of an armed pin (else None): the replayed
        graph's static outputs on ``cuda``, the eager program's on
        ``cpu``."""
        if self.graph is not None:
            self.graph.replay()
            return self.out, self.wout
        with torch.no_grad():
            got = self.fn(*self.args(dsnap))
        return torch.stack(got[:3]), got[3] if self.witness else None


class LatencyPath:
    """Warm small-batch dispatcher for one DeviceSnapshot.

    Obtained via ``DeviceEngine.latency_path(dsnap)`` (one per prepared
    snapshot).  It looks its pins up in the engine's cache, where the
    other revisions of its band may have pinned them already."""

    def __init__(self, engine, dsnap, registry: Optional[Any] = None) -> None:
        self.engine = engine
        self.dsnap = dsnap
        self._m = registry or _metrics.default
        #: covers this path's staging buffers, from filling one to its
        #: copy to the device; the engine's replay lock covers the pins
        self._lock = threading.Lock()
        #: this snapshot's band (``_band_for``), made on the first dispatch
        self._band: Optional[_Band] = None
        #: tier -> (host int32[QM_ROWS, tier] staging tensor, its numpy view)
        self._qm_bufs: Dict[int, Tuple[torch.Tensor, np.ndarray]] = {}
        #: captures this path paid for: the no-recapture assertion's
        #: subject
        self.compile_count = 0
        #: distinct (slots, tier, qctx) keys this path took a pin for
        #: (captured here or found in the engine's cache)
        self.pin_count = 0
        #: the keys ``pin_count`` counted
        self._pinned_keys: set = set()
        #: dispatches this path actually SERVED (not fallbacks): the
        #: client reads it around a dispatch to learn whether a
        #: latency-mode call really ran here (the breaker's half-open
        #: probe must not close on a silent batch fallback)
        self.dispatch_count = 0
        #: the engine-cache key part of this snapshot (``_share_key``)
        self._share: Optional[Tuple] = None
        #: (slots, tier, qctx_key) keys this path has SERVED warm: a fresh
        #: capture for one of them means its pin was lost (FIFO
        #: eviction) and is being paid for at serving time
        self._served_keys: set = set()
        self.last_budget: Optional[DispatchBudget] = None
        #: lazily computed gathered-bytes/check of this snapshot (the perf
        #: ledger's meta model), for sampled dispatch spans
        self._bpc_cache: Optional[float] = None
        #: witness extraction (``arm_witness``): armed, dispatches run the
        #: armed program on pins of their own and leave the per-query
        #: codes of the last batch on ``last_witness``; disarmed (the
        #: default) no witness buffer exists and no extra output ships
        self.witness_armed = False
        self.last_witness: Optional[np.ndarray] = None

    def _bytes_per_check(self) -> float:
        v = self._bpc_cache
        if v is None:
            try:
                v = _perf.est_bytes_per_check(self.dsnap)
            except Exception:
                v = 0.0
            self._bpc_cache = v
        return v

    # -- availability ----------------------------------------------------
    def tier_for(self, B: int) -> Optional[int]:
        """Smallest configured tier holding ``B``, or None (-> fall back
        to the throughput path)."""
        return tier_for(self.engine.config.latency_tiers, B)

    def arm_witness(self, on: bool = True) -> None:
        """Toggle witness extraction for later dispatches.  Armed and
        disarmed pins have distinct keys, so flipping never evicts or
        recaptures the other mode's pins: the first armed dispatch of a
        (slots, tier, qctx shape) in a band captures once, later ones
        replay (a write that keeps the band rebinds, as for any pin)."""
        self.witness_armed = bool(on)
        if not on:
            self.last_witness = None

    # -- pinning ---------------------------------------------------------
    def _qctx_key(self, qctx) -> Tuple:
        """The pin key's request-context part: the engine's context-free
        singleton is captured as it is; other tables go through static
        buffers of their shapes."""
        if qctx is self.engine._empty_qctx_np:
            return ("empty",)
        return ("ctx",) + tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in sorted(qctx.items())
        )

    def _share_key(self) -> Tuple:
        """The engine-cache key part of this snapshot: FlatMeta (the
        program closes over it, DeltaMeta included), the shapes of its
        tensors (the reference's fingerprint), the names the pins keep
        private (the ``dl_*`` overlays and every tensor the chain
        replaced since its full prepare), and the storage of the rest:
        two revisions with equal keys differ only in the private
        tensors."""
        if self._share is None:
            ds = self.dsnap
            base = ds.base_ptrs or {}
            private = tuple(sorted(
                k for k, v in ds.arrays.items()
                if k.startswith("dl_") or base.get(k) != v.data_ptr()))
            shared = [k for k in sorted(ds.arrays) if k not in private]
            self._share = (
                ds.flat_meta,
                tuple(sorted((k, tuple(v.shape), str(v.dtype))
                             for k, v in ds.arrays.items())),
                private,
                tuple(shared),
                tuple(t.data_ptr() for t in _tensors_of(ds, shared)),
            )
        return self._share

    def _band_for(self) -> _Band:
        """This snapshot's band: the engine's, when another revision with
        the same ``_share_key`` made it, else a new one.  The path is one
        of the band's users until it is freed (``_release_band_user``).
        Called under the engine's replay lock."""
        band = self._band
        if band is not None and not band.dropped:
            return band
        eng = self.engine
        share = self._share_key()
        with eng._latency_pins_lock:
            band = eng._latency_bands.get(share)
            if band is None or band.dropped:
                band = eng._latency_bands[share] = _Band(share, self.dsnap)
            band.users.add(id(self))
        self._band = band
        f = weakref.finalize(self, _release_band_user, weakref.ref(eng),
                             band, id(self))
        f.atexit = False
        return band

    def _pinned_for(self, slots, tier, qctx_key, qctx):
        """The pin for this (slots, tier, qctx shape) in the engine's
        cache (pinned by this path or by another revision of its band),
        else a new one (captured by the dispatch on its first run).
        Called under the engine's replay lock.  Returns (pin, key): an
        armed path's keys end in ``"wit"``; the disarmed keys are the
        same as without witness pins."""
        wit = self.witness_armed
        key = (slots, tier, qctx_key) if not wit else (
            slots, tier, qctx_key, "wit")
        band = self._band_for()
        full_key = (band,) + key
        eng = self.engine
        with eng._latency_pins_lock:
            pin = eng._latency_pins.get(full_key)
            if pin is None:
                fn = eng._flat_fn_for(slots, self.dsnap.flat_meta,
                                      witness=wit)
                shared = (eng._qctx_device(qctx) if qctx_key[0] == "empty"
                          else None)
                pin = _Pin(eng, fn, tier, qctx, shared, band, witness=wit)
                pin.full_key = full_key
                pins = eng._latency_pins
                while len(pins) >= eng.LATENCY_PIN_CACHE_MAX:
                    pins.pop(next(iter(pins)), None)
                pins[full_key] = pin
                band.pin_keys.add(full_key)
        if key not in self._pinned_keys:
            self._pinned_keys.add(key)
            self.pin_count += 1
        return pin, key

    def _capture(self, pin, key) -> None:
        """Capture ``pin`` into the graph pool the engine's pins share:
        that of a captured pin still in the engine (held here until the
        capture ends, so its pool stays alive), else a new one; a pool
        whose graphs are all gone cannot take another capture.  A pin
        whose capture failed is dropped from the engine, so the next
        dispatch of its key captures anew (and raises again if the fault
        persists) instead of replaying a broken graph."""
        eng = self.engine
        self.compile_count += 1
        self._m.inc("latency.compiles")
        slots, tier = key[0], key[1]
        _perf.record_cost("latency_pin", f"tier={tier};slots={slots}",
                          self._m, tier=int(tier), slots=len(slots))
        donor, pool = None, None
        if eng.device.type == "cuda":
            with eng._latency_pins_lock:
                donor = next((p for p in eng._latency_pins.values()
                              if p.graph is not None), None)
            pool = (donor.graph.pool() if donor is not None
                    else torch.cuda.graph_pool_handle())
        try:
            pin.capture(self.dsnap, pool)
        except BaseException:
            with eng._latency_pins_lock:
                if eng._latency_pins.get(pin.full_key) is pin:
                    del eng._latency_pins[pin.full_key]
            raise
        finally:
            del donor

    def _qm_buf(self, tier: int) -> Tuple[torch.Tensor, np.ndarray]:
        buf = self._qm_bufs.get(tier)
        if buf is None:
            t = torch.empty((QM_ROWS, tier), dtype=torch.int32,
                            pin_memory=self.engine.device.type == "cuda")
            buf = self._qm_bufs[tier] = (t, t.numpy())
        return buf

    def pins(self) -> Dict[Tuple, _Pin]:
        """The engine's pins of this path's band by (slots, tier,
        qctx_key); the other revisions of the band see the same ones."""
        band = self._band
        with self.engine._latency_pins_lock:
            items = list(self.engine._latency_pins.items())
        return {k[1:]: p for k, p in items if k[0] is band}

    # -- dispatch --------------------------------------------------------
    def dispatch(
        self,
        queries: Dict[str, np.ndarray],
        qctx: Dict[str, np.ndarray],
        B: int,
        now,
        t_start: Optional[float] = None,
        span=_trace.NOOP,
    ):
        """One warm small-batch dispatch from already-lowered query
        columns.  ``now`` is the snapshot-relative int32 clock
        (snap.now_rel32).  ``t_start`` backdates the host-lowering stage
        to when the caller began lowering.  ``span`` is the request's
        trace span: a sampled dispatch records stage child spans from
        the SAME perf_counter stamps the budget uses.  Returns trimmed
        (d, p, ovf) numpy arrays, or None when this path cannot serve
        the batch."""
        t0 = t_start if t_start is not None else time.perf_counter()
        meta = self.dsnap.flat_meta
        if meta is None or meta.sharded:
            return None
        tier = self.tier_for(B)
        if tier is None:
            return None
        slots = tuple(
            sorted({int(s) for s in np.unique(queries["q_perm"]) if s >= 0})
        )
        if len(slots) > self.engine.config.flat_max_slots:
            return None
        # injection site AFTER the availability checks: a batch this path
        # would decline falls back without ever reaching the fault
        faults.fire("latency.dispatch")
        dev = self.engine.device
        cuda = dev.type == "cuda"
        # the stages are fenced on ``cuda``, so each stage's time is its
        # own; on ``cpu`` every stage is synchronous already
        sync = torch.cuda.current_stream(dev).synchronize if cuda else None

        # ---- stage 1: host lowering (pack into the staging buffer) -----
        # the path's lock covers its staging buffers; the engine's replay
        # lock covers every pin from its copy-in to its readback: a pin,
        # its band's private buffers and the graph pool are shared by the
        # revisions of the band
        eng = self.engine
        with self._lock:
            stage_t, stage_np = self._qm_buf(tier)
            fill_qm(queries, stage_np, meta)
            qctx_key = self._qctx_key(qctx)
            with eng._latency_replay_lock:
                pin, pin_key = self._pinned_for(slots, tier, qctx_key, qctx)
                t1 = time.perf_counter()

                # ---- stage 2: H2D (staging matrix, clock, contexts), and
                # this revision's private tensors when the band last served
                # another revision (device to device)
                pin.qm.copy_(stage_t, non_blocking=True)
                pin.now.fill_(int(now))
                if pin.qctx_static:
                    for k, v in qctx.items():
                        pin.qctx[k].copy_(torch.from_numpy(
                            np.ascontiguousarray(v)).view(pin.qctx[k].dtype),
                            non_blocking=True)
                rebind = pin.band.bind(self.dsnap)
                if cuda:
                    sync()
                t2 = time.perf_counter()

                # ---- stage 3: the pinned program (replay) ---------------
                fresh = not pin.ready
                if fresh and pin_key in self._served_keys:
                    # this shape was served warm before: its pin was lost
                    self._m.inc("latency.retraces")
                    _trace.trigger_incident(
                        "latency.retrace", tier=tier, batch=B,
                        slots=len(slots),
                    )
                with _trace.annotate_dispatch(span):
                    if fresh:
                        self._capture(pin, pin_key)
                    out, wout = pin.run(self.dsnap)
                if cuda:
                    sync()
                t3 = time.perf_counter()

                # ---- stage 4: D2H readback (an armed pin's codes too,
                # before another replay can overwrite its static output)
                if cuda:
                    pin.host.copy_(out, non_blocking=True)
                    if wout is not None:
                        pin.whost.copy_(wout, non_blocking=True)
                    sync()
                    got = pin.host.numpy()[:, :B].copy()
                    if wout is not None:
                        self.last_witness = pin.whost.numpy()[:B].copy()
                else:
                    got = out[:, :B].numpy().copy()
                    if wout is not None:
                        self.last_witness = wout[:B].numpy().copy()
                t4 = time.perf_counter()

        budget = DispatchBudget(
            batch=B, tier=tier,
            host_lower_s=t1 - t0, h2d_s=t2 - t1,
            kernel_s=t3 - t2, d2h_s=t4 - t3,
            total_s=t4 - t0, compiled=fresh, rebind_bytes=rebind,
        )
        self.last_budget = budget
        self.dispatch_count += 1
        _perf.record_pad(tier, B, self._m)
        _perf.report_wall_stages(t0, t1, t2, t3, t4)
        if len(self._served_keys) < 4096:  # qctx-shape churn backstop
            self._served_keys.add(pin_key)
        m = self._m
        m.inc("latency.dispatches")
        if fresh:
            # a capture is not a tail sample of the warm path: cold
            # dispatches (the first of a new shape band) are published on
            # their own
            m.observe("latency.cold_dispatch_s", budget.total_s)
        elif rebind:
            # nor is a rebind: the first dispatch of a revision on a pin
            # another revision of the chain captured
            m.inc("latency.rebinds")
            m.inc("latency.rebind_bytes", rebind)
            m.observe("latency.rebind_dispatch_s", budget.total_s)
        else:
            m.observe("latency.host_lower_s", budget.host_lower_s)
            m.observe("latency.h2d_s", budget.h2d_s)
            m.observe("latency.kernel_s", budget.kernel_s)
            m.observe("latency.d2h_s", budget.d2h_s)
            m.observe("latency.dispatch_s", budget.total_s)
        if span.sampled:
            lsp = span.child(
                "latency.dispatch", t=t0,
                batch=B, tier=tier, compiled=fresh,
                pad_fraction=round(1.0 - B / tier, 4),
                bytes_gathered_est=round(self._bytes_per_check() * B, 1),
            )
            lsp.child_at("stage.host_lower", t0).end(t=t1)
            lsp.child_at("stage.h2d", t1).end(t=t2)
            lsp.child_at("stage.kernel", t2).end(t=t3)
            lsp.child_at("stage.d2h", t3).end(t=t4)
            lsp.end(t=t4)
        return got[0], got[1], got[2]

    def dispatch_columns(
        self,
        q_res: np.ndarray,
        q_perm: np.ndarray,
        q_subj: np.ndarray,
        *,
        q_srel: Optional[np.ndarray] = None,
        q_wc: Optional[np.ndarray] = None,
        q_ctx: Optional[np.ndarray] = None,
        qctx_rows=None,
        now_us: Optional[int] = None,
        span=_trace.NOOP,
    ):
        """Latency-path bulk check from pre-interned int32 columns.
        Returns (d, p, ovf) or None -> the caller falls back."""
        t0 = time.perf_counter()
        queries, qctx = self.engine._columns_preamble(
            self.dsnap, q_res, q_perm, q_subj, q_srel, q_wc, q_ctx, qctx_rows
        )
        now = self.dsnap.snapshot.now_rel32(now_us)
        return self.dispatch(
            queries, qctx, q_res.shape[0], now, t_start=t0, span=span
        )
