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
  program.  A graph reads the storage it was captured on, so pins live
  and die with their snapshot's path: each revision of a delta chain
  (new overlay storage) captures its own.  ``compile_count`` counts
  captures paid; warm dispatches pay none.
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
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import faults
from ..utils import metrics as _metrics
from ..utils import perf as _perf
from ..utils import trace as _trace
from . import kernels as _K
from .device import to_device_tensor
from .flat import QM_ROWS, fill_qm

#: bound on one path's pins (FIFO; each is one CUDA graph at one batch
#: tier): varying request-context shapes must not accumulate pins
PIN_MAX = 32


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
        }


class _Pin:
    """The flat program pinned at one (slots, tier, qctx shape) over one
    snapshot's storage: static input buffers (query matrix, clock,
    request-context tables), and on ``cuda`` the CUDA graph captured
    over them with its static output planes and a pinned host copy.
    Each replay overwrites the outputs: the path's lock covers a
    dispatch from filling the inputs to reading the outputs back."""

    def __init__(self, engine, fn, tier: int, qctx_np, qctx_shared) -> None:
        dev = engine.device
        self.fn = fn
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
        #: kernel launches per mode inside the capture (LAUNCHES keys)
        self.modes: Dict[str, int] = {}
        self.ready = False

    def args(self, dsnap):
        return (dsnap.arrays, dsnap.tid_map, self.now, self.qm, self.qctx,
                dsnap.specs)

    def capture(self, dsnap, pool) -> None:
        """Capture the program into a CUDA graph (``cuda``) whose memory
        comes from ``pool``; on ``cpu`` the pin runs the eager program.
        The inputs hold the first batch: one eager run on a side stream
        builds the kernels and the device constants (engine/consts.py),
        then the capture records the program on that stream.  Unlike the
        ``torch.cuda.graph`` context, this neither synchronises the device
        nor empties the allocator's cache, which eager batches would pay
        for afterwards.  Capture errors raise, and leave the allocator as
        they found it: a capture that fails ends in ``capture_end``'s
        error before it stops allocating from ``pool``, so that is done
        here, and the caller drops the pool (``LatencyPath._capture``)."""
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
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            err = None
            try:
                d, p, ovf = self.fn(*args)
                out = torch.stack([d, p, ovf])
            except BaseException as e:  # the program's error is the one to see
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
        self.graph, self.out = graph, out
        self.host = torch.empty(out.shape, dtype=torch.bool, pin_memory=True)
        self.ready = True

    def run(self, dsnap) -> torch.Tensor:
        """The [3, tier] planes of the inputs as filled: the replayed
        graph's static outputs on ``cuda``, the eager program's on
        ``cpu``."""
        if self.graph is not None:
            self.graph.replay()
            return self.out
        with torch.no_grad():
            d, p, ovf = self.fn(*self.args(dsnap))
        return torch.stack([d, p, ovf])


class LatencyPath:
    """Warm small-batch dispatcher for one DeviceSnapshot.

    Obtained via ``DeviceEngine.latency_path(dsnap)`` (one per prepared
    snapshot, holding that snapshot's pins)."""

    def __init__(self, engine, dsnap, registry: Optional[Any] = None) -> None:
        self.engine = engine
        self.dsnap = dsnap
        self._m = registry or _metrics.default
        #: covers a dispatch from staging to readback: the staging
        #: buffers, the pins' static buffers and their outputs
        self._lock = threading.Lock()
        #: (slots, tier, qctx_key) -> _Pin
        self._local: Dict[Tuple, _Pin] = {}
        #: tier -> (host int32[QM_ROWS, tier] staging tensor, its numpy view)
        self._qm_bufs: Dict[int, Tuple[torch.Tensor, np.ndarray]] = {}
        #: captures this path paid for: the no-recapture assertion's
        #: subject
        self.compile_count = 0
        #: dispatches this path actually SERVED (not fallbacks): the
        #: client reads it around a dispatch to learn whether a
        #: latency-mode call really ran here (the breaker's half-open
        #: probe must not close on a silent batch fallback)
        self.dispatch_count = 0
        #: the memory pool of this path's graphs (``cuda``; made on the
        #: first capture).  One pool is safe: the path's lock keeps its
        #: replays from overlapping
        self._pool = None
        #: (slots, tier, qctx_key) keys this path has SERVED warm: a fresh
        #: capture for one of them means its pin was lost (FIFO
        #: eviction) and is being paid for at serving time
        self._served_keys: set = set()
        self.last_budget: Optional[DispatchBudget] = None
        #: lazily computed gathered-bytes/check of this snapshot (the perf
        #: ledger's meta model), for sampled dispatch spans
        self._bpc_cache: Optional[float] = None

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
        """Witness extraction on latency dispatches: the witness plane of
        the flat program is not ported yet (ROADMAP queue 1 item 6)."""
        if on:
            raise NotImplementedError(
                "the witness plane (make_flat_fn(witness=True)) is a later"
                " slice of the port")

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

    def _pinned_for(self, slots, tier, qctx_key, qctx):
        """The pin for this (slots, tier, qctx shape), or a new one
        (captured by the caller on its first run).  Returns (pin, fresh,
        key)."""
        key = (slots, tier, qctx_key)
        pin = self._local.get(key)
        if pin is not None:
            return pin, False, key
        eng = self.engine
        fn = eng._flat_fn_for(slots, self.dsnap.flat_meta)
        shared = eng._qctx_device(qctx) if qctx_key[0] == "empty" else None
        pin = _Pin(eng, fn, tier, qctx, shared)
        self.compile_count += 1
        self._m.inc("latency.compiles")
        _perf.record_cost("latency_pin", f"tier={tier};slots={slots}",
                          self._m, tier=int(tier), slots=len(slots))
        self._local[key] = pin
        while len(self._local) > PIN_MAX:
            self._local.pop(next(iter(self._local)))
        return pin, True, key

    def _capture(self, pin, key) -> None:
        """Capture ``pin``; a pin whose capture failed is dropped with the
        path's pool, so the next dispatch of its key captures anew into a
        fresh pool (and raises again if the fault persists) instead of
        replaying a broken graph."""
        if self._pool is None and self.engine.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        try:
            pin.capture(self.dsnap, self._pool)
        except BaseException:
            self._local.pop(key, None)
            self._pool = None  # the next capture starts a pool of its own
            raise

    def _qm_buf(self, tier: int) -> Tuple[torch.Tensor, np.ndarray]:
        buf = self._qm_bufs.get(tier)
        if buf is None:
            t = torch.empty((QM_ROWS, tier), dtype=torch.int32,
                            pin_memory=self.engine.device.type == "cuda")
            buf = self._qm_bufs[tier] = (t, t.numpy())
        return buf

    def pins(self) -> Dict[Tuple, _Pin]:
        """This path's pins by (slots, tier, qctx_key)."""
        return dict(self._local)

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
        # one lock from staging to readback: every caller of the path
        # shares its staging buffers and its pins' inputs and outputs
        with self._lock:
            stage_t, stage_np = self._qm_buf(tier)
            fill_qm(queries, stage_np, meta)
            qctx_key = self._qctx_key(qctx)
            pin, fresh, pin_key = self._pinned_for(slots, tier, qctx_key, qctx)
            t1 = time.perf_counter()

            # ---- stage 2: H2D (staging matrix, clock, contexts) ---------
            pin.qm.copy_(stage_t, non_blocking=True)
            pin.now.fill_(int(now))
            if pin.qctx_static:
                for k, v in qctx.items():
                    pin.qctx[k].copy_(torch.from_numpy(
                        np.ascontiguousarray(v)).view(pin.qctx[k].dtype),
                        non_blocking=True)
            if cuda:
                sync()
            t2 = time.perf_counter()

            # ---- stage 3: the pinned program (replay) -------------------
            if fresh and pin_key in self._served_keys:
                # this shape was served warm before: its pin was lost
                self._m.inc("latency.retraces")
                _trace.trigger_incident(
                    "latency.retrace", tier=tier, batch=B, slots=len(slots),
                )
            with _trace.annotate_dispatch(span):
                if not pin.ready:
                    self._capture(pin, pin_key)
                out = pin.run(self.dsnap)
            if cuda:
                sync()
            t3 = time.perf_counter()

            # ---- stage 4: D2H readback -----------------------------------
            if cuda:
                pin.host.copy_(out, non_blocking=True)
                sync()
                got = pin.host.numpy()[:, :B].copy()
            else:
                got = out[:, :B].numpy().copy()
            t4 = time.perf_counter()

        budget = DispatchBudget(
            batch=B, tier=tier,
            host_lower_s=t1 - t0, h2d_s=t2 - t1,
            kernel_s=t3 - t2, d2h_s=t4 - t3,
            total_s=t4 - t0, compiled=fresh,
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
            # dispatches (the first after each write, on a Watch-fed
            # service) are published on their own
            m.observe("latency.cold_dispatch_s", budget.total_s)
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
