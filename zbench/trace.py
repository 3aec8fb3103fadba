"""The traced run's device timeline: a ``torch.profiler`` profile of a
window of the cell's traffic that follows the measured one, read back from
its Chrome trace.

From the trace: the seconds in which any device operation ran (the union of
kernel, memcpy and memset intervals, a frozen copy of ``chip_smoke.py``'s
``ops_union``), the traced window's length, the device operations by name,
the probe kernels' time, and the longest idle gaps labelled by what the
host was doing then.  The profiler records host operations only on the
thread that started it, so the host side comes from a sampler of the
traffic threads' Python stacks (every ``SAMPLE_S``, the innermost frame of
the program, as ``file:function``), placed on the trace's clock through the
window's own range.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

#: the port's probe kernels, by the names their launches carry
PROBE_KERNELS = ("gochugaru_slot_tile_kernel", "gochugaru_warp_reduce_kernel",
                 "fused_runs_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "zbench.window"
#: seconds of the traced window
TRACE_S = 4.0
SAMPLE_S = 0.01


class StackSampler:
    """What each traffic thread runs, every SAMPLE_S: (perf_counter time,
    label of its innermost frame in the program, else in the harness)."""

    def __init__(self) -> None:
        self.samples: List[Tuple[float, str]] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="zbench-sampler", daemon=True)

    @staticmethod
    def _label(frame) -> Optional[str]:
        first = None
        while frame is not None:
            f = frame.f_code.co_filename
            if "gochugaru_tpu_torch" in f:
                return f"{os.path.basename(f)}:{frame.f_code.co_name}"
            if first is None and "zbench" in f:
                first = f"{os.path.basename(f)}:{frame.f_code.co_name}"
            frame = frame.f_back
        return first

    def _run(self) -> None:
        me = threading.get_ident()
        main = threading.main_thread().ident
        while not self._stop.is_set():
            now = time.perf_counter()
            for ident, frame in sys._current_frames().items():
                if ident in (me, main):
                    continue
                label = self._label(frame)
                if label is not None:
                    self.samples.append((now, label))
            del frame
            time.sleep(SAMPLE_S)

    def start(self) -> None:
        self._t.start()

    def stop(self) -> None:
        self._stop.set()
        self._t.join()


def ops_union(intervals, lo, hi):
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class Tracer:
    """Profiles [start, stop] of a run when enabled; a no-op otherwise."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = None
        self._ann = None
        self.sampler = None

    def warm(self) -> None:
        """One tiny profile in set-up, so the profiler's own start-up
        (CUPTI) is not inside the traced window."""
        if not self.enabled:
            return
        import torch

        with torch.profiler.profile(activities=self._activities()):
            torch.ones(8, device="cuda").sum().item()

    @staticmethod
    def _activities():
        import torch

        return [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def start(self) -> None:
        if not self.enabled:
            return
        import torch

        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self._ann = torch.profiler.record_function(WINDOW)
        self._ann.__enter__()
        self.t0 = time.perf_counter()
        self.sampler = StackSampler()
        self.sampler.start()

    def stop(self) -> None:
        if not self.enabled or self.prof is None or self.t1 is not None:
            return
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._ann.__exit__(None, None, None)
        self.prof.stop()
        self.sampler.stop()

    def summary(self) -> Optional[dict]:
        """The traced window's numbers (None when not traced)."""
        if not self.enabled or self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="zbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        finally:
            os.unlink(path)
        return summarize(events, self.sampler.samples, self.t0)


def summarize(events: List[dict], samples=(), t0: float = 0.0) -> dict:
    win = [e for e in events if e.get("name") == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"trace: {len(win)} {WINDOW} ranges")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev]
    ops: Dict[str, List[float]] = {}
    probe_n, probe_us = 0, 0.0
    for e in dev:
        name = e["name"][:120]
        c = ops.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += float(e.get("dur", 0))
        if e.get("cat") == "kernel" and any(k in e["name"] for k in PROBE_KERNELS):
            probe_n += 1
            probe_us += float(e.get("dur", 0))
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    # host samples on the trace's clock (microseconds), the window's start
    # taken as the same instant on both clocks
    host = [(w0 + (t - t0) * 1e6, label) for t, label in samples]
    return dict(
        window_s=(w1 - w0) / 1e6,
        busy_s=ops_union(iv, w0, w1) / 1e6,
        n_ops=len(dev),
        probe_n=probe_n,
        probe_s=probe_us / 1e6,
        device_ops=[[n, t / 1e6] for n, (_, t) in top],
        idle_gaps=idle_gaps(iv, host, w0, w1),
    )


def idle_gaps(iv: List[Tuple[float, float]], host: List[Tuple[float, str]], w0: float,
              w1: float, top: int = 10) -> List[list]:
    """The ``top`` longest stretches of [w0, w1] with no device operation,
    each named by what the host threads ran most in it (the nearest sample
    for a gap shorter than the sampling step)."""
    gaps, end = [], w0
    for s, e in sorted(iv):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted(host)
    out = []
    for a, b in gaps:
        inside = collections.Counter(label for t, label in host if a <= t <= b)
        if inside:
            label = "host " + inside.most_common(1)[0][0]
        elif host:
            mid = (a + b) / 2
            label = "host " + min(host, key=lambda h: abs(h[0] - mid))[1]
        else:
            label = "no host sample"
        out.append([label, (b - a) / 1e6])
    return out
