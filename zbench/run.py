"""Run one cell of the benchmark once and print one JSON line.

    python -m zbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (the world from the seed, the store
import, the first prepare on the card, the cell's own warm-up) runs before
the window; the window runs the cell's traffic for ``--seconds``; then the
answers the window produced are compared with the plain reference.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py`` from the
program's counters over the window and a profiler trace of a few seconds of
the same traffic after it.

Exits non-zero and prints no result without enough CUDA devices, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that must never be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "gochugaru_tpu")
#: a run that has not ended by then prints every thread's stack and exits
#: non-zero, inside the 360 s a run is allowed
WATCHDOG_S = 345


class Run:
    """What one run of a cell knows, for the metric readers."""

    def __init__(self, bench, workload, config, traffic, seed, seconds, trace, device):
        self.bench, self.workload, self.config, self.traffic = bench, workload, config, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.rate = traffic.get("rate_checks_per_s")
        self.kind = traffic["kind"]
        self.world = None
        self.setup_s = None
        self.prepare_s = None
        self.counters = {}
        self.trace_summary = None
        self.trace_window = None
        self.traced_seconds = None
        #: (measured window's rate, traced window's rate, unit): the cost of tracing
        self.traced_rate = None
        self.attempted = self.failed = 0


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    for w in bench["workloads"]:
        if w["name"] == name:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, load_json(ROOT / cfg["file"]), load_json(HERE / "traffic" / f"{w['traffic']}.json")
    raise SystemExit(f"zbench: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, section: str, workload: str):
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def read_metric(name: str, run: Run):
    spec = importlib.util.spec_from_file_location(f"zbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own CUDA build directory is ``gochugaru_tpu_torch/_build``)."""
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_window(run: Run, cell, tracer) -> None:
    """Set-up ends here.  The measured window runs ``run.seconds`` with no
    profiler; with a tracer, a traced window of the same traffic follows it
    (``TRACE_S``), so that the profiler's cost moves none of the
    measured window's numbers.  Every thread of the traffic has ended when
    this returns."""
    from gochugaru_tpu_torch.utils import metrics

    from .trace import TRACE_S

    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's generations
    before = metrics.default.snapshot()
    t0 = time.perf_counter()
    if run.setup_s is None:
        run.setup_s = t0 - T_START
    t1 = t0 + run.seconds
    cell.start(t0, t1)
    time.sleep(max(0.0, t1 - time.perf_counter()))
    cell.join()
    run.window = (t0, t1)
    after = metrics.default.snapshot()
    run.counters = {k: v - before.get(k, 0.0) for k, v in after.items()
                    if isinstance(v, (int, float))}
    if tracer.enabled:
        tracer.start()
        t2 = time.perf_counter()
        t3 = t2 + min(TRACE_S, run.seconds)
        run.traced_seconds = t3 - t2
        cell.start(t2, t3, traced=True)
        time.sleep(max(0.0, t3 - time.perf_counter()))
        cell.join()
        tracer.stop()
        run.trace_window = (tracer.t0, tracer.t1)
    gc.unfreeze()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    bench = load_json(ROOT / "BENCHMARK.json")
    workload, config, traffic = find_cell(bench, args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"zbench: {workload['name']} needs {workload['chips']} CUDA device(s);"
              f" found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    run = Run(bench, workload, config, traffic, args.seed, args.seconds,
              bool(args.trace), "cuda")
    return execute(run)


def execute(run: Run) -> int:
    """Set-up, window, comparison and the result line of one run."""
    from .trace import Tracer
    from .world import generate

    t_world = time.perf_counter()
    run.world = generate(run.config, run.seed)
    t_setup = time.perf_counter()
    kind = importlib.import_module(f"zbench.kinds.{run.kind}")
    cell = kind.Cell(run)
    cell.setup()
    tracer = Tracer(run.trace and run.device != "cpu")
    tracer.warm()
    t_end = time.perf_counter()
    imported = getattr(cell.sys, "import_s", 0.0)
    print(f"zbench: setup stages: start {t_world - T_START:.3f} s, world {t_setup - t_world:.3f} s,"
          f" store import {imported:.3f} s, prepare {run.prepare_s:.3f} s, warm-up"
          f" {t_end - t_setup - imported - run.prepare_s:.3f} s", file=sys.stderr)
    run_window(run, cell, tracer)
    if hasattr(cell, "close"):
        cell.close()
    cell.record(run)
    device = device_info(run)
    run.trace_summary = tracer.summary()

    reference = importlib.import_module(f"zbench.reference.{run.config['reference']}").Reference(run.world)
    found = cell.verify(reference)
    bad = forbidden_modules()
    if bad:
        print(f"zbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for e in getattr(cell, "errors", [])[:5]:
        print(f"zbench: error in the window: {e}", file=sys.stderr)

    section = "per_layer" if run.trace else "end_to_end"
    out = {}
    for m in metrics_of(run.bench, section, run.workload["name"]):
        v = read_metric(m["name"], run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = {"mismatches": 0, "unanswered": 0}
    compared = {k: {"value": found[k], "limit": limits[k]} for k in limits}
    counted = {k: v for k, v in found.items() if k not in limits}
    correct = (all(c["value"] <= c["limit"] for c in compared.values())
               and all(v > 0 for v in counted.values()))
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": out, "device": device}
    if run.trace_summary is not None:
        ts = run.trace_summary
        device["busy_s"], device["window_s"] = ts["busy_s"], ts["window_s"]
        result["breakdown"] = {"device_ops": ts["device_ops"], "idle_gaps": ts["idle_gaps"]}
        print(f"zbench: card {power_limit()}", file=sys.stderr)
        if run.traced_rate is not None:
            m, t, unit = run.traced_rate
            print(f"zbench: traced window {t:.1f} {unit} against the measured window's"
                  f" {m:.1f}", file=sys.stderr)
    result["compared"] = dict(compared, **{k: {"value": v, "limit": "> 0"} for k, v in counted.items()})
    for k, c in result["compared"].items():
        print(f"zbench: {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def device_info(run: Run) -> dict:
    import torch

    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.workload["chips"],
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


if __name__ == "__main__":
    sys.exit(main())
