"""Find the knee of a served cell: the highest offered rate that the system
holds without a growing backlog.

    python -m zbench.sweep --workload rbac-github.interactive --seed <n> \
        --seconds 5 --rates 200000,400000,800000

The workload is ``<config>.<traffic>``, found by its files
(``configs/<config>.json``, ``traffic/<traffic>.json``), listed in
``BENCHMARK.json`` or not.

One process, one set-up; then one open-loop window a rate, in the order
given, each with arrivals of its own from the seed.  Each step prints one
JSON line: the offered and served checks/s, the p50/p95/p99 ms from due
time, the shed and failed requests, and the backlog's growth, the p50 of
the window's last quarter of requests over its first quarter's.  A step
holds when it served at least 97% of the offered rate, shed and failed
nothing, and its backlog grew less than 1.5-fold; the last line names the
highest rate that held.  The cell's traffic file keeps the result; a run of
the benchmark never sweeps.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np

from . import run as R
from . import stats
from . import traffic as T
from .trace import Tracer


def step(cell, run, rate: float, seconds: float, stream: int) -> dict:
    cell.plan(rate, seconds, stream)
    run.seconds = seconds
    R.run_window(run, cell, Tracer(False))
    w = cell.windows[-1]
    lat = w.lat
    n = cell.tr["checks_per_request"]
    answered = int(np.isfinite(lat).sum())
    q = max(1, lat.shape[0] // 4)
    first = stats.percentile(lat[:q].tolist(), 50)
    last = stats.percentile(lat[-q:].tolist(), 50)
    growth = (last / first) if first and np.isfinite(last) else float("inf")
    row = dict(offered=rate, served=answered * n / seconds,
               p50_ms=stats.finite_or(stats.percentile(lat.tolist(), 50), 1e9),
               p95_ms=stats.finite_or(stats.percentile(lat.tolist(), 95), 1e9),
               p99_ms=stats.finite_or(stats.percentile(lat.tolist(), 99), 1e9),
               shed=w.shed, failed=int(lat.shape[0] - answered),
               backlog_growth=stats.finite_or(growth, 1e9))
    row["holds"] = bool(row["served"] >= 0.97 * rate and not w.shed
                        and row["failed"] == 0 and growth < 1.5)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True, help="offered checks/s, comma-separated")
    args = ap.parse_args(argv)
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    # by file name, so that a served mix kept for a later cell can be swept
    config_name, mix = args.workload.split(".", 1)
    workload = {"name": args.workload, "config": config_name, "traffic": mix, "chips": 1}
    config = R.load_json(R.HERE / "configs" / f"{config_name}.json")
    traffic = R.load_json(R.HERE / "traffic" / f"{mix}.json")
    if traffic["kind"] != "serve":
        raise SystemExit("zbench.sweep: the cell's traffic is not served")
    R.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("zbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    from .world import generate

    run = R.Run(bench, workload, config, traffic, args.seed, args.seconds, False, "cuda")
    run.world = generate(config, args.seed)
    cell = importlib.import_module(f"zbench.kinds.{traffic['kind']}").Cell(run)
    cell.setup()
    knee = None
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        row = step(cell, run, rate, args.seconds, T.STREAM_ARRIVALS + 100 + i)
        print(json.dumps(row), flush=True)
        if row["holds"]:
            knee = rate if knee is None else max(knee, rate)
    cell.close()
    print(json.dumps({"knee_checks_per_s": knee,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
