"""The control of a cell's comparison: the plain reference with one of its
configuration's guarantees broken (``Reference(world, control=True)``: no
nested group or team subject sets) put in the program's place, and judged
by the same comparison a run makes, on the same items at the cell's size.
It has to come out not correct.  A run of the benchmark never runs it.

    python -m zbench.control --workload <cell> --seeds <n>,<n>,<n>

One JSON line a seed: the numbers the comparison counts (``mismatches``
against the limit 0) and the items compared.  Needs no card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np

from . import run as R
from .world import generate

#: about the lookups one window of ``docs-nested.lookup`` issues
LOOKUPS_A_WINDOW = 256


def control_once(bench, workload, config, traffic, seed: int) -> dict:
    run = R.Run(bench, workload, config, traffic, seed, float(bench["run_seconds"]), False, "cpu")
    run.world = generate(config, seed)
    ref_mod = importlib.import_module(f"zbench.reference.{config['reference']}")
    sound = ref_mod.Reference(run.world)
    control = ref_mod.Reference(run.world, control=True)
    cell = importlib.import_module(f"zbench.kinds.{traffic['kind']}").Cell(run)
    cell.draw()
    kind = traffic["kind"]
    if kind == "bulk":
        got = [cell.expected(control, b) for b in range(traffic["sample_batches"])]
        want = [cell.expected(sound, b) for b in range(traffic["sample_batches"])]
        got, want = np.concatenate(got), np.concatenate(want)
        return {"mismatches": int((got != want).sum()), "checks_compared": int(got.shape[0])}
    if kind == "serve":
        cell.plan(run.rate, run.seconds)
        w = cell.next
        req = sorted(w.sample)
        got, want = cell.expected(control, w, req), cell.expected(sound, w, req)
        return {"mismatches": int((got != want).sum()), "checks_compared": int(got.shape[0])}
    if kind == "lookup":
        # the requests a window sends first, of them those the run keeps
        ks = [k for k in range(min(LOOKUPS_A_WINDOW, cell.kinds.shape[0])) if cell.keep[k]]
        mism = sum(int(cell.expected(control, k) != cell.expected(sound, k)) for k in ks)
        return {"mismatches": mism, "lookups_compared": len(ks)}
    raise ValueError(f"control: unknown traffic kind {kind!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    workload, config, traffic = R.find_cell(bench, args.workload)
    for s in args.seeds.split(","):
        row = control_once(bench, workload, config, traffic, int(s))
        print(json.dumps(dict(workload=args.workload, seed=int(s), limit=0, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
