"""Time the bulk Check of configs 2, 3 and 4 through one checkout's port.

Run on a machine with an NVIDIA card and nvcc, as a script (not with
``-m``, so that the package comes from ``--root``):

    python3 gochugaru_tpu_torch/tools/ab_main_path.py --root DIR \\
        [--scale3 S] [--edges4 N] [--reps N]

``DIR`` is the root of a checkout (this one, or another commit's unpacked
with ``git archive``).  The script imports ``gochugaru_tpu_torch`` and
``chip_smoke.py`` from there, builds both kernels from its sources, builds
config 2 (full size), config 3 at ``--scale3`` and config 4 at ``--edges4``
edges with the smoke's own generators (seeds 11, 23, 31), prepares each with
the kernels, and times ``check_columns`` of its 100,000-check batch
(config 4 with its request contexts): two warm calls, then ``--reps``
calls.  Host clock, each call synchronised by its fetch.  Prints the card
line, then one JSON object: the root, and per config the batch seconds
and checks/s of the median call.

To compare two commits, run parent, change, change, parent in one call
on one card and read the medians side by side.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose port is timed")
    ap.add_argument("--scale3", type=float, default=0.25)
    ap.add_argument("--edges4", type=int, default=2_000_000)
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_main_path: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.kernels.build import build_all
    from gochugaru_tpu_torch.engine.plan import EngineConfig

    build_all(["fused_probe", "fused_probe_aligned"])
    card = smoke.card_line()
    print(card, flush=True)

    def time_world(cs, snap, q, ctx=None):
        ek = DeviceEngine(cs, EngineConfig(kernels=True), device="cuda")
        ds = ek.prepare(snap)
        kw = dict(now_us=smoke.EPOCH)
        if ctx is not None:
            kw.update(q_ctx=ctx[0], qctx_rows=ctx[1])
        times = []
        for i in range(2 + args.reps):
            t0 = time.perf_counter()
            ek.check_columns(ds, *q, **kw)
            if i >= 2:
                times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        return dict(batch=int(q[0].shape[0]), batch_s=times, median_s=med,
                    checks_per_s=q[0].shape[0] / med)

    out = {"root": args.root, "card": card}
    cs, snap, q, _names = smoke.build_rbac()
    out["config2"] = time_world(cs, snap, q)
    cs, snap, q, _names = smoke.build_docs(args.scale3)
    out[f"config3 scale {args.scale3}"] = time_world(cs, snap, q)
    del snap
    cs, snap, q, _names, ctx = smoke.build_config4(args.edges4)
    out[f"config4 {args.edges4} edges"] = time_world(cs, snap, q, ctx)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
