"""Offline tuning pass, end to end, as an operator would run it.

Builds a small RBAC world, drives a short mixed load (many small
interactive submissions + a few bulk CheckMany + a duplicate-heavy
round) through a serving handle under the DEFAULT config, captures one
telemetry snapshot (gochugaru_tpu_torch/tune/snapshot.py), and prints
the tuner's proposed EngineConfig/ServeConfig diff with per-knob
measured evidence and predicted deltas.  The pack-spec rule needs a
counterfactual a live snapshot cannot see, so the script also runs the
dual-prepare A/B (flat_packed on vs off over the same store snapshot)
and feeds both gathered-bytes models in as ``packed_candidates``.  Then
it re-proposes against the tuned target over the same snapshot and
prints the knobs proposed again (none at a fixed point).

Usage:
    python -m gochugaru_tpu_torch.scripts.tune            # human-readable
    python -m gochugaru_tpu_torch.scripts.tune --json     # diff as JSON
    python -m gochugaru_tpu_torch.scripts.tune --online 6 # + controller demo
    python -m gochugaru_tpu_torch.scripts.tune --device cpu

``--online N`` additionally attaches the OnlineController to the live
handle and drives N control ticks under continued load, printing each
applied move and the final status — the bounded-step/cooldown/revert
behavior tests/test_torch_tune.py pins down, on real traffic.  Every
line but the JSON diff starts with ``#``.
"""

import argparse
import json
import time

from . import add_device_arg, require_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repos", type=int, default=400)
    ap.add_argument("--users", type=int, default=160)
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="load window under the default config")
    ap.add_argument("--rate", type=float, default=120.0,
                    help="interactive submissions/s")
    ap.add_argument("--json", action="store_true",
                    help="print the diff as JSON instead of prose")
    ap.add_argument("--online", type=int, default=0, metavar="N",
                    help="after the offline pass, run N online-controller"
                         " ticks under continued load")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    require_device(args.device)

    import numpy as np

    from .. import consistency, rel
    from ..client import new_evaluator, with_latency_mode
    from ..engine.device import DeviceEngine
    from ..engine.plan import EngineConfig
    from ..serve import ServeConfig
    from ..tune import (
        OnlineController,
        TuneTarget,
        apply_diff,
        collect_snapshot,
        propose,
    )
    from ..utils import metrics, perf
    from ..utils.context import background

    m = metrics.default
    rng = np.random.default_rng(18)
    ctx = background()
    c = new_evaluator(with_latency_mode(), device=args.device)
    c.write_schema(ctx, """
    definition user {}
    definition org { relation admin: user  relation member: user }
    definition repo {
        relation org: org
        relation reader: user
        permission admin = org->admin
        permission read = reader + admin + org->member
    }
    """)
    txn = rel.Txn()
    for i in range(args.repos):
        txn.touch(rel.must_from_triple(
            f"repo:r{i}", "reader", f"user:u{int(rng.integers(args.users))}"))
        txn.touch(rel.must_from_triple(f"repo:r{i}", "org", f"org:o{i % 6}"))
    for o in range(6):
        txn.touch(rel.must_from_triple(f"org:o{o}", "admin", f"user:u{o}"))
        for j in range(8):
            txn.touch(rel.must_from_triple(
                f"org:o{o}", "member", f"user:u{(o * 8 + j) % args.users}"))
    c.write(ctx, txn)
    cs = consistency.min_latency()
    store_snap = c.store.snapshot_for(consistency.full())
    inter = store_snap.interner
    slot = store_snap.compiled.slot_of_name

    POOL = 4096
    pool_res = np.array(
        [inter.node("repo", f"r{int(i)}")
         for i in rng.integers(0, args.repos, POOL)], np.int32)
    pool_subj = np.array(
        [inter.node("user", f"u{int((u - 1) % args.users)}")
         for u in rng.zipf(1.2, POOL)], np.int32)
    pool_perm = np.where(
        rng.random(POOL) < 0.9, slot["read"], slot["admin"]).astype(np.int32)

    ecfg = c._engine_config or EngineConfig()
    scfg = ServeConfig()
    h = c.with_serving(cs=cs, config=scfg, cache=True)

    def drive(seconds):
        """Mixed open-loop load: interactive 9-check submissions at
        --rate with an occasional 300-check bulk, plus a duplicate-
        heavy burst (the dedup rule's signal)."""
        futs = []
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            s = int(rng.integers(0, POOL - 300))
            n = 300 if k % 25 == 24 else 9
            futs.append(h.submit_columns(
                ctx, pool_res[s:s + n], pool_perm[s:s + n],
                pool_subj[s:s + n], client_id=k % 4))
            if k % 10 == 0:  # duplicate burst: same slice, twice
                futs.append(h.submit_columns(
                    ctx, pool_res[s:s + 9], pool_perm[s:s + 9],
                    pool_subj[s:s + 9], client_id=(k + 1) % 4))
            k += 1
            time.sleep(1.0 / args.rate)
        for f in futs:
            f.result(timeout=60.0)

    print(f"# driving {args.seconds:.0f}s of mixed load under the"
          f" default config (hold {scfg.hold_max_s * 1000:g}ms,"
          f" tiers {ecfg.latency_tiers}) on {c.device} ...", flush=True)
    # warm each tier pin sequentially so the load window measures
    # steady state, not first-dispatch captures
    for t in ecfg.latency_tiers:
        n = min(int(t), POOL - 1)
        h.submit_columns(ctx, pool_res[:n], pool_perm[:n],
                         pool_subj[:n]).result(timeout=120.0)
    drive(args.seconds)

    # dual-prepare A/B over the same snapshot: the pack-spec
    # counterfactual (bytes gathered per check under each layout)
    cands = {}
    for label, fp in (("packed", True), ("unpacked", False)):
        eng = DeviceEngine(
            store_snap.compiled,
            EngineConfig.for_schema(store_snap.compiled, flat_packed=fp),
            device=args.device,
        )
        ds = eng.prepare(store_snap)
        try:
            cands[label] = float(perf.gathered_bytes_model(ds).total)
        except Exception:
            cands = {}
            break
        if label == "unpacked":
            dsnap_for_bytes = ds

    snap = collect_snapshot(
        m,
        engine_config=ecfg,
        serve_config=h.batcher.config,
        vcache=c._vcache,
        cost=c._admission.cost,
        dsnap=dsnap_for_bytes if cands else None,
        packed_candidates=cands or None,
    )
    target = TuneTarget(
        engine=ecfg, serve=h.batcher.config,
        cache_bytes=int(c._vcache.max_bytes) if c._vcache else None,
    )
    diff = propose(snap, target)
    tuned = apply_diff(target, diff)

    if args.json:
        print(diff.to_json(indent=2))
    else:
        print("# tuner proposal (offline pass):")
        out = diff.render() if diff else "(no changes: measured config fits)"
        for line in out.splitlines():
            print("  " + line)
        print(f"# tuned target: tiers={tuned.engine.latency_tiers}"
              f" hold={tuned.serve.hold_max_s}s dedup={tuned.serve.dedup}"
              f" cache_bytes={tuned.cache_bytes}"
              f" placement={tuned.placement}")
    # the fixed point: the tuned target against the same snapshot
    # proposes none of the knobs just applied
    again = {k.knob for k in propose(snap, tuned).knobs}
    print("# fixed point: " + json.dumps({"re_proposed": sorted(
        again & {k.knob for k in diff.knobs})}), flush=True)

    if args.online > 0:
        print(f"# online controller: {args.online} ticks under live load")
        ctl = OnlineController(h.batcher, vcache=c._vcache, registry=m,
                               cooldown_steps=1)
        for tick in range(args.online):
            drive(max(0.5, args.seconds / 4))
            moved = ctl.step()
            st = ctl.status()
            print(f"#   tick {tick}: moves={moved}"
                  f" hold={st['hold_max_s']}s dedup={st['dedup']}"
                  f" frozen={st['frozen']}", flush=True)
        ctl.revert()
        st = ctl.status()
        print(f"# reverted to preset: hold={st['hold_max_s']}s"
              f" (moves total {st['moves']},"
              f" tune.reverts={int(m.counter('tune.reverts'))})")

    h.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
