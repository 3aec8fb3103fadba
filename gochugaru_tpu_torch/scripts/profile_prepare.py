"""Profile the cold-start prepare pipeline: cProfile + stage-timer dump
of a first prepare (import -> first check) at --edges (default 1M).

The cold-start path is import (columnar segments) -> materialize
(store/snapshot.py finish_snapshot) -> device prepare (store/closure.py
build_closure, engine/flat.py build_flat_arrays, H2D) -> first kernel
launch.  When it regresses, run this before re-deriving the pipeline by
hand:

    python -m gochugaru_tpu_torch.scripts.profile_prepare --edges 1000000
    python -m gochugaru_tpu_torch.scripts.profile_prepare --device cpu

prints the top --top cumulative-time frames of the first check plus the
``prepare.*`` stage timers (utils/metrics.py sample rings).
"""

import argparse
import cProfile
import io
import pstats
import time

from . import add_device_arg, require_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", type=int, default=1_000_000)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument(
        "--groups", type=int, default=0,
        help="add a group-nesting subgraph of this many membership edges "
        "(exercises the closure stage; default edges//100)",
    )
    add_device_arg(ap)
    args = ap.parse_args(argv)
    require_device(args.device)

    import numpy as np

    from .. import consistency, rel
    from ..client import Client
    from ..utils import background, metrics

    c = Client(device=args.device)
    ctx = background()
    c.write_schema(ctx, """
    definition user {}
    definition team {
        relation member: user | team#member
    }
    definition doc {
        relation reader: user | team#member
        permission view = reader
    }
    """)

    n_docs = max(args.edges // 10, 1000)
    n_users = args.edges // n_docs + 1
    itn = c._store.interner
    ires = itn.node_batch("doc", [f"d{i}" for i in range(n_docs)])
    isub = itn.node_batch("user", [f"u{i}" for i in range(n_users)])
    res_ids = np.tile(ires, args.edges // n_docs + 1)[: args.edges]
    subj_ids = np.repeat(isub, n_docs)[: args.edges]

    t0 = time.perf_counter()
    c.import_relationship_id_columns(
        ctx, resource_ids=res_ids, resource_relation="reader",
        subject_ids=subj_ids,
    )
    n_groups = args.groups or max(args.edges // 100, 10)
    if n_groups:
        # a team tree plus team->doc grants: the closure/T-index stages
        # are a no-op without a membership subgraph
        iteams = itn.node_batch("team", [f"t{i}" for i in range(n_groups)])
        # binary-tree nesting (depth log2 n): child team i is a member of
        # team (i-1)//2, so the closure converges in ~log rounds
        ch = np.arange(1, n_groups, dtype=np.int64)
        it64 = np.asarray(iteams, np.int64)
        c.import_relationship_id_columns(
            ctx, resource_ids=it64[(ch - 1) // 2], resource_relation="member",
            subject_ids=it64[ch], subject_relation="member",
        )
        c.import_relationship_id_columns(
            ctx,
            resource_ids=np.asarray(ires[: min(n_groups, len(ires))], np.int64),
            resource_relation="reader",
            subject_ids=np.asarray(iteams[: min(n_groups, len(ires))], np.int64),
            subject_relation="member",
        )
        c.import_relationship_id_columns(
            ctx, resource_ids=np.asarray(iteams, np.int64),
            resource_relation="member",
            subject_ids=np.asarray(isub[:1], np.int64).repeat(len(iteams)),
        )
    print(f"# import: {time.perf_counter() - t0:.2f}s "
          f"({args.edges:,} edges + {3 * n_groups:,} membership rows)")

    metrics.default.reset()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    ok = c.check_one(
        ctx, consistency.full(),
        rel.must_from_triple("doc:d0", "view", "user:u0"),
    )
    pr.disable()
    wall = time.perf_counter() - t0
    assert ok
    print(f"# first check after import: {wall:.2f}s on {c.device}")

    snap = metrics.default.snapshot()
    stages = sorted(
        k for k in snap if k.startswith("prepare.") and k.endswith(".total_s")
    )
    print("# stage timers (prepare.*):")
    for k in stages:
        print(f"#   {k[:-8]:28s} {snap[k]:8.3f}s")

    buf = io.StringIO()
    st = pstats.Stats(pr, stream=buf)
    st.sort_stats("cumulative").print_stats(args.top)
    print(buf.getvalue())


if __name__ == "__main__":
    main()
