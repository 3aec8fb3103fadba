"""Multi-process deployment: ``torch.distributed`` startup, a global mesh
spanning processes, and the multi-process dryrun that proves the
bucket-sharded tables and their collectives work across process
boundaries.

Deployment shape:

- one process per host; each calls :func:`initialize` (the coordinator
  is process 0), then builds the SAME snapshot from its replicated store
  feed, or only its owned shards' share of it (engine/partition.py
  ``partition_feed(owned=owned_model_shards(mesh))``);
- the mesh ``(data, model)`` from :func:`global_mesh` lays positions out
  process-major, so with ``data`` a multiple of the process count each
  data row's model group stays within one process and its collectives
  are the in-process ones (parallel/collectives.py); a model row that
  spans processes reduces across them over a ``torch.distributed`` group
  of exactly its processes, one call a collective;
- each process drives only its own positions, and a dispatch returns
  the planes of the data rows it holds (``fetch=False``,
  ``ShardedEngine.last_local_rows``): no result crosses processes.

The backend is gloo.  Several processes may stand on one card (every
position of the dryrun on the card is ``cuda:0``), and NCCL refuses two
ranks on one device; gloo reduces host tensors, so a cross-process
collective stages through host memory.

``python -m gochugaru_tpu_torch.parallel.multihost`` is the dryrun's
worker; :func:`dryrun_multihost` spawns N of them with a fresh
coordinator port, and each verifies the rows it holds against the host
oracle.  ``--rss`` runs :func:`rss_dryrun`, the host-memory measurement
of the partitioned feed.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

NOW_US = 1_700_000_000_000_000

SCHEMA = """
definition user {}
definition team { relation member: user }
definition org {
    relation admin: user
    relation member: user | team#member
}
definition repo {
    relation org: org
    relation maintainer: user | team#member
    relation reader: user
    permission admin = org->admin + maintainer
    permission read = reader + admin + org->member
}
"""

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``torch.distributed.init_process_group`` (gloo) with environment
    defaults (GOCHUGARU_COORDINATOR ``host:port``,
    GOCHUGARU_NUM_PROCESSES, GOCHUGARU_PROCESS_ID); call once per
    process.  With one process (no environment, no arguments) it does
    nothing, so one entry point serves both deployments."""
    coordinator_address = coordinator_address or os.environ.get(
        "GOCHUGARU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("GOCHUGARU_NUM_PROCESSES") or "1")
    if process_id is None:
        process_id = int(os.environ.get("GOCHUGARU_PROCESS_ID") or "0")
    if num_processes <= 1:
        return
    if not coordinator_address:
        # fail fast: each host running as its own one-process world would
        # surface only later, as a mesh of the wrong size
        raise ValueError(
            "multi-process init requires a coordinator address "
            "(GOCHUGARU_COORDINATOR) when GOCHUGARU_NUM_PROCESSES > 1")
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _world_size_rank():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(data: int, model: int, devices: Optional[Sequence] = None):
    """A (data × model) mesh over every process's positions,
    process-major: process p holds the flat positions (r·model + j) that
    follow those of processes 0..p-1.  ``devices`` lists THIS process's
    positions (a device may repeat: ``[cuda:0] * 2`` is two positions on
    one card); by default every CUDA card, and none raises.  Every
    process must call it with the same shape: it exchanges the position
    counts and creates one group per data row that spans processes (in
    the same order everywhere, as ``torch.distributed.new_group``
    needs)."""
    import torch

    from .mesh import Mesh, make_mesh

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("no CUDA device: pass this process's devices")
    local = [torch.device(d) for d in devices]
    world, rank = _world_size_rank()
    if world == 1:
        return make_mesh(data, model, devices=local)
    import torch.distributed as dist

    counts: List[int] = [0] * world
    dist.all_gather_object(counts, len(local))
    need = data * model
    if sum(counts) != need:
        raise ValueError(
            f"mesh {data}x{model} needs {need} positions, the processes"
            f" hold {counts}")
    owner = [p for p in range(world) for _ in range(counts[p])]
    first = sum(counts[:rank])
    devs = [local[i - first] if owner[i] == rank else torch.device("meta")
            for i in range(need)]
    procs = tuple(tuple(owner[r * model + j] for j in range(model))
                  for r in range(data))
    groups = []
    for r in range(data):
        ranks = sorted(set(procs[r]))
        groups.append(dist.new_group(ranks) if len(ranks) > 1 else None)
    return Mesh(
        tuple(tuple(devs[r * model + j] for j in range(model))
              for r in range(data)),
        procs=procs, rank=rank, groups=tuple(groups))


def owned_model_shards(mesh):
    """Model shards of which this process holds a position — the
    ownership set the feed partition materializes rows for
    (engine/partition.py ``partition_feed``).  On a mesh whose model row
    spans processes (``global_mesh(1, n)``) the sets are disjoint and a
    process's host memory is O(E·|owned|/M); where each row is within one
    process every process owns all M shards."""
    D, M = mesh.shape["data"], mesh.shape["model"]
    return tuple(m for m in range(M)
                 if any(mesh.is_local(r, m) for r in range(D)))


# ---------------------------------------------------------------------------
# the multi-process dryrun
# ---------------------------------------------------------------------------


def _world(n_users=40, n_teams=6, n_orgs=3, n_repos=20, n_checks=64, seed=7):
    """The dryrun's GitHub-RBAC world: (compiled schema, snapshot, oracle,
    checks), made from ``seed`` so every process builds the same one."""
    from .. import rel
    from ..engine.oracle import Oracle
    from ..schema import compile_schema, parse_schema
    from ..store.interner import Interner
    from ..store.snapshot import build_snapshot

    rng = random.Random(seed)
    users = [f"user:u{i}" for i in range(n_users)]
    teams = [f"team:t{i}" for i in range(n_teams)]
    orgs = [f"org:o{i}" for i in range(n_orgs)]
    repos = [f"repo:r{i}" for i in range(n_repos)]
    triples = []
    for t in teams:
        for u in rng.sample(users, max(2, n_users // 5)):
            triples.append((f"{t}#member", u))
    for o in orgs:
        triples.append((f"{o}#admin", rng.choice(users)))
        for t in rng.sample(teams, 2):
            triples.append((f"{o}#member", f"{t}#member"))
    for r in repos:
        triples.append((f"{r}#org", rng.choice(orgs)))
        triples.append((f"{r}#maintainer", f"{rng.choice(teams)}#member"))
        for u in rng.sample(users, 3):
            triples.append((f"{r}#reader", u))
    rels = [rel.must_from_tuple(*t) for t in triples]
    cs = compile_schema(parse_schema(SCHEMA))
    snap = build_snapshot(1, cs, Interner(), rels, epoch_us=NOW_US)
    oracle = Oracle(cs, rels, now_us=NOW_US)
    checks = [
        rel.must_from_triple(
            rng.choice(repos), rng.choice(["read", "admin"]), rng.choice(users))
        for _ in range(n_checks)
    ]
    return cs, snap, oracle, checks


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name) or str(default))


def _verify(engine, planes, checks, oracle, pid) -> List[int]:
    """The global rows of a ``fetch=False`` dispatch this process holds,
    each held to the oracle (no overflow expected): their indices."""
    from ..engine.oracle import T

    d, _p, ovf = (x.cpu().numpy() for x in planes)
    rows = []
    at = 0
    for lo, hi in engine.last_local_rows:
        for k in range(hi - lo):
            gi = lo + k
            if gi < len(checks):
                if ovf[at + k]:
                    raise AssertionError(
                        f"proc {pid}: overflow at {checks[gi]} (row {gi})")
                want = oracle.check_relationship(checks[gi]) == T
                if bool(d[at + k]) != want:
                    raise AssertionError(
                        f"proc {pid}: mismatch at {checks[gi]} (row {gi})")
                rows.append(gi)
        at += hi - lo
    return rows


def _ranges(rows: List[int]) -> str:
    out, start = [], None
    for i, r in enumerate(rows):
        if start is None:
            start = r
        if i + 1 == len(rows) or rows[i + 1] != r + 1:
            out.append(f"{start}-{r + 1}")
            start = None
    return ",".join(out)


def _worker_main() -> None:
    """One dryrun process: join the process group, build the shared
    world, run the sharded check over the GLOBAL mesh (every table
    built whole, then the owned-shard feed partition, then the legacy
    program), and verify the rows this process holds against the host
    oracle."""
    import torch
    import torch.distributed as dist

    from ..engine import kernels as K
    from ..engine.partition import partition_feed, snapshot_raw_columns
    from ..engine.plan import EngineConfig
    from .sharded import ShardedEngine

    n_local = _env_int("GOCHUGARU_DRYRUN_LOCAL_DEVICES", 1)
    dev = torch.device(os.environ.get("GOCHUGARU_DRYRUN_DEVICE") or "cuda")
    if dev.type == "cpu":
        # each position already runs on a thread of its own, and the
        # world is tiny: torch's intra-op pool would only contend with
        # the other workers for the host's cores
        torch.set_num_threads(1)
    initialize()
    world, pid = _world_size_rank()
    n_dev = n_local * world
    model = _env_int("GOCHUGARU_DRYRUN_MODEL", 0) or (
        2 if n_local % 2 == 0 else 1)
    data = n_dev // model
    mesh = global_mesh(data, model, devices=[dev] * n_local)

    cs, snap, oracle, checks = _world(n_checks=32)
    engine = ShardedEngine(cs, mesh, EngineConfig())
    K.reset_launches()
    dsnap = engine.prepare(snap)
    queries, qctx = engine._lower_queries(snap, checks, dsnap.strings)
    planes = engine._dispatch_columns(dsnap, queries, qctx, NOW_US, fetch=False)
    rows = _verify(engine, planes, checks, oracle, pid)

    # the owned-shard feed partition of the SAME world: each process
    # materializes only its owned bucket shards, and the dispatch must
    # verify identically
    owned = owned_model_shards(mesh)
    part = partition_feed(
        snap.revision, cs, snap.interner, snapshot_raw_columns(snap),
        engine.config, engine.model_size, owned=owned,
        contexts=snap.contexts, epoch_us=NOW_US)
    if part is None:
        raise AssertionError("the feed partition declined the world")
    dsnap2 = engine.prepare_partitioned(part)
    t0 = time.perf_counter()
    planes2 = engine._dispatch_columns(dsnap2, queries, qctx, NOW_US,
                                       fetch=False)
    dispatch_s = time.perf_counter() - t0
    rows2 = _verify(engine, planes2, checks, oracle, pid)
    if rows2 != rows:
        raise AssertionError(f"proc {pid}: partitioned rows {rows2} != {rows}")
    coll = dict(engine.last_collectives)
    # the legacy program on the same mesh: its all-gathers cross the
    # processes where a model row does
    legacy = ShardedEngine(cs, mesh, EngineConfig(use_flat=False))
    lds = legacy.prepare(snap)
    planes3 = legacy._dispatch_columns(lds, queries, qctx, NOW_US, fetch=False)
    if _verify(legacy, planes3, checks, oracle, pid) != rows:
        raise AssertionError(f"proc {pid}: the legacy program's rows differ")
    report = dict(
        proc=pid, mesh=[data, model], device=str(dev), owned=list(owned),
        edges=int(snap.num_edges), local_rows=int(part.snapshot.e_rel.shape[0]),
        collectives=coll["calls"], collective_host_ms=coll["host_s"] * 1e3,
        legacy_collectives=legacy.last_collectives["calls"],
        cross_process_rows=sum(1 for r in range(data)
                               if mesh.group(r) is not None),
        dispatch_ms=dispatch_s * 1e3,
        launches={k: v for k, v in K.LAUNCHES.items() if v},
    )
    print(f"DRYRUN-OK proc={pid} devices={n_dev} mesh={data}x{model} "
          f"verified={len(rows)}/{len(checks)} partitioned={len(rows2)} "
          f"rows={_ranges(rows)} " + json.dumps(report), flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _free_port() -> str:
    """A fresh coordinator address: a stale worker of an earlier run can
    never absorb this run's joins, and concurrent runs do not collide."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _spawn(env_extra: dict):
    env = dict(os.environ, **env_extra)
    return subprocess.Popen(
        [sys.executable, "-m", "gochugaru_tpu_torch.parallel.multihost"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=_ROOT)


def _communicate_all(procs, timeout_s: float):
    """(outputs, return codes) of every process within one deadline; on
    the deadline every process still running is killed (rc None)."""
    deadline = time.monotonic() + timeout_s
    outs, rcs = [], []
    killed = set()
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    killed.add(id(q))
            out, _ = pr.communicate()
        rcs.append(None if id(pr) in killed else pr.returncode)
        outs.append(out or "")
    return outs, rcs


def dryrun_multihost(
    n_processes: int = 2, n_devices: int = 8, timeout_s: float = 600,
    model: int = 0, device: str = "cuda",
) -> List[dict]:
    """Spawn ``n_processes`` worker processes joined by
    ``torch.distributed`` (gloo), each with ``n_devices // n_processes``
    positions on ``device`` (``cuda`` stands every position on
    ``cuda:0``), run the sharded check over the process-spanning global
    mesh, and require every process to verify the rows it holds and
    every row of the batch to be held somewhere.  ``model`` is the mesh's
    model size (0: 2 where a process holds an even count, else 1 — each
    row then within one process; ``model=n_devices`` makes the one model
    row span every process).  Returns the workers' reports; raises, with
    each worker's tail, on any failure or when the deadline kills one,
    and at once on ``cuda`` with no card (pass ``device="cpu"``)."""
    import torch

    if n_devices % n_processes:
        raise ValueError(f"{n_devices} devices do not split {n_processes} ways")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise ValueError("no CUDA device: pass device='cpu'")
    local = n_devices // n_processes
    coordinator = _free_port()
    procs = [_spawn(dict(
        GOCHUGARU_COORDINATOR=coordinator,
        GOCHUGARU_NUM_PROCESSES=str(n_processes),
        GOCHUGARU_PROCESS_ID=str(pid),
        GOCHUGARU_DRYRUN_LOCAL_DEVICES=str(local),
        GOCHUGARU_DRYRUN_DEVICE=device,
        GOCHUGARU_DRYRUN_MODEL=str(model),
        GOCHUGARU_DRYRUN_MODE="",
        # every worker is on this host: gloo's transport on the loopback
        GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
    )) for pid in range(n_processes)]
    outs, rcs = _communicate_all(procs, timeout_s)
    ok = all(rc == 0 and "DRYRUN-OK" in out for out, rc in zip(outs, rcs))
    if not ok:
        for pid, (out, rc) in enumerate(zip(outs, rcs)):
            tail = "\n".join(out.splitlines()[-12:])
            print(f"--- proc {pid} (rc {rc}) tail ---\n{tail}", file=sys.stderr)
        raise RuntimeError("multi-process dryrun failed")
    reports, covered, want = [], set(), None
    for out in outs:
        for line in out.splitlines():
            if not line.startswith("DRYRUN-OK"):
                continue
            print(line.split(" {", 1)[0], flush=True)
            head, js = line.split(" {", 1)
            fields = dict(kv.split("=", 1) for kv in head.split()[1:])
            want = int(fields["verified"].split("/")[1])
            for rg in filter(None, fields["rows"].split(",")):
                lo, hi = rg.split("-")
                covered.update(range(int(lo), int(hi)))
            reports.append(json.loads("{" + js))
    if want is None or covered != set(range(want)):
        raise RuntimeError(
            f"the processes verified {len(covered)} of {want} rows: the"
            " data axis is dropping rows")
    return reports


# ---------------------------------------------------------------------------
# the RSS dryrun: the host memory of the partitioned feed
# ---------------------------------------------------------------------------

_RSS_EPOCH = 1_700_000_000_000_000


def _raw_rbac_world(edges: int):
    """The GitHub-RBAC world as UNSORTED raw feed columns — what a store
    feed hands ``partition_feed`` — made by deterministic arithmetic (no
    duplicate rows), so every process builds the same feed."""
    from ..schema import compile_schema, parse_schema
    from ..store.interner import Interner

    cs = compile_schema(parse_schema(SCHEMA))
    itn = Interner()
    n_repos = max(edges // 5, 40)
    n_users = max(n_repos // 10, 70)
    n_teams = max(n_users // 10, 8)
    n_orgs = max(n_teams // 10, 2)
    users = np.asarray(
        [itn.node("user", f"u{i}") for i in range(n_users)], np.int32)
    teams = np.asarray(
        [itn.node("team", f"t{i}") for i in range(n_teams)], np.int32)
    orgs = np.asarray(
        [itn.node("org", f"o{i}") for i in range(n_orgs)], np.int32)
    repos = np.asarray(
        [itn.node("repo", f"r{i}") for i in range(n_repos)], np.int32)
    slot = cs.slot_of_name
    member, admin = slot["member"], slot["admin"]
    org_rel, maint, reader = slot["org"], slot["maintainer"], slot["reader"]
    res_p, rel_p, subj_p, srel_p = [], [], [], []

    def add(r, rl, s, sr):
        res_p.append(r.astype(np.int32))
        rel_p.append(np.full(r.shape[0], rl, np.int32))
        subj_p.append(s.astype(np.int32))
        srel_p.append(np.full(r.shape[0], sr, np.int32))

    # team edges budgeted to ~edges/5 (repos carry 4/5); capped under
    # n_users/7 so the 7-stride below stays duplicate-free per team
    per_team = max(2, min((edges // 5) // n_teams, n_users // 7))
    t_idx = np.repeat(np.arange(n_teams), per_team)
    k_idx = np.tile(np.arange(per_team), n_teams)
    add(teams[t_idx], member, users[(t_idx * 13 + 7 * k_idx) % n_users], -1)
    o_idx = np.arange(n_orgs)
    add(orgs, admin, users[o_idx % n_users], -1)
    for j in range(2):  # org member usersets: 2 teams each
        add(orgs, member, teams[(o_idx * 3 + j) % n_teams], member)
    for j in range(5):  # org direct members
        add(orgs, member, users[(o_idx * 11 + j) % n_users], -1)
    r_idx = np.arange(n_repos)
    add(repos, org_rel, orgs[r_idx % n_orgs], -1)
    add(repos, maint, teams[r_idx % n_teams], member)
    for j in range(2):
        add(repos, reader, users[(r_idx * 17 + j * 5 + 1) % n_users], -1)
    cols = dict(
        res=np.concatenate(res_p), rel=np.concatenate(rel_p),
        subj=np.concatenate(subj_p), srel=np.concatenate(srel_p),
    )
    return cs, itn, cols, dict(users=users, repos=repos, slot=slot)


def _rss_devices() -> list:
    """This process's positions: the host's memory is what is measured,
    so they are CPU positions."""
    import torch

    n = _env_int("GOCHUGARU_DRYRUN_LOCAL_DEVICES",
                 _env_int("GOCHUGARU_DRYRUN_DEVICES", 8))
    return [torch.device("cpu")] * n


def _rss_baseline_main() -> None:
    """One process: the full snapshot and the build-full-then-stack
    prepare over the same (1 × n) mesh — the denominator of the RSS
    comparison."""
    from ..engine.plan import EngineConfig
    from ..store.snapshot import build_snapshot_from_columns
    from ..utils.metrics import peak_rss_mb
    from .sharded import ShardedEngine

    edges = _env_int("GOCHUGARU_DRYRUN_EDGES", 1_000_000)
    cs, itn, cols, _info = _raw_rbac_world(edges)
    E = int(cols["res"].shape[0])
    devs = _rss_devices()
    base = peak_rss_mb()
    snap = build_snapshot_from_columns(1, cs, itn, epoch_us=_RSS_EPOCH, **cols)
    del cols
    engine = ShardedEngine(
        cs, global_mesh(1, len(devs), devices=devs),
        EngineConfig.for_schema(cs, flat_partition_build=False))
    dsnap = engine.prepare(snap)
    if dsnap.flat_meta is None or not dsnap.flat_meta.sharded:
        raise AssertionError("the baseline prepare is not bucket-sharded")
    peak = peak_rss_mb()
    print("RSS-BASELINE " + json.dumps(dict(
        edges=E, base_mb=base, peak_mb=peak,
        build_delta_mb=round(peak - base, 1),
    )), flush=True)


def _rss_worker_main() -> None:
    """One multi-process RSS worker: the feed-partitioned prepare over a
    mesh whose MODEL row spans the processes, so ownership is disjoint
    and each process materializes only its share of the feed; then one
    dispatch, verified in the rows this process holds."""
    import torch.distributed as dist

    from ..engine.partition import partition_feed
    from ..engine.plan import EngineConfig
    from ..utils.metrics import peak_rss_mb
    from .sharded import ShardedEngine

    initialize()
    world, pid = _world_size_rank()
    edges = _env_int("GOCHUGARU_DRYRUN_EDGES", 1_000_000)
    devs = _rss_devices()
    mesh = global_mesh(1, len(devs) * world, devices=devs)
    cs, itn, cols, info = _raw_rbac_world(edges)
    E = int(cols["res"].shape[0])
    base = peak_rss_mb()
    engine = ShardedEngine(cs, mesh, EngineConfig.for_schema(cs))
    owned = owned_model_shards(mesh)
    part = partition_feed(1, cs, itn, cols, engine.config, engine.model_size,
                          owned=owned, epoch_us=_RSS_EPOCH)
    if part is None:
        raise AssertionError("the feed partition declined the world")
    dsnap = engine.prepare_partitioned(part)
    peak = peak_rss_mb()
    print("RSS-OK " + json.dumps(dict(
        proc=pid, owned=list(owned), edges=E,
        local_rows=int(part.snapshot.e_rel.shape[0]),
        base_mb=base, peak_mb=peak, build_delta_mb=round(peak - base, 1),
    )), flush=True)
    rng = np.random.default_rng(3)
    B = 1024
    planes = engine.check_columns(
        dsnap, rng.choice(info["repos"], B).astype(np.int32),
        np.full(B, info["slot"]["read"], np.int32),
        rng.choice(info["users"], B).astype(np.int32),
        now_us=_RSS_EPOCH, fetch=False)
    d, _p, ovf = (x.cpu().numpy() for x in planes)
    if ovf[:B].any():
        raise AssertionError("overflow in the RSS dispatch")
    print(f"RSS-DISPATCH-OK granted={int(d[:B].sum())}/{B}", flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _rss_parity_main() -> None:
    """One process at the RSS world's shape: the feed-partitioned tables
    equal the build-full-then-stack builder's, array for array."""
    from ..engine.flat import build_flat_arrays_sharded
    from ..engine.partition import ShardSlices, partition_feed
    from ..engine.plan import EngineConfig
    from ..store.snapshot import build_snapshot_from_columns

    edges = min(_env_int("GOCHUGARU_DRYRUN_EDGES", 1_000_000), 300_000)
    M = _env_int("GOCHUGARU_DRYRUN_DEVICES", 8)
    cs, itn, cols, _info = _raw_rbac_world(edges)
    snap = build_snapshot_from_columns(
        1, cs, itn, epoch_us=_RSS_EPOCH,
        **{k: v.copy() for k, v in cols.items()})
    # the reference side is the build-full-then-stack path: with the
    # partition-first default both sides would share engine/partition.py
    # and a shared fault would cancel out of the comparison.  It builds
    # without the reverse lookup index, which the feed declines (its
    # shards are keyed by the subject hash, not the primary bucket)
    legacy = EngineConfig.for_schema(cs, flat_partition_build=False,
                                     flat_rev_index=False)
    built = build_flat_arrays_sharded(snap, legacy, M, plan=None)
    if built is None:
        raise AssertionError("the sharded build declined the world")
    ref, ref_meta, _f, _c = built
    part = partition_feed(1, cs, itn, cols, EngineConfig.for_schema(cs), M,
                          epoch_us=_RSS_EPOCH)
    if part is None or part.meta != ref_meta or set(part.arrays) != set(ref):
        raise AssertionError("the feed partition's tables or meta differ")
    for k in sorted(ref):
        v = part.arrays[k]
        got = v.to_full() if isinstance(v, ShardSlices) else v
        if not np.array_equal(got, ref[k]):
            raise AssertionError(f"table {k} differs")
    print(f"PARITY-OK tables={len(ref)} edges={snap.num_edges}", flush=True)


def rss_dryrun(
    edges: int = 1_000_000,
    n_processes: int = 2,
    n_devices: int = 8,
    timeout_s: float = 900,
    max_ratio: float = 0.6,
) -> dict:
    """The host-memory claim of the partitioned feed, end to end:

    1. one-process baseline — the full snapshot and the
       build-full-then-stack prepare (``flat_partition_build=False``);
    2. a parity process — the feed-partitioned tables equal that
       builder's at the same world (bounded size: it holds both builds);
    3. ``n_processes`` workers over a (1 × n_devices) mesh whose model row
       spans the processes (disjoint ownership), each building only its
       owned partitions with ``partition_feed``, then one dispatch.

    Passes when every worker's build-phase RSS growth (peak less the
    post-worldgen base: both paths generate the same feed, so the growth
    isolates feed-to-tables memory) is at most ``max_ratio`` times the
    baseline's.  Returns the summary; raises on any failure."""
    if n_devices % n_processes:
        raise ValueError(f"{n_devices} devices do not split {n_processes} ways")
    env_c = dict(GOCHUGARU_DRYRUN_EDGES=str(edges),
                 GOCHUGARU_DRYRUN_DEVICES=str(n_devices),
                 GOCHUGARU_DRYRUN_LOCAL_DEVICES="")
    (out,), (rc,) = _communicate_all(
        [_spawn(dict(env_c, GOCHUGARU_DRYRUN_MODE="rss-baseline"))], timeout_s)
    base_line = [ln for ln in out.splitlines() if ln.startswith("RSS-BASELINE ")]
    if rc != 0 or not base_line:
        raise RuntimeError(f"rss baseline failed:\n{out[-2000:]}")
    baseline = json.loads(base_line[0].split(" ", 1)[1])
    print(base_line[0], flush=True)

    (out,), (rc,) = _communicate_all(
        [_spawn(dict(env_c, GOCHUGARU_DRYRUN_MODE="rss-parity"))], timeout_s)
    if rc != 0 or "PARITY-OK" not in out:
        raise RuntimeError(f"rss parity failed:\n{out[-2000:]}")
    print([ln for ln in out.splitlines() if "PARITY-OK" in ln][0], flush=True)

    coordinator = _free_port()
    procs = [_spawn(dict(
        env_c, GOCHUGARU_DRYRUN_MODE="rss",
        GOCHUGARU_COORDINATOR=coordinator,
        GOCHUGARU_NUM_PROCESSES=str(n_processes),
        GOCHUGARU_PROCESS_ID=str(pid),
        GOCHUGARU_DRYRUN_LOCAL_DEVICES=str(n_devices // n_processes),
        GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
    )) for pid in range(n_processes)]
    outs, rcs = _communicate_all(procs, timeout_s)
    workers = []
    for pid, (out, rc) in enumerate(zip(outs, rcs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RSS-OK ")]
        if rc != 0 or not lines or "RSS-DISPATCH-OK" not in out:
            tail = "\n".join(out.splitlines()[-12:])
            raise RuntimeError(f"rss worker {pid} failed (rc {rc}):\n{tail}")
        workers.append(json.loads(lines[0].split(" ", 1)[1]))
        print(lines[0], flush=True)
    worst = max(w["build_delta_mb"] for w in workers)
    ratio = worst / max(baseline["build_delta_mb"], 1e-9)
    summary = dict(
        edges=baseline["edges"],
        n_processes=n_processes,
        baseline_build_delta_mb=baseline["build_delta_mb"],
        baseline_peak_mb=baseline["peak_mb"],
        worker_build_delta_mb=[w["build_delta_mb"] for w in workers],
        worker_peak_mb=[w["peak_mb"] for w in workers],
        worker_local_rows=[w["local_rows"] for w in workers],
        ratio=round(ratio, 3),
        max_ratio=max_ratio,
    )
    print("RSS-SUMMARY " + json.dumps(summary), flush=True)
    if ratio > max_ratio:
        raise RuntimeError(
            f"per-process build RSS {worst} MB is {ratio:.2f}x the "
            f"one-process {baseline['build_delta_mb']} MB (bar: {max_ratio})")
    return summary


def _main() -> None:
    if "--rss" in sys.argv[1:]:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--rss", action="store_true")
        ap.add_argument("--edges", type=int, default=1_000_000)
        ap.add_argument("--processes", type=int, default=2)
        ap.add_argument("--devices", type=int, default=8)
        ap.add_argument("--max-ratio", type=float, default=0.6)
        args = ap.parse_args()
        rss_dryrun(edges=args.edges, n_processes=args.processes,
                   n_devices=args.devices, max_ratio=args.max_ratio)
        return
    mode = os.environ.get("GOCHUGARU_DRYRUN_MODE", "")
    if mode == "rss":
        _rss_worker_main()
    elif mode == "rss-baseline":
        _rss_baseline_main()
    elif mode == "rss-parity":
        _rss_parity_main()
    else:
        _worker_main()


if __name__ == "__main__":
    _main()
