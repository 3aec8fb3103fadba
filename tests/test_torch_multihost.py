"""The port's multi-process mesh on ``torch.distributed`` (gloo, CPU).

parallel/multihost.py spawns worker processes
(``python -m gochugaru_tpu_torch.parallel.multihost``) joined by a gloo
process group on a fresh coordinator port; each builds the dryrun's
world, runs the sharded check over the process-spanning global mesh —
every table built whole, then the owned-shard feed partition
(engine/partition.py ``partition_feed(owned=owned_model_shards(mesh))``,
``prepare_partitioned``) — and verifies the rows it holds against the
host oracle, and the parent checks that every row is held somewhere.
The reference's tests/test_multihost.py runs the same dryruns over
``jax.distributed``:

- 2 and 4 processes over 8 positions, each model row within one process;
- a 1 × 4 mesh whose one model row spans two processes: disjoint shard
  ownership (each process builds fewer primary rows than the world has)
  and cross-process collectives at every probe site of the psum path,
  and the legacy program's all-gathers across the processes.

The in-process parts (a mesh that knows which positions are this
process's, ``run_mesh`` and the placement on local positions only, the
planes of the rows this process holds) run here directly.  The RSS
dryrun is slow-marked, as the reference's is.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_engine as TE

from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig
from gochugaru_tpu_torch.parallel import ShardedEngine, make_mesh
from gochugaru_tpu_torch.parallel import multihost as MH
from gochugaru_tpu_torch.parallel.collectives import run_mesh
from gochugaru_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")


@pytest.mark.parametrize("n_processes", [2, 4])
def test_dryrun_multihost(n_processes):
    """Every process verifies its rows (whole tables and the owned feed
    partition alike), and the rows together cover the batch."""
    reports = MH.dryrun_multihost(n_processes, 8, timeout_s=120, device="cpu")
    assert sorted(r["proc"] for r in reports) == list(range(n_processes))
    for r in reports:
        assert r["mesh"] == [8 // 2, 2]
        assert r["owned"] == [0, 1] and r["local_rows"] == r["edges"]
        assert r["cross_process_rows"] == 0 and r["collectives"] > 0


def test_cross_process_model_row():
    """A 1 × 4 mesh over two processes: process 0 owns shards 0-1,
    process 1 shards 2-3; each builds only its owned share of the primary
    rows, and the psum path's collectives cross the process boundary."""
    reports = MH.dryrun_multihost(2, 4, timeout_s=120, model=4, device="cpu")
    by = {r["proc"]: r for r in reports}
    assert by[0]["owned"] == [0, 1] and by[1]["owned"] == [2, 3]
    for r in reports:
        assert r["mesh"] == [1, 4] and r["cross_process_rows"] == 1
        assert 0 < r["local_rows"] < r["edges"]
        assert r["collectives"] > 0 and r["legacy_collectives"] > 0
    assert by[0]["local_rows"] + by[1]["local_rows"] == by[0]["edges"]


def test_dryrun_deadline_kills_workers():
    """On the deadline every worker still running is killed: the parent
    never waits on a hung process group."""
    procs = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(2)]
    outs, rcs = MH._communicate_all(procs, 0.5)
    assert rcs == [None, None]
    assert all(p.poll() is not None for p in procs)


def test_single_process_entry_points(monkeypatch):
    """One process: ``initialize`` does nothing, ``global_mesh`` is a
    plain mesh over the given devices, every model shard is owned.  More
    than one process without a coordinator raises."""
    for k in ("GOCHUGARU_COORDINATOR", "GOCHUGARU_NUM_PROCESSES",
              "GOCHUGARU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    MH.initialize()
    mesh = MH.global_mesh(2, 4, devices=[CPU] * 8)
    assert mesh.procs is None and mesh.all_local and mesh.shape["model"] == 4
    assert MH.owned_model_shards(mesh) == (0, 1, 2, 3)
    monkeypatch.setenv("GOCHUGARU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        MH.initialize()
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            MH.global_mesh(1, 1)
        # the dryrun stands on the card unless the caller asks for the CPU
        with pytest.raises(ValueError, match="no CUDA device"):
            MH.dryrun_multihost(2, 4)


def _half_mesh(rank):
    """A 2 × 2 mesh of which process ``rank`` holds data row ``rank``
    (each row within one process: no cross-process group needed)."""
    return Mesh(((CPU, CPU), (CPU, CPU)), procs=((0, 0), (1, 1)), rank=rank,
                groups=(None, None))


def test_mesh_local_positions_and_run_mesh():
    mesh = _half_mesh(1)
    assert not mesh.all_local and mesh.local_positions() == [(1, 0), (1, 1)]
    assert MH.owned_model_shards(mesh) == (0, 1)
    results, comms = run_mesh(mesh, lambda r, j, comm: (r, j, comm.psum(
        torch.ones(2, dtype=torch.int32))))
    assert results[0] == [None, None] and comms[0] == [None, None]
    for j in range(2):
        r, jj, s = results[1][j]
        assert (r, jj) == (1, j) and s.tolist() == [2, 2]


def test_dispatch_returns_the_rows_this_process_holds():
    """A ShardedEngine on a mesh of which this process holds row 1
    places tables only there; ``fetch=False`` returns row 1's planes
    (``last_local_rows``), which equal the unsharded engine's on those
    queries; ``fetch=True`` raises (no result crosses processes)."""
    w = TE._rbac_world()
    mesh = _half_mesh(1)
    eng = ShardedEngine(w.p_cs, mesh, EngineConfig(**w.cfg))
    ds = eng.prepare(w.p_snap)
    assert all(set(v.parts) == {(1, 0), (1, 1)} for v in ds.arrays.values())
    from test_torch_engine import _port_rel

    rels = [_port_rel(c) for c in w.checks]
    queries, qctx = eng._lower_queries(w.p_snap, rels, ds.strings)
    planes = eng._dispatch_columns(ds, queries, qctx, TE.NOW, fetch=False)
    (lo, hi), = eng.last_local_rows
    assert lo > 0 and planes[0].shape[0] == hi - lo
    single = DeviceEngine(w.p_cs, EngineConfig(**w.cfg), device="cpu")
    want = single.check_batch(single.prepare(w.p_snap), rels, now_us=TE.NOW)
    n = min(hi, len(rels)) - lo
    for got, ref in zip(planes, want):
        assert np.array_equal(got.numpy()[:n], ref[lo:lo + n])
    with pytest.raises(RuntimeError, match="fetch=False"):
        eng.check_batch(ds, rels, now_us=TE.NOW)


def test_owned_slices_place_only_where_owned():
    """A ShardSlices table places each local position's own block and
    refuses a local position whose shard it does not hold."""
    from gochugaru_tpu_torch.engine.partition import ShardSlices
    from gochugaru_tpu_torch.parallel.sharded import place

    full = np.arange(16, dtype=np.int32).reshape(8, 2)
    mesh = Mesh(((CPU,) * 4,), procs=((0, 0, 1, 1),), rank=1, groups=(None,))
    ss = ShardSlices(full.shape, np.dtype(np.int32), 2,
                     {2: full[4:6], 3: full[6:8]})
    mt = place(mesh, ss, True)
    assert set(mt.parts) == {(0, 2), (0, 3)} and mt.nbytes == full.nbytes
    assert np.array_equal(mt.at(0, 3).numpy(), full[6:8])
    with pytest.raises(ValueError, match="not owned"):
        place(Mesh(((CPU,) * 4,), procs=((0, 0, 1, 1),), rank=0, groups=(None,)),
              ss, True)


def test_rss_parity_builds_without_the_reverse_index(monkeypatch, capsys):
    """The RSS dryrun's parity mode holds the feed's tables to the
    build-full-then-stack builder WITHOUT the reverse lookup index, which
    the feed declines.  The reference's parity mode builds it with the
    index (``EngineConfig.for_schema(cs, flat_partition_build=False)``),
    so its key sets and FlatMeta differ from the feed's and the mode
    fails on every world: shown here on the reference's own builders."""
    from gochugaru_tpu.engine.flat import build_flat_arrays_sharded as j_build
    from gochugaru_tpu.engine.partition import partition_feed as j_feed
    from gochugaru_tpu.engine.plan import EngineConfig as JConfig
    from gochugaru_tpu.parallel import multihost as JMH
    from gochugaru_tpu.store.snapshot import build_snapshot_from_columns as j_bsc

    cs, itn, cols, _info = JMH._raw_rbac_world(2_000)
    snap = j_bsc(1, cs, itn, epoch_us=MH._RSS_EPOCH,
                 **{k: v.copy() for k, v in cols.items()})
    ref, ref_meta, _f, _c = j_build(
        snap, JConfig.for_schema(cs, flat_partition_build=False), 8, plan=None)
    part = j_feed(1, cs, itn, cols, JConfig.for_schema(cs), 8,
                  epoch_us=MH._RSS_EPOCH)
    assert {"rvx", "rv_off"} <= set(ref) - set(part.arrays)
    assert ref_meta.has_rev and not part.meta.has_rev
    monkeypatch.setenv("GOCHUGARU_DRYRUN_EDGES", "2000")
    MH._rss_parity_main()
    assert "PARITY-OK" in capsys.readouterr().out


@pytest.mark.slow
def test_rss_dryrun():
    """The partitioned feed's host memory: each of two processes over a
    (1 × 8) mesh builds a smaller RSS growth than one process building
    every table, the feed's tables equal the full builder's, and each
    process's dispatch answers without overflow."""
    summary = MH.rss_dryrun(edges=300_000, n_processes=2, n_devices=8,
                            timeout_s=600)
    assert summary["ratio"] <= summary["max_ratio"]
    assert all(r > 0 for r in summary["worker_local_rows"])
