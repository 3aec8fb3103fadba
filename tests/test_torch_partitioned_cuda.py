"""The partitioned serve on the card: four shards on one NVIDIA card
(``make_mesh(1, 4, devices=[cuda:0] * 4)``) prepared through the
routed feed (``prepare_snapshot_partitioned``) give the unsharded cuda
engine's planes, on a routable batch (owner-routed, no collective) and
on the psum fallback of a 2 × 2 mesh, with no probe kernel launched
(the partitioned probes are plain gathers); the two-process dryrun runs
with both processes on ``cuda:0``.

The module imports only the port (no JAX), so it runs on a machine with
an NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_partitioned_cuda.py`` from the repository root.
tests/test_torch_routed.py holds the CPU mesh to the reference's.  All
outputs are int or bool: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import DeviceEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.parallel import ShardedEngine, make_mesh
from gochugaru_tpu_torch.parallel.multihost import dryrun_multihost
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from gochugaru_tpu_torch.utils import metrics
from test_torch_latency_cuda import EPOCH, _queries, _rbac, _same


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_partitioned_on_one_card_equals_unsharded(cuda_device, shape):
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    q = _queries(users, repos, slot, 2_000, 5)
    n = shape[0] * shape[1]
    eg = ShardedEngine(cs, make_mesh(*shape, devices=[cuda_device] * n),
                       PConfig(kernels=True))
    dg = eg.prepare_snapshot_partitioned(snap)
    assert dg.flat_meta.part_serve
    single = DeviceEngine(cs, PConfig(kernels=True), device=cuda_device)
    want = single.check_columns(single.prepare(snap), *q, now_us=EPOCH)
    r0 = metrics.default.snapshot().get("dispatch.route_s.count", 0)
    K.reset_launches()
    got = eg.check_columns(dg, *q, now_us=EPOCH)
    assert not any(K.LAUNCHES.values()), dict(K.LAUNCHES)
    assert _same(got, want)
    assert np.asarray(want[0]).any() and not np.asarray(want[0]).all()
    routed = metrics.default.snapshot().get("dispatch.route_s.count", 0) > r0
    assert routed == (shape[0] == 1)
    assert (eg.last_collectives["calls"] == 0) == routed


@pytest.mark.cuda
def test_two_processes_on_one_card(cuda_device):
    reports = dryrun_multihost(2, 4, timeout_s=300, model=4, device="cuda")
    assert all(r["cross_process_rows"] == 1 and r["local_rows"] < r["edges"]
               for r in reports)
