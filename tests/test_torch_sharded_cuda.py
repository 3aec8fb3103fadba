"""The model-sharded mesh on the card: four shards on one NVIDIA card
(``make_mesh(1, 4, devices=[cuda:0] * 4)``, and 2 × 2) give the planes of
the same mesh on the CPU, with no probe kernel launched (the sharded
probes are plain gathers), and the kernels switch on; a 1 × 3 mesh runs
the sharded legacy program.  ``make_mesh`` with no devices takes the
distinct cards and raises when asked for more than the box has.

The module imports only the port (no JAX), so it runs on a machine with
an NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_sharded_cuda.py`` from the repository root.
tests/test_torch_sharded.py holds the CPU mesh to the reference's.  All
outputs are int or bool: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.parallel import ShardedEngine, make_mesh
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from test_torch_latency_cuda import EPOCH, _queries, _rbac, _same


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 3)])
def test_mesh_on_one_card_equals_cpu_mesh(cuda_device, shape):
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    q = _queries(users, repos, slot, 2_000, 5)
    n = shape[0] * shape[1]
    ec = ShardedEngine(cs, make_mesh(*shape, devices=["cpu"] * n), PConfig())
    eg = ShardedEngine(cs, make_mesh(*shape, devices=[cuda_device] * n),
                       PConfig(kernels=True))
    dc, dg = ec.prepare(snap), eg.prepare(snap)
    assert (dg.flat_meta is not None) == (shape[1] != 3)
    want = ec.check_columns(dc, *q, now_us=EPOCH)
    K.reset_launches()
    got = eg.check_columns(dg, *q, now_us=EPOCH)
    assert _same(got, want)
    assert np.asarray(want[0]).any() and not np.asarray(want[0]).all()
    assert not any(K.LAUNCHES.values()), dict(K.LAUNCHES)
    assert eg.last_collectives["calls"] > 0


@pytest.mark.cuda
def test_make_mesh_takes_the_distinct_cards(cuda_device):
    n = torch.cuda.device_count()
    m = make_mesh(1, n)
    assert [d.index for d in m.devices[0]] == list(range(n))
    if n == 1:
        with pytest.raises(ValueError):
            make_mesh(2, 2)
