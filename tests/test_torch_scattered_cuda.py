"""The scattered layout (``EngineConfig(flat_blockslice=False)``) on the
card: a ``cuda`` engine with the kernels on gives the planes of the same
engine on ``cpu``, eagerly and replayed from a latency pin, and launches
no probe kernel (the scattered program has no probe-kernel site).

The module imports only the port (no JAX), so it runs on a machine with an
NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_scattered_cuda.py`` from the repository root.
tests/test_torch_scattered.py holds the CPU planes to the reference's.
All outputs are int or bool: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from test_torch_latency_cuda import EPOCH, _queries, _rbac, _same


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return "cuda"


@pytest.mark.cuda
def test_scattered_engine_on_card_equals_cpu_and_launches_nothing(cuda_device):
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    q = _queries(users, repos, slot, 1_000, 3)
    ec = PEngine(cs, PConfig(flat_blockslice=False), device="cpu")
    eg = PEngine(cs, PConfig(flat_blockslice=False, kernels=True), device=cuda_device)
    dc, dg = ec.prepare(snap), eg.prepare(snap)
    assert not dg.flat_meta.blockslice
    want = ec.check_columns(dc, *q, now_us=EPOCH)
    K.reset_launches()
    got = eg.check_columns(dg, *q, now_us=EPOCH)
    assert _same(got, want)
    assert np.asarray(want[0]).any()
    lp = eg.latency_path(dg)
    for B in (1, 200, 1_000):
        cols = tuple(c[:B] for c in q)
        assert _same(lp.dispatch_columns(*cols, now_us=EPOCH),
                     [np.asarray(x)[:B] for x in want])
    assert lp.compile_count >= 1
    assert not any(K.LAUNCHES.values()), dict(K.LAUNCHES)
