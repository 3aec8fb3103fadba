"""The port's fused K-hop lookup program on the card: each lookup
direction of a snapshot captures one CUDA graph and then replays it, a
replay gives the eager run of the same K rounds and the plain twins'
blocks, a capture that fails raises, leaves no graph, and the next
dispatch captures anew, and a dropped FrontierState frees its graphs
without the cyclic collector.

The module imports only the port (no JAX), so it runs on a machine with
an NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_spmm_cuda.py`` from the repository root.  The world is
tests/test_torch_latency_cuda.py's rbac world.  All outputs are int32
ids: the tolerance is exact equality.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from test_torch_latency_cuda import EPOCH, _rbac
from gochugaru_tpu_torch.engine import lookup as plookup
from gochugaru_tpu_torch.engine import spmv as pspmv
from gochugaru_tpu_torch.engine.device import DeviceEngine as PEngine
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.store.interner import Interner as PInterner
from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns as p_build
from gochugaru_tpu_torch.utils.metrics import default as _m


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return "cuda"


def _world(device, **cfg):
    cs, snap, users, repos, slot = _rbac(p_compile, p_parse, PInterner(), p_build)
    pe = PEngine(cs, PConfig(**cfg), device=device)
    return snap, users, repos, pe, pe.prepare(snap)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_100_fused_dispatches_capture_once_and_replay_equals_eager(cuda_device):
    snap, users, repos, pe, ds = _world(cuda_device, kernels=True)
    _s, _u, _r, pe_off, ds_off = _world(cuda_device, kernels=True, spmm=False)
    fl = pspmv.state_for(pe, ds)._spmm
    assert fl is not None
    rtid = snap.interner.type_lookup("repo")
    utid = snap.interner.type_lookup("user")
    d0, c0 = _m.counter("spmm.dispatches"), _m.counter("spmm.captures")
    rng = np.random.default_rng(11)
    served = 0
    for i in range(100):
        u = int(rng.choice(users))
        got = fl.resources(rtid, u, -1, -1, EPOCH)
        if i < 10:
            assert _same(got, fl.resources(rtid, u, -1, -1, EPOCH, run="rounds"))
            assert _same(got, fl.resources(rtid, u, -1, -1, EPOCH, plain=True))
        served += got is not None
    assert fl.captures["res"] == 1 and "res" in fl.graphs
    assert _m.counter("spmm.captures") - c0 == 1
    assert _m.counter("spmm.dispatches") - d0 == 120
    assert served
    modes = fl.graphs["res"].modes
    assert modes.get("runs", 0) == 2 * fl.kern.K, modes
    for r in repos[:8]:
        r = int(r)
        got = fl.subjects(r, utid, -1, -1, EPOCH)
        assert _same(got, fl.subjects(r, utid, -1, -1, EPOCH, run="rounds"))
        assert _same(got, fl.subjects(r, utid, -1, -1, EPOCH, plain=True))
    assert fl.captures["subj"] == 1
    # full answers: the fused path == the looped path
    for u in users[:8]:
        sid = snap.interner.key_of(int(u))[1]
        q = ("repo", "read", "user", sid, "")
        assert plookup.lookup_resources_device(pe, ds, *q, now_us=EPOCH) == \
            plookup.lookup_resources_device(pe_off, ds_off, *q, now_us=EPOCH)


@pytest.mark.cuda
def test_failed_capture_raises_and_the_next_dispatch_captures_anew(cuda_device):
    snap, users, _repos, pe, ds = _world(cuda_device, kernels=True)
    fl = pspmv.state_for(pe, ds)._spmm
    kern = fl.kern
    rtid = snap.interner.type_lookup("repo")
    u = int(users[0])
    good = kern._res_round

    def syncing(*args):
        s = good(*args)
        if bool(s[-1]):  # a host sync: no graph can hold it
            pass
        return s

    kern._res_round = syncing
    try:
        for n in (1, 2):  # the failed graph is dropped: no broken replay
            with pytest.raises(RuntimeError):
                fl.resources(rtid, u, -1, -1, EPOCH)
            assert fl.graphs == {} and fl.captures["res"] == n
            assert not torch.cuda.is_current_stream_capturing()
    finally:
        del kern._res_round
    want = fl.resources(rtid, u, -1, -1, EPOCH, run="rounds")
    assert _same(fl.resources(rtid, u, -1, -1, EPOCH), want)
    assert fl.captures["res"] == 3 and "res" in fl.graphs
    assert _same(fl.resources(rtid, u, -1, -1, EPOCH), want)
    assert fl.captures["res"] == 3


@pytest.mark.cuda
def test_dropped_frontier_state_frees_its_graphs(cuda_device):
    snap, users, _repos, pe, ds = _world(cuda_device, kernels=True)
    st = pspmv.FrontierState(pe, ds)
    rtid = snap.interner.type_lookup("repo")
    st._spmm.resources(rtid, int(users[0]), -1, -1, EPOCH)
    graph = weakref.ref(st._spmm.graphs["res"])
    torch.cuda.synchronize()
    was = gc.isenabled()
    gc.disable()
    try:
        del st
        assert graph() is None
    finally:
        if was:
            gc.enable()
