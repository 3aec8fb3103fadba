"""``with_profiling`` on the card: the trace of a profiled check dispatch
holds the probe kernels' launches, exactly as many as the wrappers
counted (``block`` among them), and the CPU-only client's twin of the
test is tests/test_torch_profiling.py.

The module imports only the port (no JAX), so it runs on a machine with
an NVIDIA card and no JAX: ``python3 -m pytest -m cuda --noconftest
tests/test_torch_profiling_cuda.py`` from the repository root."""

import json
import os

import pytest
import torch

from gochugaru_tpu_torch import consistency as pcons
from gochugaru_tpu_torch import rel as prel
from gochugaru_tpu_torch.client import new_evaluator, with_profiling
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
from gochugaru_tpu_torch.utils.context import background

SCHEMA = """
definition user {}
definition team { relation member: user }
definition doc {
    relation reader: user | team#member
    permission read = reader
}
"""

#: the probe kernels' entry points (csrc/probe_common.cuh, fused_probe.cu)
PROBE_KERNELS = ("gochugaru_slot_tile_kernel", "gochugaru_warp_reduce_kernel",
                 "fused_runs_kernel")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device here)")
    return "cuda"


@pytest.mark.cuda
def test_profiled_trace_holds_the_probe_kernel_launches(card, tmp_path):
    c = new_evaluator(with_profiling(str(tmp_path)), device=card)
    ctx = background()
    c.write_schema(ctx, SCHEMA)
    txn = prel.Txn()
    for t in range(8):
        for u in range(t, 40, 8):
            txn.touch(prel.must_from_triple(f"team:t{t}", "member", f"user:u{u}"))
    for d in range(200):
        txn.touch(prel.must_from_tuple(f"doc:d{d}#reader", f"team:t{d % 8}#member"))
        txn.touch(prel.must_from_triple(f"doc:d{d}", "reader", f"user:u{d % 40}"))
    c.write(ctx, txn)
    checks = [prel.must_from_triple(f"doc:d{(7 * i) % 200}", "read",
                                    f"user:u{(3 * i) % 40}") for i in range(512)]
    c.check(ctx, pcons.full(), *checks)  # prepare, and the first trace
    before = set(os.listdir(tmp_path))
    K.reset_launches()
    got = c.check(ctx, pcons.full(), *checks)
    launches = dict(K.LAUNCHES)
    new = sorted(set(os.listdir(tmp_path)) - before)
    assert len(new) == 1
    snap = c.store.snapshot_for(pcons.full())
    oracle = SnapshotOracle(snap, {})
    assert got == [oracle.check_relationship(r) == T for r in checks]
    with open(tmp_path / new[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    probes = [n for n in kernels if any(k in n for k in PROBE_KERNELS)]
    assert launches["block"] >= 1
    assert len(probes) == sum(launches.values())
