"""The port's admission controller (utils/admission.py, copied from the
reference package) against the reference's on the same scripted
sequences: the in-flight gate admitting and shedding under its bound, the
deadline-budget shed, the cost model, and the circuit breaker walking
closed -> open -> half-open -> closed on an injected clock.  Each script
runs on both packages with a fresh metrics registry; the outcomes and
the counters must be equal."""

import pytest

from gochugaru_tpu.utils import admission as JA
from gochugaru_tpu.utils import metrics as JM
from gochugaru_tpu.utils.context import background as j_background
from gochugaru_tpu.utils.errors import (
    DeadlineExceededError as JDeadline, ShedError as JShed,
)

from gochugaru_tpu_torch.utils import admission as PA
from gochugaru_tpu_torch.utils import metrics as PM
from gochugaru_tpu_torch.utils.context import background as p_background
from gochugaru_tpu_torch.utils.errors import (
    DeadlineExceededError as PDeadline, ShedError as PShed,
)

SIDES = {
    "reference": (JA, JM, j_background, JShed, JDeadline),
    "port": (PA, PM, p_background, PShed, PDeadline),
}
COUNTERS = ("admission.sheds", "admission.deadline_sheds", "breaker.trips",
            "breaker.half_opens", "breaker.closes")


def _both(script, *args):
    """``script`` run on each package: its outcomes and counters."""
    out = {}
    for side, mods in SIDES.items():
        m = mods[1].Metrics()
        got = script(m, *mods, *args)
        out[side] = (got, {c: m.counter(c) for c in COUNTERS})
    return out["port"], out["reference"]


def _gate(m, A, _M, _bg, Shed, _Dl, bound, depth):
    """Nest ``depth`` admits under a gate of ``bound``: which were shed."""
    gate = A.DispatchGate(bound, registry=m)
    seen = []

    def enter(k):
        if k == depth:
            return
        try:
            with gate.admit():
                seen.append(("in", gate.inflight))
                enter(k + 1)
        except Shed:
            seen.append(("shed", gate.inflight))
            enter(k + 1)

    enter(0)
    seen.append(("after", gate.inflight))
    return seen


@pytest.mark.parametrize("bound,depth", [(1, 3), (3, 5), (0, 4)])
def test_gate_admits_and_sheds_like_the_reference(bound, depth):
    got, want = _both(_gate, bound, depth)
    assert got == want
    assert got[1]["admission.sheds"] == (depth - bound if bound else 0)


def _deadline(m, A, _M, bg, _Shed, Deadline, steps):
    """A controller with a 0.2 s floor: each step observes a cost, then
    checks a context with ``timeout`` s left (None: no deadline)."""
    adm = A.AdmissionController(
        A.AdmissionConfig(deadline_floor_s=0.2), registry=m)
    seen = []
    for cost, timeout in steps:
        if cost is not None:
            adm.observe_cost(cost)
        ctx = bg() if timeout is None else bg().with_timeout(timeout)
        try:
            adm.check_deadline(ctx)
            seen.append("admit")
        except Deadline:
            seen.append("shed")
        seen.append(round(adm.expected_cost_s(), 6))
    return seen


@pytest.mark.parametrize("steps", [
    [(None, 5.0), (None, 0.05), (None, None)],
    [(1.0, 5.0), (3.0, 0.5), (None, 0.5), (None, 0.5), (0.1, 30.0)],
])
def test_deadline_shed_like_the_reference(steps):
    got, want = _both(_deadline, steps)
    assert got == want
    assert "shed" in got[0] and "admit" in got[0]


def _breaker(m, A, _M, _bg, _Shed, _Dl, script):
    """Drive a breaker (threshold 3, cooldown 1 s) on a fake clock:
    ``f`` failure, ``s`` batch-path success, ``p`` latency-probe success,
    ``a`` ask allow_latency, a number: advance the clock."""
    clock = {"t": 0.0}
    br = A.CircuitBreaker(3, 1.0, registry=m, clock=lambda: clock["t"])
    seen = []
    for op in script:
        if isinstance(op, float):
            clock["t"] += op
        elif op == "f":
            br.record_failure()
        elif op == "s":
            br.record_success(probe=False)
        elif op == "p":
            br.record_success(probe=True)
        elif op == "a":
            seen.append(br.allow_latency())
        seen.append(br.state)
    return seen + [m.gauge("breaker.state")]


@pytest.mark.parametrize("script", [
    # open -> half-open -> failed probe -> open -> half-open -> closed
    ["a", "f", "f", "a", "f", "a", 1.1, "a", "f", "a", 1.2, "a", "s", "a",
     "p", "a"],
    # successes reset the count; a batch success never closes an open one
    ["f", "f", "s", "f", "f", "a", "f", "s", "a", 0.5, "a", 0.6, "a", "p"],
])
def test_breaker_walk_like_the_reference(script):
    got, want = _both(_breaker, script)
    assert got == want
    assert PA.OPEN in got[0] and PA.HALF_OPEN in got[0]


def _cost(m, A, *_mods):
    """The per-tier cost model: tier-less and tiered samples, decay."""
    cm = A.CostModel(floor_s=0.001)
    seen = [cm.has_samples(), cm.expected_s()]
    for sec, tier in ((0.004, 256), (0.008, 1024), (0.002, 256)):
        cm.observe(sec, tier)
        seen += [cm.expected_s(256), cm.expected_s(1024), cm.expected_s()]
    cm.decay()
    seen.append(cm.state()["by_tier_s"])
    cm.observe(0.01)
    cm.decay()
    seen += [cm.expected_s(), cm.expected_s(4096), cm.state()["overall_s"]]
    return seen


def test_cost_model_like_the_reference():
    got, want = _both(_cost)
    assert got == want
