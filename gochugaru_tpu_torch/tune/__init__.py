"""Workload-adaptive self-tuning: close the loop from the perf ledger
to EngineConfig.

Every geometry and scheduling knob in the engine is measured somewhere
-- pad waste per pinned tier (utils/perf.py), batch occupancy and flush
reasons (serve/batcher.py), verdict-cache hit rates (engine/vcache.py),
gathered-bytes models and device residency (engine/flat.py) -- and this
package reads those measurements back into config.

Three pieces, offline-first:

- ``snapshot.collect_snapshot``: one JSON-serializable capture of the
  telemetry the tuner consumes, stamped with the config it was measured
  under (the tuner reasons about the config the data came from, which
  also makes emit -> apply -> re-emit a structural fixed point).
- ``tuner.propose``: deterministic rules mapping a snapshot to a
  ``TuneDiff`` -- per knob: current value, proposed value, the measured
  evidence string, and predicted deltas a re-run can verify.
- ``controller.OnlineController``: the three cheap knobs (hold-back
  deadline, verdict-cache byte budget, dedup window) adjusted live off
  telemetry deltas -- hysteresis, clamped ranges, bounded x2 steps,
  per-knob cooldown, a flight-recorder incident on oscillation, and a
  one-call ``revert()`` to the captured preset.

Expensive knobs (tier ladder, pack spec, kernels, placement) stay
OFFLINE by design: changing them means capturing new CUDA graphs or
re-preparing device tables, which is a deploy, not a nudge.
"""

from .snapshot import collect_snapshot  # noqa: F401
from .tuner import (  # noqa: F401
    KnobDiff,
    TuneDiff,
    TuneTarget,
    apply_diff,
    propose,
)
from .controller import OnlineController  # noqa: F401
