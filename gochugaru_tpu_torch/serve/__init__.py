"""Continuous-batching serving front-end (the ``serve`` subsystem).

``Client.with_serving(...)`` (client.py) opens a ``ServingHandle`` over
a client: concurrent Check/CheckMany submissions coalesce into pinned
pow2 tier slots through the ``MicroBatcher`` (serve/batcher.py), with
per-client fairness, deadline-aware hold-back, and the admission
gate/breaker as the shed path.  ``chip_smoke.py`` phase 14 drives
open-loop traffic through this surface on the card.
"""

from .batcher import MicroBatcher, ServeConfig, SubmitFuture
from .handle import ServingHandle

__all__ = ["MicroBatcher", "ServeConfig", "ServingHandle", "SubmitFuture"]
