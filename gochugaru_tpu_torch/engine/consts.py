"""Device constants of the flat program, built once per device.

The flat program (engine/flat.py) and the CEL tri-state VM it calls
(caveats/device.py) read small constant tensors: VM literals, packed-field
dictionaries, the fold's slot map.  Copied from host memory on every
call, each one is a copy from pageable memory, which waits for the
stream and cannot be captured in a CUDA graph (engine/latency.py).  So
each is built once per device and cached here; the program's eager
calls and its graph captures then read the same tensor.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

import torch

_CACHE: Dict[Tuple[Any, torch.device], torch.Tensor] = {}
_LOCK = threading.Lock()


def _capturing(dev: torch.device) -> bool:
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def device_const(key: Any, device, make: Callable[[torch.device], torch.Tensor]
                 ) -> torch.Tensor:
    """``make(device)``, built once per (``key``, device) and cached.  A
    constant still missing inside a CUDA graph capture raises: ``make``
    copies from the host, which a capture cannot hold, so the program is
    run once eagerly before it is captured (engine/latency.py does)."""
    dev = torch.device(device)
    t = _CACHE.get((key, dev))
    if t is None:
        if _capturing(dev):
            raise RuntimeError(
                f"device constant {key!r} first built inside a CUDA graph"
                " capture: run the program once eagerly before capturing it")
        t = make(dev)
        with _LOCK:
            t = _CACHE.setdefault((key, dev), t)
    return t


def scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-dim constant of an explicit dtype.  It is filled on the device
    (no host copy), so inside a capture a missing one is built in the
    graph instead of cached.  The key is the value's repr, so -0.0 and
    0.0, or True and 1, stay apart."""
    dev = torch.device(device)
    key = ("scalar", type(v).__name__, repr(v), dtype)
    t = _CACHE.get((key, dev))
    if t is None:
        if _capturing(dev):
            return torch.full((), v, dtype=dtype, device=dev)
        t = device_const(key, dev,
                         lambda d: torch.full((), v, dtype=dtype, device=d))
    return t
