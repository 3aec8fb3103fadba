"""Operator entry points: the port's command-line drivers.

Each runs as ``python -m gochugaru_tpu_torch.scripts.<name>``:

- ``fleetd``: one fleet process, the router (the authority store,
  placement, zookies) or a replica (bootstrap, tail, serve checks);
- ``telemetryd``: the telemetry endpoints over a traced demo world;
- ``tune``: the offline tuning pass and the online controller;
- ``profile_prepare``: cProfile and the ``prepare.*`` stage timers of a
  cold first prepare.

Every entry point takes ``--device`` (default ``cuda``): ``cuda`` runs
the kernels and exits at once, with a message, where there is no card;
``cpu`` runs the plain versions.  None falls back from one to the other.
"""

from __future__ import annotations

import sys


def add_device_arg(ap) -> None:
    """The ``--device`` flag every entry point shares."""
    ap.add_argument(
        "--device", default="cuda",
        help="cuda (the kernels; exits at once without a card) or cpu (the"
             " plain versions)",
    )


def require_device(name: str) -> str:
    """``name`` if that device is usable here, else exit non-zero with a
    message on stderr.  Called before any work, so a missing card never
    surfaces half way through (and nothing falls back to the CPU)."""
    from ..engine.device import resolve_device

    try:
        resolve_device(name)
    except (RuntimeError, ValueError) as e:
        print(f"error: --device {name}: {e}", file=sys.stderr, flush=True)
        raise SystemExit(2)
    return name
