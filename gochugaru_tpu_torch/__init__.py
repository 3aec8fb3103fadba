"""gochugaru_tpu_torch — the PyTorch/CUDA port of gochugaru_tpu.

The same authorization framework (the Check and Lookup surface of
``authzed/gochugaru`` evaluated in-process) with its device engine
rewritten in PyTorch and its TPU kernel hand-written in CUDA C++ for
Hopper.  It imports nothing of JAX and nothing of ``gochugaru_tpu``: the
host layers are copied here, the device layers rewritten.

Package layout (mirrors gochugaru_tpu):

- ``rel``, ``consistency`` — the data model and consistency strategies
- ``schema``   — SpiceDB schema-language parser + IR compiler
- ``caveats``  — the host CEL-subset caveat compiler (oracle side)
- ``store``    — interners, MVCC tuple log, columnar snapshots
- ``engine``   — the host oracle, the flat-kernel table build, and the
  torch device engine; ``engine/kernels`` holds the CUDA kernel wrappers
  and their plain PyTorch twins, ``csrc/`` the CUDA sources
- ``native``   — the C++ host ingest helpers (ctypes)
- ``client``   — the Client facade (``new_evaluator``)
- ``utils``    — context, retry/backoff, errors, metrics, tracing spans
"""

__version__ = "0.1.0"

from . import consistency, rel  # noqa: F401  (re-exported subpackages)
from .client import Client, new_evaluator  # noqa: F401
