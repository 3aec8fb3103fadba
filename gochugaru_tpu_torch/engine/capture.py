"""What a CUDA graph capture of the engine holds while it records.

A capture in ``thread_local`` mode forbids the capturing thread every
call that is unsafe while its stream records, and destroying a CUDA
graph is one (``CUDAGraph``'s destructor resets its graph).  Python's
cyclic garbage collector runs in whichever thread allocates, so a
collection inside a capture that frees an earlier graph -- the latency
pins of a dropped snapshot, a lookup server's graphs -- invalidates the
capture (``cudaErrorStreamCaptureInvalidated``).  ``torch.cuda.graph``
collects before it captures; the engine's captures (engine/latency.py,
engine/spmm.py) do not synchronise the device or empty the allocator's
cache as that context does, so they pause the collector while they
record.  The collector's switch is process-wide, so the captures also
take one process-wide lock: one capture must not turn the collector back
on while another, in another thread, still records.  Nothing is acquired
inside it, so it cannot order against another lock.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

_LOCK = threading.Lock()


@contextmanager
def recording():
    """Hold around ``capture_begin`` .. ``capture_end``: captures of
    every engine in the process, one at a time, with the cyclic garbage
    collector paused (left off if the caller had it off)."""
    with _LOCK:
        was = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if was:
                gc.enable()
