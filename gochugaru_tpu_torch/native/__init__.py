"""Native runtime layer (C++ via ctypes).

The reference delegates all heavy lifting to a server; here the host-side
ingest pipeline is part of the framework, and its hot paths — bulk string
interning and the primary-order lexsort feeding the device's binary-search
layout — are implemented in C++ (``ingest.cpp``) and loaded through a C
ABI.  Everything degrades gracefully: if the shared library can't be
built/loaded (no compiler, exotic platform), ``available()`` is False and
callers fall back to the pure-numpy/python paths with identical results.

The library is compiled on first use with g++ (ctypes needs only a .so)
into the package's git-ignored build directory ``_build/``, under a name
carrying the hash of ``ingest.cpp`` — a stale or foreign binary is never
loaded.  The build writes a temporary file and renames it into place, so
concurrent first uses (test workers) never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ingest.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _src_hash() -> Optional[str]:
    try:
        with open(_SRC, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


def _so_path(src_hash: str) -> str:
    return os.path.join(_BUILD, f"libgochugaru_ingest-{src_hash[:16]}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmds = [
        ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
         _SRC, "-o", tmp],
        # no-OpenMP fallback (serial sort)
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
    ]
    for cmd in cmds:
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, so)
                return True
        except (OSError, subprocess.TimeoutExpired):
            return False
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            want = _src_hash()
            if want is None:
                return None
            so = _so_path(want)
            if not os.path.exists(so) and not _build(so):
                return None
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        c = ctypes
        lib.gi_new.restype = c.c_void_p
        lib.gi_free.argtypes = [c.c_void_p]
        lib.gi_size.argtypes = [c.c_void_p]
        lib.gi_size.restype = c.c_int64
        lib.gi_intern_batch.argtypes = [
            c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int64,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        ]
        lib.gi_lookup_batch.argtypes = lib.gi_intern_batch.argtypes
        lib.gi_node_types.argtypes = [c.c_void_p, c.POINTER(c.c_int32), c.c_int64]
        lib.gi_key.argtypes = [
            c.c_void_p, c.c_int64, c.c_char_p, c.c_int64, c.POINTER(c.c_int32),
        ]
        lib.gi_key.restype = c.c_int64
        lib.gi_keys_batch.argtypes = [
            c.c_void_p, c.POINTER(c.c_int64), c.c_int64, c.c_char_p,
            c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        ]
        lib.gi_keys_batch.restype = c.c_int64
        for name in ("gi_lexsort4",):
            fn = getattr(lib, name)
            fn.argtypes = [
                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                c.c_int64, c.POINTER(c.c_int64),
            ]
        lib.gi_lexsort2.argtypes = [
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.c_int64, c.POINTER(c.c_int64),
        ]
        lib.gi_argsort1.argtypes = [
            c.POINTER(c.c_int32), c.c_int64, c.POINTER(c.c_int64),
        ]
        lib.gi_join_sorted2.argtypes = [
            c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int64,
            c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int64,
            c.POINTER(c.c_int64),
        ]
        lib.gi_sortperm3.argtypes = [
            c.POINTER(c.c_uint64), c.POINTER(c.c_uint64),
            c.POINTER(c.c_uint64), c.c_int64, c.POINTER(c.c_int64),
        ]
        lib.gi_hash_index32.argtypes = [
            c.POINTER(c.c_uint32), c.c_int64, c.c_int64,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        ]
        lib.gi_hash_index32.restype = c.c_int64
        lib.gi_mix32.argtypes = [
            c.POINTER(c.c_int64), c.c_int64, c.c_int64, c.POINTER(c.c_uint32),
        ]
        lib.gi_take32.argtypes = [
            c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.c_int64,
            c.POINTER(c.c_int32),
        ]
        lib.gi_take64.argtypes = [
            c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int64,
            c.POINTER(c.c_int64),
        ]
        lib.gi_interleave32.argtypes = [
            c.POINTER(c.c_int64), c.c_int64, c.POINTER(c.c_int32), c.c_int64,
            c.POINTER(c.c_int32), c.c_int64,
        ]
        lib.gi_run_bounds64.argtypes = [
            c.POINTER(c.c_int64), c.c_int64, c.POINTER(c.c_int64),
        ]
        lib.gi_run_bounds64.restype = c.c_int64
        lib.gi_run_bounds32.argtypes = [
            c.POINTER(c.c_int32), c.c_int64, c.POINTER(c.c_int64),
        ]
        lib.gi_run_bounds32.restype = c.c_int64
        lib.gi_pack32.argtypes = [
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int64, c.c_int64,
            c.POINTER(c.c_int32),
        ]
        lib.gi_msrel1.argtypes = [
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int64, c.c_int64,
            c.POINTER(c.c_int32),
        ]
        _lib = lib
        return _lib


#: test hook + escape hatch: GOCHUGARU_NATIVE=0 (or set_enabled(False))
#: forces every native-accelerated path onto its pure-numpy fallback —
#: tests/test_prepare_parity.py builds both ways and asserts bitwise
#: equality of every produced table.
_forced_off = os.environ.get("GOCHUGARU_NATIVE", "").strip() == "0"


def set_enabled(on: bool) -> None:
    global _forced_off
    _forced_off = not on


def enabled() -> bool:
    """Whether the native layer is currently allowed (it may still be
    unavailable if the library failed to build)."""
    return not _forced_off


def available() -> bool:
    return lib() is not None


def lib() -> Optional[ctypes.CDLL]:
    if _forced_off:
        return None
    return _load()
