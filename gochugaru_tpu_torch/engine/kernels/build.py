"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes).  Libraries land in
``gochugaru_tpu_torch/_build/`` (git-ignored), named by the hash of their
source and the shared headers, so a stale binary is never loaded.  Nothing builds at import
time: the first launch of a kernel builds it, and ``build_all`` builds
every source in parallel (one ``nvcc`` per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel source failed to compile or load."""


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, the standard
    toolkit location, or ``nvcc`` on PATH)."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on a"
                           " machine with the CUDA toolkit")


def _target(name: str) -> str:
    """The library path of one source, named by the hash of the source and
    of every shared ``csrc/*.cuh`` header it may include."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str) -> List[str]:
    return [
        nvcc(), *ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
        "-Xcompiler", "-fPIC", "-o", out, os.path.join(CSRC, name + ".cu"),
    ]


def build_all(names: List[str]) -> Dict[str, str]:
    """Compile every named source not built yet, all ``nvcc`` processes
    started together; returns {name: compiler report} (ptxas register and
    spill lines).  Raises KernelBuildError on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (tmp, out, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    reports: Dict[str, str] = {}
    failed = []
    for name, (tmp, out, p) in procs.items():
        log, _ = p.communicate()
        reports[name] = log
        if p.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            try:
                lib = ctypes.CDLL(_target(name))
            except OSError as e:
                raise KernelBuildError(f"cannot load {name}: {e}") from e
            _libs[name] = lib
        return lib
