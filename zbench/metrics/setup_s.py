"""Seconds from process start to the window's first request: imports, the
CUDA context, the world from the seed, the store import, the first prepare
(and kernel build, on a checkout's first run) and the cell's warm-up."""


def read(run):
    return run.setup_s
