"""The general traffic generator: draws from a traffic file's parameters,
the configuration's ``world_seed`` and ``--seed``, never from the program.

What a run asks for (the checks, the lookups, the gaps between arrivals)
is drawn from the configuration's ``world_seed`` over the generator's
objects, then mapped through the world's relabelling; ``--seed`` draws
only the order.  Every seed so sends the same work, in another order and
under other ids.  Each stream of draws has its own generator,
``rng(seed, stream)``.  Checks are (resource index, permission index,
subject index) over the configuration's ``check`` block: resources
uniform, permissions uniform over its list, subjects uniform or Zipf
(``{"zipf": a}``, the rank ``k`` of a Zipf(a) draw mapped to subject
``(k - 1) mod n``, as ``bench9_serve``'s draw).
"""

from __future__ import annotations

import numpy as np

STREAM_WORLD_QUERIES = 1
STREAM_ARRIVALS = 2
STREAM_SAMPLE = 3
STREAM_CONTROL = 4
STREAM_TRACE = 5


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def draw_index(r: np.random.Generator, n_objects: int, dist, size: int) -> np.ndarray:
    if dist == "uniform":
        return r.integers(0, n_objects, size)
    if isinstance(dist, dict) and "zipf" in dist:
        return (r.zipf(float(dist["zipf"]), size) - 1) % n_objects
    raise ValueError(f"traffic: unknown distribution {dist!r}")


def draw_objects(world, type_name: str, dist, size: int, r: np.random.Generator) -> np.ndarray:
    """``size`` objects of a type, by the generator's index, mapped to the
    world's."""
    idx = draw_index(r, world.n(type_name), dist, size)
    return world.perm[type_name][idx] if type_name in world.perm else idx


def draw_checks(world, check: dict, traffic: dict, size: int, r: np.random.Generator):
    """(res, perm, subj) index columns of ``size`` checks."""
    res = draw_objects(world, check["resource"], traffic.get("resources", "uniform"), size, r)
    perm = r.integers(0, len(check["permissions"]), size)
    subj = draw_objects(world, check["subject"], traffic.get("subjects", "uniform"), size, r)
    return res, perm, subj


def poisson_arrivals(rate_per_s: float, seconds: float, content: np.random.Generator,
                     order: np.random.Generator) -> np.ndarray:
    """``round(rate_per_s * seconds)`` arrival times in [0, seconds): the
    exponential gaps of a Poisson process drawn from ``content`` and scaled
    to span the window, sent in an order drawn from ``order``."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = content.exponential(1.0, n + 1)
    gaps *= seconds / gaps.sum()
    return np.cumsum(order.permutation(gaps))[:n]
