"""Bucket geometry from key hashes alone (host-only).

The reverse-CSR lookup index (engine/rev.py) sizes its bucket tables
with ``point_geom``: the final pow2 bucket count, the max bucket
occupancy and the padded row count, decided from the key HASHES before
any table exists — ``build_hash``'s sizing loop (including the ≥16M-row
growth freeze), reproduced bit for bit.  The shard helpers
(``shard_owner``/``shard_order``) serve the frozen branch's per-shard
cap pass; the single-GPU port always builds with ``M = 1``.  The
partition-first sharded builds wait for the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from .hash import _ceil_pow2, mix32


def _hash_cols(cols: Sequence[np.ndarray]) -> np.ndarray:
    """mix32 over int32 key columns — native parallel pass when available,
    numpy otherwise (bit-identical by the native parity contract)."""
    from ..native.sort import mix32_native

    cc = [np.ascontiguousarray(c, np.int32) for c in cols]
    h = mix32_native(cc)
    if h is None:
        h = mix32(cc, np)
    return h


@dataclass(frozen=True)
class PointGeom:
    """Global geometry of one bucketed point table, as ``build_hash`` +
    the stacked layout would decide it — reproduced from the key hashes
    so the build agrees on shapes before any table exists."""

    size: int  # final pow2 bucket count
    cap: int  # max bucket occupancy (probe unroll count)
    n: int  # entries
    M: int  # shard count
    R_pad: int  # stacked rows per shard (pow2)

    @property
    def bpd(self) -> int:
        return self.size // self.M


def point_geom(
    h_full: np.ndarray,
    M: int,
    *,
    target_cap: int = 4,
    min_size: int = 8,
    max_factor: int = 8,
    lean: bool = False,
    pad: int = 64,
    return_order: bool = False,
):
    """Replicates ``build_hash``'s sizing loop (including the ≥16M-row
    growth freeze) and the stacked R_pad from ``h_full`` alone.  One
    transient O(size) histogram; no rows permutation, no offsets —
    EXCEPT the frozen branch, whose per-shard cap pass runs the owner
    partition anyway: ``return_order=True`` returns ``(geom, order_
    starts)`` (``order_starts`` is None whenever the histogram branch
    ran)."""
    n = int(h_full.shape[0])
    order_starts: Optional[Tuple[np.ndarray, np.ndarray]] = None
    if n == 0:
        geom = PointGeom(
            size=min_size, cap=1, n=0, M=M,
            R_pad=_ceil_pow2(max(pad, 1)),
        )
        return (geom, None) if return_order else geom
    size = _ceil_pow2(n if lean else 2 * n, min_size)
    if n > (1 << 24):
        # growth frozen (build_hash's own rule): the final size is known
        # up front, so cap comes from per-shard O(size/M) histograms over
        # the stable owner partition.  A bucket lives entirely in one
        # shard, so the max over shard-local histograms IS the global cap
        order, starts = shard_order(h_full, size, M)
        order_starts = (order, starts)
        bpd = size // M
        cap = 1
        for s in range(M):
            h_s = h_full[order[starts[s] : starts[s + 1]]]
            if h_s.shape[0]:
                cap = max(cap, int(np.bincount(
                    (h_s & np.uint32(bpd - 1)).astype(np.int64),
                    minlength=1,
                ).max()))
        shard_rows = np.diff(starts)
    else:
        limit = size * max_factor
        while True:
            counts = np.bincount(
                (h_full & np.uint32(size - 1)).astype(np.int64),
                minlength=size,
            )
            cap = int(counts.max())
            if cap <= target_cap or size >= limit:
                break
            size <<= 1
        shard_rows = counts.reshape(M, size // M).sum(axis=1)
    geom = PointGeom(
        size=size, cap=cap, n=n, M=M,
        R_pad=_ceil_pow2(int(shard_rows.max()) + max(pad, cap)),
    )
    return (geom, order_starts) if return_order else geom


def shard_owner(h: np.ndarray, size: int, M: int) -> np.ndarray:
    """Owning shard of each hash: the HIGH bits of the bucket index
    (bucket // bpd)."""
    shift = np.uint32((size // M).bit_length() - 1)
    return ((h & np.uint32(size - 1)) >> shift).astype(np.uint32)


def shard_order(
    h_full: np.ndarray, size: int, M: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(order, starts): stable permutation grouping rows by owning shard,
    plus the shard boundaries (int64[M+1]).  ``order[starts[s]:
    starts[s+1]]`` are shard s's rows in their ORIGINAL relative order."""
    from ..native.sort import hash_index32

    n = int(h_full.shape[0])
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(M + 1, np.int64)
    owner = shard_owner(h_full, size, M)
    got = hash_index32(owner, M)  # counting sort by owner (= owner & (M-1))
    if got is not None:
        rows, off, _cap = got
        return rows.astype(np.int64), off.astype(np.int64)
    ow = owner.astype(np.int64)
    order = np.argsort(ow, kind="stable")
    off = np.zeros(M + 1, np.int64)
    np.cumsum(np.bincount(ow, minlength=M), out=off[1:])
    return order, off
