"""Reverse-CSR index: the tables of the lookup frontier (host-only).

Check probes ask "does edge (rel, res, subj, srel) exist" — the point
tables of engine/flat.py answer that by hashing the FULL key.
LookupResources/LookupSubjects ask the inverse questions: "every edge
whose SUBJECT is this userset" (reverse) and "every edge hanging off
this RESOURCE" (forward) — ragged fan-out enumeration, which a
cap-bounded point probe cannot serve.  This module builds the three
enumeration views the frontier engine (engine/spmv.py) hops over:

- ``rvx``/``rv_off`` — all primary edges keyed by ``k2`` (packed
  (subject, srel1)): one hop of reverse reachability;
- ``rax``/``ra_off`` — arrow rows keyed by CHILD node: reverse
  tupleset-traversal (parents granting through ``ts->perm``);
- ``fwx``/``fw_off`` — all primary edges keyed by ``k1`` (packed
  (slot, resource)): forward enumeration for LookupSubjects.

Layout: rows bucket by ``mix32`` of the single group-key column and are
sorted WITHIN each bucket by full row identity (key, payload, gates) —
so every key's rows form one contiguous run the device finds with a
short per-bucket binary search (``cap`` bounds the bisect depth), and
the layout is a pure function of the row SET, independent of feed
order.

Bucket sizing always uses the frozen lean geometry (``REV_HK``): fans
are unbounded by design (a popular userset IS the workload), so the
bisect cost grows with log(fan) instead of the offsets array growing.

``build_rev_full`` sorts all rows once and slices the shards (the
single-device build, ``M = 1``, and the full-then-stack sharded build);
``build_rev_partitioned`` sends rows to their owner shard first and
builds each shard on its own (``build_rev_shards``) — the same bits,
O(E/M) scratch a shard (the sharded default, engine/flat.py
``build_flat_arrays_sharded``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .hash import _ceil_pow2
from .partition import (
    ColsAt, PointGeom, ShardSlices, point_geom, shard_order,
)

#: geometry kwargs of every reverse-index bucket table: pow2(n) buckets,
#: growth frozen (max_factor=1) — the bisect absorbs deep buckets
REV_HK = dict(lean=True, max_factor=1)


def rev_geom(h: np.ndarray, M: int, *, pad: int = 64) -> PointGeom:
    """Bucket geometry of one reverse-index view (frozen lean sizing).
    ``cap`` is the max bucket occupancy — the frontier kernel's bisect
    step bound, not a probe unroll count."""
    return point_geom(h, M, pad=pad, **REV_HK)


def _sort_words(lb: np.ndarray, cols: Sequence[np.ndarray]):
    """The stable permutation sorting rows by (bucket, full row
    identity): up to 5 int32 identity columns + the bucket pack into
    three uint64 words (bias int32 → uint32 so the word order matches
    signed column order)."""
    from ..native.sort import sortperm_words

    assert len(cols) <= 5, "reverse-index rows carry at most 5 columns"
    B = np.int64(1) << np.int64(32)

    def u(c: np.ndarray) -> np.ndarray:
        return c.astype(np.int64) + np.int64(2**31)

    padded = [u(c) for c in cols] + [
        np.zeros(lb.shape[0], np.int64) for _ in range(5 - len(cols))
    ]
    words = [
        lb.astype(np.int64) * B + padded[0],
        padded[1] * B + padded[2],
        padded[3] * B + padded[4],
    ]
    fallback = tuple(reversed([lb] + [np.asarray(c) for c in cols]))
    return sortperm_words(words, fallback)


def _fill_shard(blk: np.ndarray, cols: Sequence[np.ndarray]) -> None:
    from ..native.sort import fill_interleaved

    n = int(cols[0].shape[0]) if cols else 0
    if n and not fill_interleaved(blk, list(cols), None):
        for j, c in enumerate(cols):
            blk[:n, j] = c


def _shard_off(lb: np.ndarray, bpd: int) -> np.ndarray:
    off = np.zeros(bpd + 1, np.int64)
    np.cumsum(np.bincount(lb, minlength=bpd), out=off[1:])
    return off.astype(np.int32)


def build_rev_shards(
    geom: PointGeom,
    w: int,
    shard_h: Callable[[int], np.ndarray],
    shard_cols: Callable[[int, np.ndarray], List[np.ndarray]],
    owned: Optional[Sequence[int]] = None,
):
    """Shard-at-a-time reverse-index build: (off int32[M·(bpd+1)],
    tbl int32[M·R_pad, w]).  ``shard_h(s)`` returns shard s's row hashes
    (any order — the identity sort canonicalizes); ``shard_cols(s, perm)``
    the row columns gathered at shard-local positions ``perm``.  The
    permutation applied is (local bucket, full row identity) —
    feed-order-independent, hence the same bits from any partitioning
    of the same row set."""
    M, bpd, R_pad = geom.M, geom.bpd, geom.R_pad
    full = owned is None
    shards = range(M) if full else sorted(owned)
    if full:
        off = np.empty(M * (bpd + 1), np.int32)
        tbl = np.full((M * R_pad, w), -1, np.int32)
    else:
        off_b: Dict[int, np.ndarray] = {}
        tbl_b: Dict[int, np.ndarray] = {}
    for s in shards:
        h_s = shard_h(s)
        lb = (h_s & np.uint32(bpd - 1)).astype(np.int64)
        # the identity sort runs per shard with the local bucket as the
        # major word — one fused sortperm_words pass over the shard's rows
        cols0 = shard_cols(s, np.arange(h_s.shape[0], dtype=np.int64))
        perm = _sort_words(lb, cols0)
        cols = [np.ascontiguousarray(c[perm], np.int32) for c in cols0]
        if full:
            off[s * (bpd + 1) : (s + 1) * (bpd + 1)] = _shard_off(lb, bpd)
            blk = tbl[s * R_pad : (s + 1) * R_pad]
        else:
            off_b[s] = _shard_off(lb, bpd)
            blk = np.full((R_pad, w), -1, np.int32)
            tbl_b[s] = blk
        if cols and cols[0].shape[0]:
            _fill_shard(blk, cols)
    if full:
        return off, tbl
    return (
        ShardSlices((M * (bpd + 1),), np.dtype(np.int32), bpd + 1, off_b),
        ShardSlices((M * R_pad, w), np.dtype(np.int32), R_pad, tbl_b),
    )


def build_rev_partitioned(
    h: np.ndarray,
    cols_at: ColsAt,
    geom: PointGeom,
    w: int,
    owned: Optional[Sequence[int]] = None,
):
    """Partition-FIRST reverse-index build: rows go to their owner shard
    (high bits of the bucket) with one stable counting sort, then each
    shard's slice builds independently — O(E/M) sort/gather scratch per
    shard."""
    order, starts = shard_order(h, geom.size, geom.M)

    def shard_h(s: int) -> np.ndarray:
        return h[order[starts[s] : starts[s + 1]]]

    def shard_cols(s: int, perm: np.ndarray) -> List[np.ndarray]:
        rows = order[starts[s] : starts[s + 1]][perm]
        return cols_at(rows)

    return build_rev_shards(geom, w, shard_h, shard_cols, owned)


def build_rev_full(
    h: np.ndarray,
    cols: Sequence[np.ndarray],
    geom: PointGeom,
    w: int,
):
    """ONE global sort by (bucket, row identity), then per-shard slices:
    (off int32[M·(bpd+1)], tbl int32[M·R_pad, w])."""
    M, bpd, R_pad = geom.M, geom.bpd, geom.R_pad
    size = geom.size
    cc = [np.ascontiguousarray(c, np.int32) for c in cols]
    bucket = (h & np.uint32(size - 1)).astype(np.int64)
    # global bucket == owner·bpd + local bucket, so one sort by (bucket,
    # identity) IS (owner, local bucket, identity)
    perm = _sort_words(bucket, cc)
    bs = bucket[perm]
    owner = bs >> np.int64((bpd).bit_length() - 1)
    lb = bs & np.int64(bpd - 1)
    scols = [c[perm] for c in cc]
    off = np.empty(M * (bpd + 1), np.int32)
    tbl = np.full((M * R_pad, w), -1, np.int32)
    starts = np.zeros(M + 1, np.int64)
    np.cumsum(np.bincount(owner, minlength=M), out=starts[1:])
    for s in range(M):
        lo, hi = int(starts[s]), int(starts[s + 1])
        off[s * (bpd + 1) : (s + 1) * (bpd + 1)] = _shard_off(lb[lo:hi], bpd)
        _fill_shard(
            tbl[s * R_pad : (s + 1) * R_pad], [c[lo:hi] for c in scols]
        )
    return off, tbl


def rev_meta_kw(ge: PointGeom, ga: PointGeom, gf: Optional[PointGeom]) -> Dict:
    """FlatMeta field updates for one built reverse index (pow2-bucketed
    caps: the bisect depth is static per table)."""
    kw = dict(
        has_rev=True,
        rv_cap=_ceil_pow2(max(ge.cap, 1), 1),
        ra_cap=_ceil_pow2(max(ga.cap, 1), 1),
    )
    if gf is not None:
        kw.update(has_fw=True, fw_cap=_ceil_pow2(max(gf.cap, 1), 1))
    return kw
