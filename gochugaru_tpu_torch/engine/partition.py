"""Partition-first table builds: bucket geometry from key hashes alone,
then each model shard's slice of a stacked table built on its own
(host-only).

The bucket-sharded layout of engine/flat.py ``build_flat_arrays_sharded``
stacks every hash and range table per model shard: shard s of M owns
buckets [s·bpd, (s+1)·bpd) (bpd = size/M, both pow2).  Building it
full-then-stack costs O(E) host scratch per table; this module inverts
the order:

1. **geometry** — the final table's pow2 bucket count, probe cap and
   stacked pads come from the key HASHES alone (``point_geom`` /
   ``range_geom`` reproduce ``build_hash``'s sizing loop bit for bit),
   so the shapes are agreed before anything is built;
2. **partition** — a row's owning shard is the high bits of its bucket
   (``shard_owner``), found with one stable counting sort
   (``shard_order``);
3. **build local** — a shard's slice is built from its own rows: the
   shard-local bucket is the global bucket's low bits, and a stable
   local counting sort reproduces the global permutation restricted to
   the shard (``local_bucket_index``), so ``stack_point`` /
   ``stack_range`` give the same bits as the full-then-stack
   ``_stack_point`` / ``_stack_range`` of engine/flat.py with O(E/M)
   peak scratch a shard.

The reverse-CSR lookup index (engine/rev.py) sizes its bucket tables with
``point_geom`` too.  Owned-subset builds (``owned=``) return
``ShardSlices``: only the listed shards' blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


@dataclass(frozen=True)
class RangeGeom:
    """Global geometry of one range view (distinct-key group table over a
    sorted column + its permuted row table), matching
    ``build_range_hash`` + ``_stack_range``."""

    gh: PointGeom  # group-key hash geometry (G_pad = gh.R_pad)
    G: int  # distinct keys
    rows: int  # underlying row count
    R_pad: int  # stacked rows per shard (pow2)
    max_run: int  # longest group (RangeIndex.max_run)

    @property
    def cap(self) -> int:
        return self.gh.cap

    @property
    def G_pad(self) -> int:
        return self.gh.R_pad


def range_geom(
    gk: np.ndarray,
    lens: np.ndarray,
    h_g: np.ndarray,
    M: int,
    *,
    min_size: int = 8,
    fan_pad: int = 64,
    max_factor: int = 8,
    lean: bool = False,
) -> RangeGeom:
    """Geometry from the distinct group keys' hashes + group lengths:
    per-shard row totals come from one weighted owner histogram (a
    bucket's groups — and hence their rows — live entirely in one
    shard), no partition pass."""
    gh = point_geom(
        h_g, M, min_size=min_size, pad=64, max_factor=max_factor, lean=lean
    )
    G = int(gk.shape[0])
    if G:
        owner = shard_owner(h_g, gh.size, M).astype(np.int64)
        row_counts = np.bincount(
            owner, weights=lens.astype(np.float64), minlength=M
        ).astype(np.int64)
    else:
        row_counts = np.zeros(M, np.int64)
    return RangeGeom(
        gh=gh, G=G, rows=int(lens.sum()) if G else 0,
        R_pad=_ceil_pow2(int(row_counts.max() if M else 1) + max(fan_pad, 64)),
        max_run=int(lens.max()) if G else 0,
    )


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


def local_bucket_index(
    h_s: np.ndarray, bpd: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, off) of ONE shard's rows by shard-local bucket.  The local
    bucket is the global bucket's low bits (bpd pow2), so a stable
    counting sort here == the global ``build_hash`` permutation
    restricted to the shard, and ``off`` == the normalized local offsets
    ``_stack_point`` computes by subtracting the shard's base."""
    from ..native.sort import hash_index32

    got = hash_index32(np.ascontiguousarray(h_s, np.uint32), bpd)
    if got is not None:
        rows, off, _cap = got
        return rows.astype(np.int64), off
    hb = (h_s & np.uint32(bpd - 1)).astype(np.int64)
    counts = np.bincount(hb, minlength=bpd)
    off = np.zeros(bpd + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return np.argsort(hb, kind="stable"), off.astype(np.int32)


@dataclass
class ShardSlices:
    """A model-sharded stacked array held only for OWNED shards: the
    blocks of the listed shards, each ``per`` leading rows."""

    shape: Tuple[int, ...]
    dtype: np.dtype
    per: int  # leading-axis rows per shard
    blocks: Dict[int, np.ndarray]

    def to_full(self) -> np.ndarray:
        """The full stacked array (every shard owned)."""
        M = self.shape[0] // self.per
        out = np.empty(self.shape, self.dtype)
        for s in range(M):
            out[s * self.per : (s + 1) * self.per] = self.blocks[s]
        return out

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.blocks.values())


#: cols_at(rows) -> gathered int32 columns for the given row ids, in that
#: row order
ColsAt = Callable[[np.ndarray], List[np.ndarray]]


def gather_cols(cols: Sequence[np.ndarray]) -> ColsAt:
    """ColsAt over plain full columns (native parallel gathers)."""
    from ..native.sort import take32

    cc = [np.ascontiguousarray(c, np.int32) for c in cols]

    def at(rows: np.ndarray) -> List[np.ndarray]:
        idx = np.ascontiguousarray(rows, np.int64)
        return [take32(c, idx) for c in cc]

    return at


def _fill_block(blk: np.ndarray, vals: List[np.ndarray]) -> None:
    from ..native.sort import fill_interleaved

    n = int(vals[0].shape[0]) if vals else 0
    if n and not fill_interleaved(blk, vals, None):
        for j, c in enumerate(vals):
            blk[:n, j] = c


def stack_point_shards(
    geom: PointGeom,
    w: int,
    shard_h: Callable[[int], np.ndarray],
    shard_cols: Callable[[int, np.ndarray], List[np.ndarray]],
    owned: Optional[Sequence[int]] = None,
):
    """Shard-at-a-time ``_stack_point``: the same (off, tbl) bits with
    O(E/M) peak scratch.  ``shard_h(s)`` returns shard s's row hashes in
    their global relative order; ``shard_cols(s, perm)`` the payload
    columns gathered at the shard-LOCAL positions ``perm`` (the bucket
    permutation).  ``owned=None`` assembles full arrays; a shard subset
    returns ShardSlices holding only those blocks."""
    M, bpd, R_pad = geom.M, geom.bpd, geom.R_pad
    full = owned is None
    shards = range(M) if full else sorted(owned)
    if full:
        off = np.empty(M * (bpd + 1), np.int32)
        tbl = np.full((M * R_pad, w), -1, np.int32)
    else:
        off_blocks: Dict[int, np.ndarray] = {}
        tbl_blocks: Dict[int, np.ndarray] = {}
    for s in shards:
        h_s = shard_h(s)
        perm, off_local = local_bucket_index(h_s, bpd)
        n_s = int(h_s.shape[0])
        if full:
            off[s * (bpd + 1) : (s + 1) * (bpd + 1)] = off_local
            blk = tbl[s * R_pad : (s + 1) * R_pad]
        else:
            off_blocks[s] = np.ascontiguousarray(off_local, np.int32)
            blk = np.full((R_pad, w), -1, np.int32)
            tbl_blocks[s] = blk
        if n_s:
            _fill_block(blk, shard_cols(s, perm))
    if full:
        return off, tbl
    return (
        ShardSlices((M * (bpd + 1),), np.dtype(np.int32), bpd + 1, off_blocks),
        ShardSlices((M * R_pad, w), np.dtype(np.int32), R_pad, tbl_blocks),
    )


def stack_point(
    h_full: np.ndarray,
    cols_at: ColsAt,
    geom: PointGeom,
    w: int,
    owned: Optional[Sequence[int]] = None,
    order: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """``_stack_point(build_hash(keys, ...), cols, M)`` from full columns,
    built shard-at-a-time: partitions rows by owner once, then each
    shard's slice independently.  ``order`` accepts a precomputed
    (order, starts) owner partition of the SAME ``h_full`` —
    ``point_geom(..., return_order=True)``'s frozen-branch byproduct —
    so the >16M-row builds don't pay the counting sort twice."""
    if order is None:
        order, starts = shard_order(h_full, geom.size, geom.M)
    else:
        order, starts = order

    def shard_h(s: int) -> np.ndarray:
        return h_full[order[starts[s] : starts[s + 1]]]

    def shard_cols(s: int, perm: np.ndarray) -> List[np.ndarray]:
        rows = order[starts[s] : starts[s + 1]][perm]
        return cols_at(rows)

    return stack_point_shards(geom, w, shard_h, shard_cols, owned)


def stack_range_shards(
    geom: RangeGeom,
    w: int,
    shard_groups: Callable[
        [int], Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    rows_at: ColsAt,
    owned: Optional[Sequence[int]] = None,
):
    """Shard-at-a-time ``_stack_range``: the same (goff, gtbl, rows_tbl)
    bits.  ``shard_groups(s)`` returns the shard's (h_g, gk, glo, lens)
    in global group order (glo in the row-id space ``rows_at``
    understands); the row table is each shard's groups' rows
    concatenated in local bucket order, locally re-offset — exactly the
    global bucket-ordered row permutation restricted to the shard."""
    M, bpd = geom.gh.M, geom.gh.bpd
    G_pad, R_pad = geom.G_pad, geom.R_pad
    full = owned is None
    shards = range(M) if full else sorted(owned)
    if full:
        goff = np.empty(M * (bpd + 1), np.int32)
        gtbl = np.full((M * G_pad, 3), -1, np.int32)
        rows_tbl = np.full((M * R_pad, w), -1, np.int32)
    else:
        goff_b: Dict[int, np.ndarray] = {}
        gtbl_b: Dict[int, np.ndarray] = {}
        rows_b: Dict[int, np.ndarray] = {}
    for s in shards:
        h_s, gk_s, glo_s, lens_s = shard_groups(s)
        perm, off_local = local_bucket_index(h_s, bpd)
        n_g = int(h_s.shape[0])
        if full:
            goff[s * (bpd + 1) : (s + 1) * (bpd + 1)] = off_local
            gblk = gtbl[s * G_pad : (s + 1) * G_pad]
            rblk = rows_tbl[s * R_pad : (s + 1) * R_pad]
        else:
            goff_b[s] = np.ascontiguousarray(off_local, np.int32)
            gblk = np.full((G_pad, 3), -1, np.int32)
            rblk = np.full((R_pad, w), -1, np.int32)
            gtbl_b[s], rows_b[s] = gblk, rblk
        if not n_g:
            continue
        lens_f = lens_s[perm].astype(np.int64)
        r_end = np.cumsum(lens_f)
        r_start = r_end - lens_f
        gblk[:n_g, 0] = gk_s[perm]
        gblk[:n_g, 1] = r_start.astype(np.int32)
        gblk[:n_g, 2] = r_end.astype(np.int32)
        total = int(r_end[-1])
        if total:
            row_src = (
                np.repeat(glo_s[perm].astype(np.int64), lens_f)
                + np.arange(total, dtype=np.int64)
                - np.repeat(r_start, lens_f)
            )
            _fill_block(rblk, rows_at(row_src))
    if full:
        return goff, gtbl, rows_tbl
    return (
        ShardSlices((M * (bpd + 1),), np.dtype(np.int32), bpd + 1, goff_b),
        ShardSlices((M * G_pad, 3), np.dtype(np.int32), G_pad, gtbl_b),
        ShardSlices((M * R_pad, w), np.dtype(np.int32), R_pad, rows_b),
    )


def stack_range(
    gk: np.ndarray,
    glo: np.ndarray,
    lens: np.ndarray,
    h_g: np.ndarray,
    rows_at: ColsAt,
    geom: RangeGeom,
    w: int,
    owned: Optional[Sequence[int]] = None,
):
    """``_stack_range(build_range_hash(k, ...), row_cols, M, fan_pad)``
    from full group/row columns, built shard-at-a-time."""
    order, starts = shard_order(h_g, geom.gh.size, geom.gh.M)
    glo64 = glo.astype(np.int64)
    lens64 = lens.astype(np.int64)

    def shard_groups(s: int):
        gi = order[starts[s] : starts[s + 1]]
        return h_g[gi], gk[gi], glo64[gi], lens64[gi]

    return stack_range_shards(geom, w, shard_groups, rows_at, owned)
