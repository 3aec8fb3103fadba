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

``partition_feed`` runs the same discipline from a RAW store feed: a
process materializes only the feed rows of the shards it owns (plus the
replicated membership subgraph) and builds the stacked tables from them
— the partitioned serve's and the multi-process mesh's prepare
(parallel/sharded.py ``prepare_partitioned``, parallel/multihost.py).
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

    def block_for(self, index) -> np.ndarray:
        """The owned block at ``index``: a tuple of slices whose first
        starts at a shard's first row (the trailing slices, when given,
        cut the block's columns)."""
        s = (index[0].start or 0) // self.per
        blk = self.blocks[s]
        return blk[(slice(None),) + tuple(index[1:])] if len(index) > 1 else blk

    def to_full(self) -> np.ndarray:
        """The full stacked array (every shard owned)."""
        M = self.shape[0] // self.per
        out = np.empty(self.shape, self.dtype)
        for s in range(M):
            out[s * self.per : (s + 1) * self.per] = self.blocks[s]
        return out

    def map_blocks(self, fn, w: int, dtype) -> "ShardSlices":
        """A new ShardSlices with every owned block transformed (the
        packed layout packs each owned block with the spec every process
        agreed on)."""
        return ShardSlices(
            shape=(self.shape[0], w) if len(self.shape) > 1 else self.shape,
            dtype=np.dtype(dtype),
            per=self.per,
            blocks={s: fn(b) for s, b in self.blocks.items()},
        )

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


# ---------------------------------------------------------------------------
# feed partition: O(E/M) host memory per process
# ---------------------------------------------------------------------------


@dataclass
class FeedPartition:
    """One process's share of a bucket-partitioned store feed, fully
    prepared: the bucket-filtered Snapshot (owned rows + replicated
    membership subgraph), the stacked flat tables (ShardSlices for the
    O(E) tables — only owned blocks exist; plain full arrays for the
    globally-small ones), and the FlatMeta every process agrees on.
    ``ShardedEngine.prepare_partitioned`` places it on a mesh: each
    ShardSlices block only at the positions of its shard."""

    snapshot: object  # store.snapshot.Snapshot (bucket-filtered)
    arrays: Dict[str, object]  # np.ndarray | ShardSlices
    meta: object  # engine.flat.FlatMeta
    owned: Tuple[int, ...]
    M: int
    #: fold maintenance state (engine/fold.py FoldState, armed with
    #: maps/N) when the fold committed — carried onto the DeviceSnapshot
    #: so incremental prepares keep the fold instead of downgrading
    fold_state: object = None


def _owned_mask_of(owner: np.ndarray, M: int, owned) -> np.ndarray:
    m = np.zeros(M, bool)
    m[np.asarray(owned, np.int64)] = True
    return m[owner.astype(np.int64)]


def snapshot_raw_columns(snap, copy: bool = False) -> Dict[str, np.ndarray]:
    """The raw pre-interned column dict ``partition_feed`` consumes,
    from a resident Snapshot.  The srel re-encoding (``e_srel1 - 1``,
    -1 = direct subject) is the feed's convention and is load-bearing —
    every caller must agree on it, which is why this is THE helper.
    ``copy=True`` hands the feed private arrays (the feed releases its
    refs as it goes but callers that keep using the snapshot may want
    isolation anyway)."""
    cp = (lambda a: a.copy()) if copy else (lambda a: a)
    return dict(
        res=cp(snap.e_res), rel=cp(snap.e_rel), subj=cp(snap.e_subj),
        srel=(snap.e_srel1.astype(np.int32) - 1),
        caveat=cp(snap.e_caveat), ctx=cp(snap.e_ctx),
        exp_us=cp(snap.e_exp_us),
    )


def partition_feed(
    revision: int,
    compiled,
    interner,
    cols: Dict[str, np.ndarray],
    config,
    model_size: int,
    owned: Optional[Sequence[int]] = None,
    *,
    contexts: Optional[list] = None,
    epoch_us: Optional[int] = None,
    plan=None,
    serve: str = "partitioned",
) -> Optional[FeedPartition]:
    """Partition a RAW store feed by bucket-shard ownership and prepare
    the stacked flat tables from the local partitions — the multihost
    counterpart of ``build_flat_arrays_sharded`` with per-process host
    memory O(E/M·|owned|) + the replicated small state, and stacked
    arrays BITWISE-identical to the build-full-then-stack reference at
    the same feed (tests/test_feed_partition.py).

    ``cols`` holds UNSORTED pre-interned columns (res, rel, subj, srel
    with -1 = direct; optional caveat/ctx/exp_us) and is CONSUMED — the
    full-feed columns are released as soon as ownership is decided, so
    the peak holds the raw feed once, never the full sorted world.

    What stays global (replicated, derived from one streaming pass over
    the feed): the membership subgraph (``finish_snapshot`` over userset
    rows ∪ rows feeding used usersets), the flattened closure, the dense
    slot maps and node radix, the T-index JOIN (its rows partition right
    after), pus/ovf/closure tables, and every FlatMeta field.

    With ``plan`` (the engine's DevicePlan) the permission FOLD and rc
    flattening run too: their derivations read the full views through a
    stub (raw primary columns + the replicated membership snapshot's
    userset view + the transient global arrow view) and are CANONICAL —
    dedup sorts by full row identity — so the raw feed order yields the
    same rows as the sorted reference snapshot, and each owned shard's
    slice of the pf/pfu/rc stacked tables is then built independently
    by the same stable owner/local-bucket discipline (bitwise-identical
    to the full derivation; tests/test_fold_partition.py).  The csr
    closure-by-source view is replicated like the closure itself.  With
    ``plan=None`` fold/rc are declined as before (the parity oracle for
    the walked layout).

    The reverse-CSR lookup index (engine/rev.py) is DECLINED on this
    path: its shard ownership is keyed by the SUBJECT hash, not the
    primary (k1, k2) bucket the owned feed rows arrive keyed by — a
    process would need other owners' rows to build its rv slices (an
    owner exchange at feed time; ROADMAP follow-on).  Lookups on a
    feed-partitioned snapshot serve through the host walker.

    ``serve`` picks the placement the tables are built for:

    - ``"partitioned"`` (default): every O(E)-scale table materializes
      owned shard slices only — the bitwise-parity layout
      (``build_flat_arrays_sharded`` with the same plan is the oracle).
    - ``"routed"``: the owner-routed SERVING layout
      (FlatMeta.part_serve) — the O(E)-scale point tables (ehx, pfx,
      tx) keep owned-only slices; the userset/arrow/pfu/rc stacked
      tables build WHOLE on every process (they are membership- or
      group-structure-sized, exactly the state the host already
      replicates), so each device probes them locally and a routed
      query batch dispatches with no collectives
      (parallel/sharded.py).

    Returns None when the dense keys don't pack into int32 (same bail as
    the builders — such worlds use the legacy engine)."""
    import time as _time

    from ..native.sort import lexsort4
    from ..store.columns import filter_columns
    from ..store.snapshot import (
        _exp_to_rel32,
        finish_snapshot,
        partitioned_snapshot,
    )
    from ..utils import faults, metrics
    from .flat import (
        FlatMeta,
        _active_maps,
        _pack_flat,
        _until_dom,
        _arrow_data_depth,
        _ceil_pow2,
        _e_cols_at,
        _fold_packed,
        _groups_of,
        _m_srel1,
        _node_radix,
        _pack,
        _primary_hash_chunked,
        _rc_build,
        _round_cap,
        _round_fan,
        _run_maxes,
        _stack_point,
        _stack_range,
        _tindex_join,
        _uniq_small,
    )
    from .hash import build_hash, build_range_hash

    if serve not in ("partitioned", "routed"):
        raise ValueError(f"unknown serve mode {serve!r}")
    routed = serve == "routed"
    faults.fire("prepare.partition")
    _t0 = _time.perf_counter()
    M = model_size
    owned_t = tuple(range(M)) if owned is None else tuple(sorted(owned))
    # routed serving replicates the membership/group-structure tables on
    # every device; only the primary/fold point tables keep owned slices
    own_small = None if routed else owned_t
    if epoch_us is None:
        epoch_us = int(_time.time() * 1_000_000)
    contexts = contexts or []

    res = np.ascontiguousarray(cols.pop("res"), np.int32)
    rel = np.ascontiguousarray(cols.pop("rel"), np.int32)
    subj = np.ascontiguousarray(cols.pop("subj"), np.int32)
    srel1 = np.ascontiguousarray(cols.pop("srel"), np.int32) + 1
    E = int(res.shape[0])
    caveat = np.ascontiguousarray(
        cols.pop("caveat", np.zeros(E, np.int32)), np.int32
    )
    ctx = np.ascontiguousarray(
        cols.pop("ctx", np.full(E, -1, np.int32)), np.int32
    )
    exp_us = np.ascontiguousarray(
        cols.pop("exp_us", np.zeros(E, np.int64)), np.int64
    )
    exp32 = _exp_to_rel32(exp_us, epoch_us)
    cols.clear()

    num_slots = max(compiled.num_slots, 1)
    # packed (lean) mode: the same bounded bucket growth as the reference
    # builders (parity-critical), and the pack domains — all derived
    # from replicated inputs (the raw feed + membership subgraph), so
    # every process of a multihost build agrees on the packed layout
    # before any table exists
    PKD = config.packed_on()
    hk = (
        {"max_factor": config.flat_packed_max_factor, "lean": True}
        if PKD else {}
    )
    _mx = lambda *cs: max(
        [int(c.max()) for c in cs if c is not None and c.shape[0]] or [0]
    )
    dom: Dict = {
        "max_cav": _mx(caveat), "max_ctx": _mx(ctx), "until": {}, "fan": {},
    }

    # ---- replicated membership snapshot: userset rows ∪ feeders --------
    us_mask = srel1 > 0
    used = np.unique(
        subj[us_mask].astype(np.int64) * num_slots
        + (srel1[us_mask].astype(np.int64) - 1)
    )
    edge_key = res.astype(np.int64) * num_slots + rel.astype(np.int64)
    if used.shape[0]:
        pos = np.clip(np.searchsorted(used, edge_key), 0, used.shape[0] - 1)
        feeds = used[pos] == edge_key
    else:
        feeds = np.zeros(E, bool)
    del edge_key

    def _sorted_subset(rows: np.ndarray) -> Dict[str, np.ndarray]:
        sub = filter_columns(
            {
                "rel": rel, "res": res, "subj": subj, "srel1": srel1,
                "caveat": caveat, "ctx": ctx, "exp": exp32,
                "exp_us": exp_us,
            },
            rows,
        )
        o = lexsort4(sub["rel"], sub["res"], sub["subj"], sub["srel1"])
        return filter_columns(sub, o)

    mem = _sorted_subset(np.flatnonzero(us_mask | feeds))
    del feeds
    mem_snap = finish_snapshot(
        revision, compiled, interner,
        e_rel=mem["rel"], e_res=mem["res"], e_subj=mem["subj"],
        e_srel1=mem["srel1"], e_caveat=mem["caveat"], e_ctx=mem["ctx"],
        e_exp=mem["exp"], e_exp_us=mem["exp_us"],
        contexts=contexts, epoch_us=epoch_us,
    )
    del mem

    # ---- arrow view (full, transient until partitioned) ----------------
    ts = np.asarray(sorted(compiled.tupleset_slots), np.int64)
    ar_full = _sorted_subset(
        np.flatnonzero(np.isin(rel.astype(np.int64), ts) & (srel1 == 0))
    )

    from ..store.closure import build_closure

    with metrics.default.timer("prepare.closure_s"):
        cl = build_closure(mem_snap, per_source_cap=config.closure_source_cap)

    class _Stub:
        pass

    # full-view stub: raw (unsorted) primary columns + the replicated
    # membership snapshot's userset view + the transient global arrow
    # view.  fold_permissions/_rc_build read per-edge views through it;
    # their outputs are CANONICAL (dedup sorts by full row identity), so
    # the raw feed order yields the same FoldResult/ancestor closures as
    # the sorted reference snapshot — bitwise
    stub = _Stub()
    stub.compiled, stub.interner = compiled, interner
    stub.e_rel, stub.e_res, stub.e_subj, stub.e_srel1 = rel, res, subj, srel1
    stub.e_caveat, stub.e_ctx, stub.e_exp = caveat, ctx, exp32
    stub.us_rel, stub.us_res = mem_snap.us_rel, mem_snap.us_res
    stub.us_subj, stub.us_srel = mem_snap.us_subj, mem_snap.us_srel
    stub.us_caveat, stub.us_ctx = mem_snap.us_caveat, mem_snap.us_ctx
    stub.us_exp, stub.us_perm = mem_snap.us_exp, mem_snap.us_perm
    stub.pus_n, stub.pus_r = mem_snap.pus_n, mem_snap.pus_r
    stub.ar_rel, stub.ar_res = ar_full["rel"], ar_full["res"]
    stub.ar_child = ar_full["subj"]
    stub.ar_caveat, stub.ar_ctx = ar_full["caveat"], ar_full["ctx"]
    stub.ar_exp = ar_full["exp"]
    stub.num_slots, stub.num_nodes = num_slots, mem_snap.num_nodes
    stub.node_type = mem_snap.node_type
    stub.wildcard_node_of_type = mem_snap.wildcard_node_of_type

    # permission fold over the full views (engine/fold.py): the
    # derivation is leaf-/group-structure-shaped; only its TABLES are
    # stacked below (owned slices on the partitioned layout).  Folded
    # slots join the k1 radix exactly as in the reference builders
    fr = fstate = None
    if plan is not None:
        from .fold import fold_permissions

        with metrics.default.timer("prepare.fold_s"):
            got_fold = fold_permissions(stub, config, plan, cl)
        if got_fold is not None:
            fr, fstate = got_fold
    maps = _active_maps(
        stub, cl, {slot for _, slot in fr.pairs} if fr is not None else ()
    )
    N = _node_radix(stub, maps)
    if N is None:
        return None
    S1 = maps.S1

    flags = dict(
        e_hascav=bool(caveat.any()), e_hasexp=bool(exp32.any()),
        us_hascav=bool(mem_snap.us_caveat.any()),
        us_hasexp=bool(mem_snap.us_exp.any()),
        us_hasperm=bool(mem_snap.us_perm.any()),
        ar_hascav=bool(ar_full["caveat"].any()),
        ar_hasexp=bool(ar_full["exp"].any()),
    )
    wc_nodes = mem_snap.wildcard_node_of_type[
        mem_snap.wildcard_node_of_type >= 0
    ]
    has_wc_edges = bool(wc_nodes.size and np.isin(subj, wc_nodes).any())
    e_slots = tuple(int(s) for s in _uniq_small([rel], num_slots))
    us_slots = tuple(
        int(s) for s in _uniq_small([mem_snap.us_rel], num_slots)
    )
    ar_dd = _arrow_data_depth(stub)

    ms = max(8, M)
    us_gk = _pack(maps.k1[mem_snap.us_rel], N, mem_snap.us_res)
    ar_gk = _pack(maps.k1[ar_full["rel"]], N, ar_full["res"])
    cl_k1 = _pack(cl.c_src, S1, _m_srel1(maps, cl.c_srel1))
    cl_k2 = _pack(cl.c_g, S1, maps.k2[cl.c_grel] + 1)
    pus_k = _pack(mem_snap.pus_n, S1, maps.k2[mem_snap.pus_r] + 1)
    ovf_k = _pack(cl.ovf_src, S1, _m_srel1(maps, cl.ovf_srel1))

    # fold dense packing + the subject-fan decline, in the reference
    # builder's exact order, and the rc ancestor closures — both read
    # the full-view stub, which the primary partition below releases.
    # Their outputs are self-contained arrays sized by the fold/closure
    # structure, partitioned into stacked slices further down
    got = _fold_packed(fr, stub, maps, N, config) if fr is not None else None
    csr = None
    if got is not None:
        csr = build_range_hash(cl_k1, min_size=ms, **hk)
        if int(csr.max_run) > config.flat_fold_subj_fan_cap:
            got = None
    rc_built = _rc_build(stub, config, plan, ar_dd)

    # ---- primary: hash raw rows chunked, keep only owned ---------------
    h_e = _primary_hash_chunked(
        rel, res, subj, srel1, maps, N, S1,
        max(int(config.flat_partition_chunk), 1),
    )
    ge = point_geom(h_e, M, min_size=ms, **hk)
    e_own_rows = np.flatnonzero(
        _owned_mask_of(shard_owner(h_e, ge.size, M), M, owned_t)
    )
    e_sub = filter_columns(
        {
            "rel": rel, "res": res, "subj": subj, "srel1": srel1,
            "caveat": caveat, "ctx": ctx, "exp": exp32, "exp_us": exp_us,
            "h": h_e.view(np.int32),  # rides the takes; viewed back below
        },
        e_own_rows,
    )
    # stub holds references into the raw columns (maps/radix/depth all
    # computed above) — drop it WITH them or nothing is actually freed
    del stub, h_e, res, rel, subj, srel1, caveat, ctx, exp_us, exp32
    del e_own_rows
    eo = lexsort4(e_sub["rel"], e_sub["res"], e_sub["subj"], e_sub["srel1"])
    e_sub = filter_columns(e_sub, eo)
    del eo
    h_own = e_sub.pop("h").view(np.uint32)

    # ---- userset / arrow views: partition by group bucket --------------
    us_gkg, us_glo, us_ghi = _groups_of(us_gk)
    ar_gkg, ar_glo, ar_ghi = _groups_of(ar_gk)
    h_usg = _hash_cols([us_gkg])
    h_arg = _hash_cols([ar_gkg])
    gus = range_geom(
        us_gkg, us_ghi - us_glo, h_usg, M, min_size=ms,
        fan_pad=max(64, config.us_leaf_cap), **hk,
    )
    dom["fan"]["usgx"] = gus.max_run
    gar = range_geom(
        ar_gkg, ar_ghi - ar_glo, h_arg, M, min_size=ms,
        fan_pad=max(64, config.arrow_fanout), **hk,
    )
    dom["fan"]["argx"] = gar.max_run
    us_fanouts = _run_maxes(us_gkg, us_glo, us_ghi, N, maps.k1_raw)
    ar_fanouts = _run_maxes(ar_gkg, ar_glo, ar_ghi, N, maps.k1_raw)

    def _owned_groups(gkg, glo, ghi, h_g, geom):
        """(row ids of owned groups' rows, local gk/glo/lens/h) with the
        global order preserved — local glo re-offsets into the filtered
        row space."""
        gmask = _owned_mask_of(
            shard_owner(h_g, geom.gh.size, M), M, owned_t
        )
        lens = (ghi - glo).astype(np.int64)
        rows = (
            np.repeat(glo.astype(np.int64)[gmask], lens[gmask])
            + np.arange(int(lens[gmask].sum()), dtype=np.int64)
            - np.repeat(
                np.cumsum(lens[gmask]) - lens[gmask], lens[gmask]
            )
        ) if gmask.any() else np.zeros(0, np.int64)
        l_lens = lens[gmask]
        l_glo = np.cumsum(l_lens) - l_lens
        return rows, gkg[gmask], l_glo, l_lens, h_g[gmask]

    us_rows, us_l_gk, us_l_glo, us_l_lens, us_l_h = _owned_groups(
        us_gkg, us_glo, us_ghi, h_usg, gus
    )
    ar_rows, ar_l_gk, ar_l_glo, ar_l_lens, ar_l_h = _owned_groups(
        ar_gkg, ar_glo, ar_ghi, h_arg, gar
    )
    ar_loc = filter_columns(ar_full, ar_rows)
    del ar_gk
    if not routed:
        del ar_full  # routed serving stacks the WHOLE arrow view below

    # ---- T-index: global join, rows partitioned right after ------------
    tj = _tindex_join(mem_snap, config, cl, us_gk, cl_k1, cl_k2, pus_k, maps)
    del us_gk

    snap = partitioned_snapshot(
        mem_snap,
        e_cols=e_sub,
        us_rows=us_rows,
        ar_cols={
            "rel": ar_loc["rel"], "res": ar_loc["res"],
            "child": ar_loc["subj"], "caveat": ar_loc["caveat"],
            "ctx": ar_loc["ctx"], "exp": ar_loc["exp"],
        },
        owned=owned_t,
    )

    # ---- stacked tables: owned slices only for the O(E) ones -----------
    out: Dict[str, object] = {}
    e_gates = (
        ([snap.e_caveat, snap.e_ctx] if flags["e_hascav"] else [])
        + ([snap.e_exp] if flags["e_hasexp"] else [])
    )
    # _e_cols_at is the stacked builder's own column provider: the pack
    # recompute per shard is defined ONCE (parity-critical)
    out["eh_off"], out["ehx"] = stack_point(
        h_own, _e_cols_at(snap, maps, N, S1, e_gates), ge,
        2 + len(e_gates), owned=owned_t,
    )
    del h_own

    if routed:
        # routed serving: the userset/arrow views are membership- and
        # resource-structure-sized — stack them WHOLE (every device
        # probes its owner's block arithmetically, no collectives).
        # The full userset view IS the replicated membership snapshot's
        us_cols = (
            [mem_snap.us_subj, maps.k2[mem_snap.us_srel]]
            + (
                [mem_snap.us_caveat, mem_snap.us_ctx]
                if flags["us_hascav"] else []
            )
            + ([mem_snap.us_exp] if flags["us_hasexp"] else [])
            + ([mem_snap.us_perm] if flags["us_hasperm"] else [])
        )
        out["usr_off"], out["usgx"], out["usx"] = stack_range(
            us_gkg, us_glo, us_ghi - us_glo, h_usg,
            gather_cols(us_cols), gus, len(us_cols),
        )
        ar_cols = (
            [ar_full["subj"]]
            + (
                [ar_full["caveat"], ar_full["ctx"]]
                if flags["ar_hascav"] else []
            )
            + ([ar_full["exp"]] if flags["ar_hasexp"] else [])
        )
        out["arr_off"], out["argx"], out["arx"] = stack_range(
            ar_gkg, ar_glo, ar_ghi - ar_glo, h_arg,
            gather_cols(ar_cols), gar, len(ar_cols),
        )
        del ar_full
    else:
        us_cols = (
            [snap.us_subj, maps.k2[snap.us_srel]]
            + ([snap.us_caveat, snap.us_ctx] if flags["us_hascav"] else [])
            + ([snap.us_exp] if flags["us_hasexp"] else [])
            + ([snap.us_perm] if flags["us_hasperm"] else [])
        )
        out["usr_off"], out["usgx"], out["usx"] = stack_range(
            us_l_gk, us_l_glo, us_l_lens, us_l_h,
            gather_cols(us_cols), gus, len(us_cols), owned=owned_t,
        )
        ar_cols = (
            [snap.ar_child]
            + ([snap.ar_caveat, snap.ar_ctx] if flags["ar_hascav"] else [])
            + ([snap.ar_exp] if flags["ar_hasexp"] else [])
        )
        out["arr_off"], out["argx"], out["arx"] = stack_range(
            ar_l_gk, ar_l_glo, ar_l_lens, ar_l_h,
            gather_cols(ar_cols), gar, len(ar_cols), owned=owned_t,
        )

    t_kw = dict(has_tindex=False, t_cap=4, t_n=8, t_slots=())
    if tj is not None:
        T_k1, T_k2, T_d, T_p, t_slots = tj
        dom["until"]["tx"] = _until_dom(T_d, T_p)
        h_T = _hash_cols([T_k1, T_k2])
        gT = point_geom(h_T, M, min_size=ms, **hk)
        # owned slices on BOTH layouts: the T join is O(E·fold)-scale —
        # the largest table after the primary — so the routed placement
        # model-splits it like ehx/pfx.  Its bucket geometry differs
        # from the routing geometry, so T-probing slots are simply not
        # routable (parallel/sharded.py _routable): they take the psum
        # fallback, where the ownership-mask probe is exact
        t_own = _owned_mask_of(shard_owner(h_T, gT.size, M), M, owned_t)
        T_cols = [c[t_own] for c in (T_k1, T_k2, T_d, T_p)]
        out["th_off"], out["tx"] = stack_point(
            h_T[t_own], gather_cols(T_cols), gT, 4, owned=owned_t
        )
        t_kw = dict(
            has_tindex=True,
            t_cap=_round_cap(gT.cap),
            t_n=_ceil_pow2(max(gT.n, 1)),
            t_slots=t_slots,
        )
        del tj, T_k1, T_k2, T_d, T_p, h_T, t_own, T_cols

    # globally-small tables: full stacked build on every process (their
    # inputs are the replicated closure / pus derivations)
    dom["until"]["clx"] = _until_dom(cl.c_d_until, cl.c_p_until)
    clh = build_hash([cl_k1, cl_k2], min_size=ms, **hk)
    push = build_hash([pus_k], min_size=ms, **hk)
    ovfh = build_hash([ovf_k], min_size=ms, **hk)
    out["clh_off"], out["clx"] = _stack_point(
        clh, [cl_k1, cl_k2, cl.c_d_until, cl.c_p_until], M
    )
    out["push_off"], out["pusx"] = _stack_point(push, [pus_k], M)
    out["ovfh_off"], out["ovfx"] = _stack_point(ovfh, [ovf_k], M)

    # ---- permission fold (P-index): owned slices of the pf point
    # table + pfu range view; the csr closure-by-source view replicates
    # like the closure it is derived from --------------------------------
    fold_kw: Dict = {}
    if got is not None:
        pf_k1, pf_k2, pf_subj, (u_k1, u_gk, u_until, u_fan), pff = got
        pf_cols = (
            [pf_k1, pf_k2]
            + ([fr.e_cav, fr.e_ctx] if pff["pf_hascav"] else [])
            + ([fr.e_until] if pff["pf_hasuntil"] else [])
        )
        dom["until"]["pfx"] = _until_dom(fr.e_until)
        dom["until"]["pfux"] = _until_dom(u_until)
        h_pf = _hash_cols([pf_k1, pf_k2])
        gpf = point_geom(h_pf, M, min_size=ms, **hk)
        out["pfh_off"], out["pfx"] = stack_point(
            h_pf, gather_cols(pf_cols), gpf, len(pf_cols), owned=owned_t
        )
        s_fan = _round_fan(max(int(csr.max_run), 1))
        dom["fan"]["pfugx"] = u_fan
        dom["fan"]["csrgx"] = s_fan
        extra: Dict = {}
        direct_ok = False
        if routed:
            # routed serving replicates the fold's subject-side views:
            # prefer the COMPACT single-chip form (dense ``pfu_start`` /
            # ``csr_start`` offset arrays + split 1-wide columns — the
            # bucket-hash group tables cost ~16× the bytes per row, all
            # of it replicated on this placement)
            from .flat import _pf_view_tables

            fold_slots = tuple(sorted({s for _, s in fr.pairs}))
            pf_arrays, pf_kw = _pf_view_tables(
                u_k1, u_gk, u_until, u_fan,
                cl_k1, cl_k2, cl.c_d_until, cl.c_p_until, s_fan,
                maps=maps, N=N, S1=S1, fold_slots=fold_slots,
                config=config,
            )
            direct_ok = pf_kw["pf_direct"] and pf_kw["pf_s_direct"]
            if direct_ok:
                out.update(pf_arrays)
                extra = pf_kw
        if not direct_ok:
            # stacked group views: owned slices on the partitioned
            # layout, whole on the routed one (key space over the
            # direct budget)
            pfu_gkg, pfu_glo, pfu_ghi = _groups_of(u_k1)
            h_pfu = _hash_cols([pfu_gkg])
            gpfu = range_geom(
                pfu_gkg, pfu_ghi - pfu_glo, h_pfu, M, min_size=ms,
                fan_pad=max(64, u_fan), **hk,
            )
            out["pfu_off"], out["pfugx"], out["pfux"] = stack_range(
                pfu_gkg, pfu_glo, pfu_ghi - pfu_glo, h_pfu,
                gather_cols([u_gk, u_until]), gpfu, 2, owned=own_small,
            )
            out["csr_off"], out["csrgx"], out["csrx"], csr_cap = _stack_range(
                csr, [cl_k2, cl.c_d_until, cl.c_p_until], M, max(64, s_fan)
            )
            extra = dict(
                pf_u_cap=_round_cap(gpfu.cap),
                pf_s_cap=_round_cap(csr_cap),
            )
        fold_kw = dict(
            fold_pairs=fr.pairs,
            pf_e_cap=_round_cap(gpf.cap),
            pf_u_fan=u_fan,
            pf_s_fan=s_fan,
            pf_haswc=bool(np.isin(pf_subj, wc_nodes).any()),
            pf_has_e=pf_k1.shape[0] > 0,
            pf_has_u=u_k1.shape[0] > 0,
            **extra,
            **pff,
        )
        # arm the maintenance state with the packing context it needs
        # at delta time (fold_delta_update), exactly like the reference
        # builders — without it the first incremental prepare would
        # sticky-downgrade the fold (pf_off) and unroute folded slots
        fstate.maps, fstate.N = maps, N
    else:
        fstate = None

    # ---- rc ancestor closures: owned slices of each range view ---------
    rc_list = []
    for ts_slot, (src, anc, d_u, p_u, fan) in rc_built.items():
        rc_gk, rc_glo, rc_ghi = _groups_of(src)
        h_rc = _hash_cols([rc_gk])
        dom["until"][f"rc{ts_slot}x"] = _until_dom(d_u, p_u)
        dom["fan"][f"rc{ts_slot}gx"] = fan
        grc = range_geom(
            rc_gk, rc_ghi - rc_glo, h_rc, M, min_size=ms,
            fan_pad=max(64, fan), **hk,
        )
        (
            out[f"rc{ts_slot}_off"],
            out[f"rc{ts_slot}gx"],
            out[f"rc{ts_slot}x"],
        ) = stack_range(
            rc_gk, rc_glo, rc_ghi - rc_glo, h_rc,
            gather_cols([anc, d_u, p_u]), grc, 3, owned=own_small,
        )
        rc_list.append((int(ts_slot), _round_cap(grc.cap), fan))

    # routing/attribution gauge: how many primary rows this process's
    # owned shards materialized (the O(E·owned/M) share of the feed)
    metrics.default.set_gauge(
        "partition.owned_rows", float(int(snap.e_rel.shape[0]))
    )

    meta = FlatMeta(
        N=N, S1=S1,
        k1_dense=tuple(int(x) for x in maps.k1),
        k2_dense=tuple(int(x) for x in maps.k2),
        **fold_kw,
        rc_slots=tuple(sorted(rc_list)),
        part_serve=routed,
        e_cap=_round_cap(ge.cap), e_n=_ceil_pow2(max(ge.n, 1)),
        usr_cap=_round_cap(gus.cap),
        usr_gn=8,
        us_rows=8,
        arr_cap=_round_cap(gar.cap),
        arr_gn=8,
        ar_rows=8,
        cl_cap=_round_cap(clh.cap), cl_n=_ceil_pow2(max(clh.n, 1)),
        has_closure=clh.n > 0,
        pus_cap=_round_cap(push.cap), pus_n=_ceil_pow2(max(push.n, 1)),
        ovf_cap=_round_cap(ovfh.cap), ovf_n=_ceil_pow2(max(ovfh.n, 1)),
        has_ovf=ovfh.n > 0,
        ar_fanout_by_slot=ar_fanouts,
        us_fanout_by_slot=us_fanouts,
        **t_kw,
        **flags,
        blockslice=True,
        sharded=True,
        ar_data_depth=ar_dd,
        e_slots=e_slots,
        us_slots=us_slots,
        has_wc_edges=has_wc_edges,
        has_wc_closure=bool(
            np.isin(cl.c_src[cl.c_srel1 == 0], wc_nodes).any()
            or np.isin(cl.ovf_src[cl.ovf_srel1 == 0], wc_nodes).any()
        ),
    )
    if PKD:
        with metrics.default.timer("prepare.pack_lanes_s"):
            pk_up = _pack_flat(out, meta, config, dom, pack_off=False)
        if pk_up:
            from dataclasses import replace as _dc_replace

            meta = _dc_replace(meta, **pk_up)
    metrics.default.observe(
        "prepare.partition_s", _time.perf_counter() - _t0
    )
    return FeedPartition(
        snapshot=snap, arrays=out, meta=meta, owned=owned_t, M=M,
        fold_state=fstate,
    )
