"""Bucketed hash indexes: host-built, device-probed in O(bucket cap).

The round-2 engine answered every exact-match question with a ~17-step
lexicographic binary search (engine/device.py _lex_search) — 17 dependent
scalar gathers per probe is exactly the memory-latency-bound pattern TPUs
hate.  A bucketed hash index answers the same question in ``cap`` (usually
≤ 4) data-independent steps: hash the key, gather the bucket's row-index
range, compare ``cap`` candidate rows.  Every step is a full-batch-wide
vectorized gather, so a probe site costs a handful of gather/compare ops
regardless of table size.

Layout (host build, all vectorized numpy):
- keys live in the caller's existing sorted int32 columns (NOT copied —
  the index stores only a permutation, halving HBM at 100M edges);
- ``rows`` is the permutation grouping row indices by bucket;
- ``off[b]:off[b+1]`` delimits bucket ``b``'s slice of ``rows``;
- ``cap`` is the true max bucket size; the build doubles the table until
  ``cap`` ≤ ``target_cap`` (duplicate full keys bound this from below, so
  growth stops at ``max_factor`` × entries and accepts the larger cap).

The device probe recomputes the same 32-bit mix (``mix32_t`` in torch,
the CUDA kernel in native uint32 — both bit-identical to the numpy
``mix32`` the host build uses) and compares ``cap`` candidate rows.

No reference counterpart: gochugaru delegates lookups to SpiceDB's
datastore indexes (client/client.go:238-266); this is their on-device
replacement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619


def mix32(cols: Sequence, xp=np):
    """FNV-1a over int32 words + murmur3 finalizer, in uint32 wrap-around
    arithmetic (numpy arrays; the host-side build's hash)."""
    h = xp.uint32(_FNV_OFFSET)
    for c in cols:
        h = (h ^ c.astype(xp.uint32)) * xp.uint32(_FNV_PRIME)
    h = h ^ (h >> xp.uint32(16))
    h = h * xp.uint32(0x85EBCA6B)
    h = h ^ (h >> xp.uint32(13))
    h = h * xp.uint32(0xC2B2AE35)
    h = h ^ (h >> xp.uint32(16))
    return h


@dataclass
class HashIndex:
    """Bucket offsets + row permutation over the caller's key columns."""

    off: np.ndarray  # int32[size + 1]
    rows: np.ndarray  # int32[max(n, 1)]
    size: int  # pow2 bucket count
    cap: int  # max bucket occupancy (device probe unroll count)
    n: int  # number of entries


def _ceil_pow2(n: int, minimum: int = 8) -> int:
    m = minimum
    while m < n:
        m <<= 1
    return m


def build_hash(
    key_cols: Sequence[np.ndarray],
    *,
    target_cap: int = 4,
    min_size: int = 8,
    max_factor: int = 8,
    lean: bool = False,
) -> HashIndex:
    """Index the rows of lock-step int32 key columns by hash bucket.

    The hot path is native (native/sort.py hash_index32): one fused
    mask/histogram/prefix/stable-scatter pass replaces the
    mask→astype→bincount→argsort→cumsum chain, producing bit-identical
    ``rows``/``off`` (a stable counting sort by bucket IS
    np.argsort(bucket, kind="stable")).  The numpy fallback below is the
    reference implementation the parity test pins the native path to."""
    from ..native.sort import hash_index32, mix32_native

    n = int(key_cols[0].shape[0]) if key_cols else 0
    if n == 0:
        size = min_size
        return HashIndex(
            off=np.zeros(size + 1, np.int32),
            rows=np.zeros(1, np.int32),
            size=size,
            cap=1,
            n=0,
        )
    cols = [np.ascontiguousarray(c, np.int32) for c in key_cols]
    h_full = mix32_native(cols)
    if h_full is None:
        h_full = mix32(cols, np)
    # lean (HBM-packed) sizing starts at ~1 entry/bucket instead of 0.5:
    # the probe cap absorbs the deeper buckets, the offsets array halves
    size = _ceil_pow2(n if lean else 2 * n, min_size)
    # growth chases a small max bucket, but the max of n Poisson draws
    # grows with log n: beyond ~16M rows target_cap=4 is statistically
    # unreachable and doubling would only balloon the offsets array (the
    # 100M-edge table would hit 2^31 buckets) — freeze size and accept
    # the larger probe cap instead
    limit = size if n > (1 << 24) else size * max_factor
    got = hash_index32(h_full, size)
    if got is not None:
        rows, off, cap = got
        while cap > target_cap and size < limit:
            size <<= 1
            rows, off, cap = hash_index32(h_full, size)
        return HashIndex(off=off, rows=rows, size=size, cap=cap, n=n)
    while True:
        h = (h_full & np.uint32(size - 1)).astype(np.int64)
        counts = np.bincount(h, minlength=size)
        cap = int(counts.max())
        if cap <= target_cap or size >= limit:
            break
        size <<= 1
    rows = np.argsort(h, kind="stable").astype(np.int32)
    off = np.zeros(size + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return HashIndex(
        off=off.astype(np.int32), rows=rows, size=size, cap=cap, n=n
    )


@dataclass
class RangeIndex:
    """key → contiguous row range [lo, hi) in a key-sorted table.

    The group keys/bounds are materialized per distinct key and themselves
    hash-indexed, so a range lookup is one 1-column probe + two payload
    gathers instead of two binary searches."""

    gk: np.ndarray  # int32[G] distinct keys
    glo: np.ndarray  # int32[G] range start in the underlying table
    ghi: np.ndarray  # int32[G] range end
    index: HashIndex  # over gk

    @property
    def max_run(self) -> int:
        return int((self.ghi - self.glo).max()) if self.gk.shape[0] else 0


def build_range_hash(k: np.ndarray, **kw) -> RangeIndex:
    """Build a RangeIndex over a column already sorted ascending (group
    boundaries via the native sorted-runs pass; numpy mask fallback)."""
    from ..native.sort import sorted_runs

    n = int(k.shape[0])
    if n == 0:
        z = np.zeros(0, np.int32)
        return RangeIndex(gk=z, glo=z, ghi=z, index=build_hash([], **kw))
    starts = sorted_runs(k)
    ends = np.concatenate([starts[1:], np.asarray([n])])
    gk = np.ascontiguousarray(k[starts], np.int32)
    return RangeIndex(
        gk=gk,
        glo=starts.astype(np.int32),
        ghi=ends.astype(np.int32),
        index=build_hash([gk], **kw),
    )


# ---------------------------------------------------------------------------
# bucket-ALIGNED layout: the whole bucket is one table row
# ---------------------------------------------------------------------------
#
# The off+interleave layout below pays 2 dependent reads per probe (the
# bucket offset, then the block it points at).  The aligned layout stores
# bucket b's entries IN row b of an int32[size, cap*w] matrix, padded
# with -1: a probe is hash -> tbl[h] -> compare, one contiguous row read.
#
# The Poisson tail would force cap (and the whole matrix width) up to the
# fullest bucket, so entries beyond ``cap`` per bucket SPILL to a smaller
# aligned level under a salted hash; the probe reads one row per level
# and sees one concatenated candidate block.  Worlds whose duplicate-key
# multiplicity exceeds the spill cap keep the off+interleave layout
# (build returns None).


def _level_salt(lvl: int) -> np.int32:
    """Per-stratum probe salt (level 0 unsalted; level 1 == the classic
    spill salt).  uint32 wrap-around so deep ladders don't overflow."""
    return np.int32(
        np.uint32((0x9E3779B9 * lvl) & 0xFFFFFFFF).astype(np.int32)
    )


@dataclass
class AlignedIndex:
    """Bucket-aligned probe table: a ladder of WIDTH-STRATIFIED levels.

    Level 0 holds a cap covering most entries; whatever overflows
    re-hashes (salted) into the next, much smaller level with its own
    cap — per-bucket width classes instead of one table-wide row width
    set by the fullest bucket (``build_aligned``'s ``cover`` ladder
    picks the caps at prepare time).  The classic layout is the 2-level
    instance (primary + spill)."""

    levels: List[Tuple[np.ndarray, int]]  # [(int32[size_i, cap_i*w], cap_i)]
    w: int
    n: int

    @property
    def caps(self) -> Tuple[int, ...]:
        """The width-class ladder (probe geometry; rides FlatMeta)."""
        return tuple(c for _, c in self.levels)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t, _ in self.levels)


def _aligned_fill(
    h: np.ndarray, cols: Sequence[np.ndarray], size: int, cap: int,
    counts: Optional[np.ndarray] = None,
):
    """Place entries into an int32[size, cap*w] matrix; returns
    (tbl, leftover_row_indices) where leftover rows did not fit their
    bucket's ``cap`` slots.  ``counts`` (bincount of ``h``) is reused
    when the caller already computed it."""
    from ..native.sort import hash_index32

    w = len(cols)
    n = int(h.shape[0])
    got = hash_index32(h.astype(np.uint32), size) if size <= 2**31 else None
    if got is not None:
        # native stable counting sort == np.argsort(h, kind="stable"),
        # with the exclusive bucket starts already materialized
        order, off32, _cap = got
        order = order.astype(np.int64)
        hs = h[order]
        off = off32[:-1].astype(np.int64)
    else:
        order = np.argsort(h, kind="stable")
        hs = h[order]
        if counts is None:
            counts = np.bincount(hs, minlength=size)
        off = np.zeros(size, np.int64)
        np.cumsum(counts[:-1], out=off[1:])
    rank = np.arange(n, dtype=np.int64) - off[hs]
    fits = rank < cap
    tbl = np.full((size, cap * w), -1, np.int32)
    rows_in = order[fits]
    slot = (rank[fits] * w).astype(np.int64)
    for j, c in enumerate(cols):
        tbl[hs[fits], slot + j] = np.ascontiguousarray(c, np.int32)[rows_in]
    return tbl, order[~fits]


def _cover_cap(counts: np.ndarray, n: int, start_cap: int, bound: int,
               q: float) -> int:
    """Smallest cap ≥ ``start_cap`` whose buckets hold ≥ q of the n
    entries, bounded — the per-level width-class choice."""
    cap_need = int(counts.max()) if counts.size else 1
    if cap_need <= start_cap:
        return min(start_cap, max(cap_need, 1)) if start_cap else 1
    hist = np.bincount(np.minimum(counts, cap_need))
    ge = np.cumsum(hist[::-1])[::-1]  # ge[j] = #buckets with count>=j
    coverage = np.cumsum(ge[1:])  # coverage[c-1] = entries held at cap c
    bound = min(bound, cap_need)
    c = max(start_cap, 1)
    while c < bound and coverage[c - 1] < q * n:
        c += 1
    return c


#: per-table byte budget of the aligned layout in engine/flat.py: a
#: table whose aligned form exceeds it keeps the off+interleave layout
#: (the reference's ``flat_aligned_max_bytes`` default)
ALIGNED_MAX_BYTES = 3 << 30
#: the width-stratification ladder engine/flat.py builds with (the
#: reference's ``flat_aligned_cover`` default): the classic
#: primary+spill pair
ALIGNED_COVER: Tuple[float, ...] = (0.999,)


def build_aligned(
    key_cols: Sequence[np.ndarray],
    cols: Sequence[np.ndarray],
    *,
    target_cap: int = 4,
    spill_max_cap: int = 16,
    min_size: int = 8,
    max_bytes: Optional[int] = None,
    cover: Optional[Sequence[float]] = None,
) -> Optional[AlignedIndex]:
    """Bucket-aligned index over lock-step int32 columns (``key_cols``
    must be a prefix of ``cols`` — the probe compares them in order).

    ``cover`` is the width-stratification ladder (None: ``ALIGNED_COVER``,
    read at call time): level i's cap is the
    smallest covering ``cover[i]`` of its entries; whatever overflows
    re-hashes (level-salted) into the next level, and a FINAL fit-all
    level closes the ladder.  The salt XORs the first key column inside
    the hash only: stored key columns stay unsalted.  Returns None when
    the layout doesn't fit (final-level tail too deep for
    ``spill_max_cap`` — e.g. one full key duplicated beyond every cap —
    or ``max_bytes`` exceeded): callers keep the off+interleave layout."""
    if cover is None:
        cover = ALIGNED_COVER
    w = max(len(cols), 1)
    n = int(cols[0].shape[0]) if cols else 0
    if n == 0:
        return AlignedIndex(
            levels=[(np.full((min_size, target_cap * w), -1, np.int32),
                     target_cap)],
            w=w, n=0,
        )
    ckey = [np.ascontiguousarray(c, np.int32) for c in key_cols]
    ccols = [np.ascontiguousarray(c, np.int32) for c in cols]
    size = _ceil_pow2(max(min_size, (2 * n) // max(target_cap, 1)))
    if max_bytes is not None and size * target_cap * w * 4 > max_bytes:
        return None
    levels: List[Tuple[np.ndarray, int]] = []
    left = np.arange(0, 0, dtype=np.int64)  # current leftover row ids
    cur_key, cur_cols, cur_n = ckey, ccols, n
    for lvl, q in enumerate(tuple(cover) + (None,)):
        if lvl > 0:
            cur_key = [ckey[0][left] ^ _level_salt(lvl)] + [
                c[left] for c in ckey[1:]
            ]
            cur_cols = [c[left] for c in ccols]
            cur_n = int(left.shape[0])
            if cur_n == 0:
                break
            size = _ceil_pow2(max(min_size, cur_n))
        h_full = mix32(cur_key, np)
        if q is None:
            # final level: must hold every remaining entry (grow until
            # the fullest bucket fits spill_max_cap, else unfit)
            while True:
                h = (h_full & np.uint32(size - 1)).astype(np.int64)
                cap = int(np.bincount(h, minlength=size).max())
                if cap <= spill_max_cap:
                    break
                if size >= _ceil_pow2(8 * cur_n):
                    return None  # duplicate-heavy tail: aligned unfit
                size <<= 1
            tbl, over = _aligned_fill(h, cur_cols, size, cap)
            if over.shape[0]:
                return None
            levels.append((tbl, cap))
            break
        h = (h_full & np.uint32(size - 1)).astype(np.int64)
        counts = np.bincount(h, minlength=size)
        # level 0 keeps the classic hot-key bound (3x target); deeper
        # levels start at 1 — their whole point is a narrow width class
        cap = _cover_cap(
            counts, cur_n,
            target_cap if lvl == 0 else 1,
            spill_max_cap if lvl else min(spill_max_cap, 3 * target_cap),
            q,
        )
        if lvl == 0 and max_bytes is not None and size * cap * w * 4 > max_bytes:
            cap = target_cap
        tbl, over = _aligned_fill(h, cur_cols, size, cap, counts=counts)
        levels.append((tbl, cap))
        left = left[over] if lvl > 0 else over
        if left.shape[0] == 0:
            break
    out = AlignedIndex(levels=levels, w=w, n=n)
    if max_bytes is not None and out.nbytes > max_bytes:
        return None
    return out


# ---------------------------------------------------------------------------
# device-side probes (torch tensors on the engine's device)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(h, m: int):
    """(h * m) mod 2^32 for int64 ``h`` in [0, 2^32): split so no
    intermediate leaves int64 (signed overflow is undefined in torch's
    kernels; each partial product stays below 2^48)."""
    lo = (h * (m & 0xFFFF)) & _M32
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32_t(cols: Sequence):
    """``mix32`` on int32 tensors: the same FNV-1a + murmur3 finalizer,
    carried in int64 under 32-bit masks (torch has no uint32 shifts on
    the CPU).  Returns int64 values in [0, 2^32)."""
    h = torch.full((), _FNV_OFFSET, dtype=torch.int64)
    for c in cols:
        h = _mul32(h ^ (c.to(torch.int64) & _M32), _FNV_PRIME)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def bucket_of(q_cols: Sequence, size: int):
    """int64 bucket index ``mix32(q) & (size - 1)`` (``size`` pow2)."""
    return mix32_t(q_cols) & (size - 1)


def take_in_bounds(a, i):
    """``a[i]`` for indices in range by construction (hash & mask,
    clipped slots, row ids): the callers clip or mask, as the
    reference's promise_in_bounds gathers require."""
    return a[i.long()]


def probe_rows(off, rows, key_cols: Sequence, q_cols: Sequence, cap: int,
               n: int):
    """Row index of the entry whose key columns equal ``q_cols``, else -1
    (the scattered layout: bucket offsets, a row permutation and the
    full-width key columns).  All ``q_cols`` share an arbitrary broadcast
    shape; the probe is elementwise over it.  ``cap``/``n`` are static
    (the host HashIndex's probe cap and padded row count).  The ``cap``
    slots are tried in bucket order and the FIRST matching row wins, so
    duplicate keys resolve to the row the host build put first."""
    take = take_in_bounds
    size = int(off.shape[0]) - 1
    h = bucket_of(q_cols, size)
    start = take(off, h)
    end = take(off, h + 1)
    found = torch.full(tuple(h.shape), -1, dtype=torch.int32,
                       device=start.device)
    last = max(n - 1, 0)
    for j in range(cap):
        slot = start + j
        valid = slot < end
        idx = take(rows, slot.clamp(0, last))
        hit = valid
        for kc, qc in zip(key_cols, q_cols):
            hit = hit & (take(kc, idx) == qc)
        found = torch.where((found < 0) & hit, idx, found)
    return found


def probe_range(ri_arrays, cap: int, n: int, q):
    """Range [lo, hi) for key ``q`` in a RangeIndex; (0, 0) on a miss.
    ``ri_arrays`` holds one RangeIndex's device tensors under the keys
    'gk', 'glo', 'ghi', 'off', 'rows'."""
    gi = probe_rows(
        ri_arrays["off"], ri_arrays["rows"], (ri_arrays["gk"],), (q,), cap, n
    )
    gic = gi.clamp(0, max(n - 1, 0))
    hit = gi >= 0
    lo = torch.where(hit, take_in_bounds(ri_arrays["glo"], gic), 0)
    hi = torch.where(hit, take_in_bounds(ri_arrays["ghi"], gic), 0)
    return lo, hi


def probe_aligned(tbls: Sequence, caps: Sequence[int], w: int, q_cols):
    """Candidate block [..., sum(caps), w] of raw row slots for the bucket
    of ``q_cols`` — ONE row read per width-stratum level, level l >= 1
    hashing ``q0 ^ _level_salt(l)`` (the stored keys stay unsalted).
    ``w`` is the slot width (int32 columns, or uint16 lanes when packed).
    Padded slots hold -1 and match nothing; same-key entries land in the
    same bucket of SOME level, so callers compare key columns exactly.
    Levels concatenate in level order on axis -2."""
    blks = []
    for lvl, (tbl, cap) in enumerate(zip(tbls, caps)):
        qs = list(q_cols)
        if lvl:
            qs[0] = qs[0] ^ int(_level_salt(lvl))
        h = bucket_of(qs, int(tbl.shape[0]))
        blks.append(tbl[h].reshape(tuple(h.shape) + (cap, w)))
    return blks[0] if len(blks) == 1 else torch.cat(blks, dim=-2)



# ---------------------------------------------------------------------------
# block-slice layout: bucket-ordered interleaved tables
# ---------------------------------------------------------------------------
#
# The scatter probes above cost 2 + cap·(1 + nkey) independent 1-D gathers
# per site — dozens of scattered 32-bit reads per query.  TPUs gather at
# ~one row per cycle regardless of width, so the TPU-shaped layout stores
# each bucket's entries CONTIGUOUSLY with keys and payloads interleaved:
# one [cap, w] dynamic-slice per query fetches the whole bucket (a single
# HBM line or two), and every compare afterwards is elementwise VPU work.
# Probe cost per site drops to 2 gathers (bucket offset + block) total.


def interleave_buckets(
    h: HashIndex, cols: Sequence[np.ndarray], pad: int = 64,
    quantum: Optional[int] = None,
) -> np.ndarray:
    """Bucket-ordered interleaved matrix int32[n_pad, w]: row j holds
    ``cols[:][h.rows[j]]``.  Padded to pow2(n + max(pad, h.cap)) rows of -1
    so a slice of up to ``max(pad, h.cap)`` rows starting at any real
    bucket offset stays in bounds without clipping (padded keys are -1 and
    match nothing).  Callers slicing more than ``h.cap`` rows must pass
    their slice cap as ``pad`` — slice_blocks' clamp would otherwise SHIFT
    the block and break the lane↔row mapping.

    ``quantum`` replaces the pow2 round with round-up-to-a-multiple (the
    slice-safety pad is kept either way): big rebuilt-per-prepare tables
    (the T join — up to 2x pow2 waste at tens of millions of rows) trade
    the coarse shape bucketing for near-exact residency; delta chains
    never reshape base tables, so the retrace bound this table pays is
    one compile per FULL prepare — which a fresh pow2 shape would
    usually pay anyway."""
    from ..native.sort import fill_interleaved

    w = max(len(cols), 1)
    n = int(h.rows.shape[0]) if h.n else 0
    need = max(n, 1) + max(pad, h.cap)
    n_pad = (
        _ceil_pow2(need) if quantum is None else -(-need // quantum) * quantum
    )
    # pad rows get -1; data rows are fully overwritten below, so only the
    # tail needs the fill (a 2-col 30M-row table skips a 256MB memset)
    out = np.empty((n_pad, w), np.int32)
    out[n:] = -1
    if h.n:
        if not fill_interleaved(out, cols, h.rows):
            for j, c in enumerate(cols):
                out[:n, j] = np.ascontiguousarray(c, np.int32)[h.rows]
    return out


def interleave_rows(
    cols: Sequence[np.ndarray], pad: int = 64, pad_fill: int = -1
) -> np.ndarray:
    """Row-order interleaved matrix int32[n_pad, w] over lock-step columns
    (for range views whose rows are already grouped contiguously by key).
    Padded to pow2(n + pad) rows of ``pad_fill``; ``pad`` must be ≥ the
    largest row-slice cap any probe site uses (slice_blocks clamps starts,
    which would silently shift an undersized table's lane↔row mapping)."""
    from ..native.sort import fill_interleaved

    w = max(len(cols), 1)
    n = int(cols[0].shape[0]) if cols else 0
    n_pad = _ceil_pow2(max(n, 1) + max(pad, 1))
    out = np.empty((n_pad, w), np.int32)
    out[n:] = pad_fill
    if n and not fill_interleaved(out, cols, None):
        for j, c in enumerate(cols):
            out[:n, j] = np.ascontiguousarray(c, np.int32)
    return out


def slice_blocks(tbl, start, cap: int):
    """Contiguous [cap, w] block per element of ``start`` (any shape):
    returns tbl-typed [..., cap, w].  Starts clamp to [0, rows - cap]
    exactly as the reference's ``slice_blocks`` (interleave_* pad enough
    rows that a real bucket offset never clamps).  Row indices are int64,
    so ``rows·w`` beyond 2^31 addresses correctly."""
    rows = int(tbl.shape[0])
    s = start.to(torch.int64).clamp(0, rows - cap)
    idx = s.unsqueeze(-1) + torch.arange(cap, dtype=torch.int64,
                                         device=tbl.device)
    return tbl[idx]



def probe_block(off, tbl, cap: int, q_cols: Sequence, off_a=None,
                ashift: Optional[int] = None):
    """Bucket block for the hash of ``q_cols``: [..., cap, w] raw rows.

    The block starts at the bucket's first entry and spans ``cap`` rows
    (the build's max bucket occupancy), so every entry of the bucket is in
    the block; overshoot rows belong to LATER buckets and cannot equal the
    query key (equal keys hash to the same bucket), so callers just compare
    key columns exactly — no per-slot validity mask is needed.  ``off_a``
    / ``ashift`` read packed offsets (int32 anchors + uint16 residuals
    stored as int16)."""
    size = int(off.shape[0]) - 1
    h = bucket_of(q_cols, size)
    if off_a is None:
        start = off[h].to(torch.int64)
    else:
        start = off_a[h >> ashift].to(torch.int64) + (
            off[h].to(torch.int64) & 0xFFFF
        )
    return slice_blocks(tbl, start, cap)
