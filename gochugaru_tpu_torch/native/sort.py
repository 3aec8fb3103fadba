"""Sorting front-ends over the native library, numpy fallback included.

``lexsort4`` is the snapshot primary order (rel, res, subj, srel1) — the
layout every device binary search assumes (store/snapshot.py).  At 100M
rows numpy's single-threaded lexsort is tens of seconds; the native
OpenMP sort over packed 64-bit key pairs is the difference between
"rebuild is interactive" and "rebuild is a coffee break" (SURVEY.md §7).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import lib


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def lexsort4(a: np.ndarray, b: np.ndarray, c: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Permutation sorting rows by (a, b, c, d), ints.  Equivalent to
    ``np.lexsort((d, c, b, a))``."""
    L = lib()
    n = a.shape[0]
    if L is None or n < (1 << 16):
        return np.lexsort((d, c, b, a))
    a32 = np.ascontiguousarray(a, np.int32)
    b32 = np.ascontiguousarray(b, np.int32)
    c32 = np.ascontiguousarray(c, np.int32)
    d32 = np.ascontiguousarray(d, np.int32)
    out = np.empty(n, np.int64)
    L.gi_lexsort4(
        _i32ptr(a32), _i32ptr(b32), _i32ptr(c32), _i32ptr(d32),
        ctypes.c_int64(n), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def lexsort2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Stable permutation by (a, b) — ``np.lexsort((b, a))``."""
    L = lib()
    n = a.shape[0]
    if L is None or n < (1 << 16):
        return np.lexsort((b, a))
    a32 = np.ascontiguousarray(a, np.int32)
    b32 = np.ascontiguousarray(b, np.int32)
    out = np.empty(n, np.int64)
    L.gi_lexsort2(
        _i32ptr(a32), _i32ptr(b32), ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def argsort1(a: np.ndarray) -> np.ndarray:
    """Stable argsort of one int column — ``np.argsort(a, kind='stable')``."""
    L = lib()
    n = a.shape[0]
    if L is None or n < (1 << 16):
        return np.argsort(a, kind="stable")
    a32 = np.ascontiguousarray(a, np.int32)
    out = np.empty(n, np.int64)
    L.gi_argsort1(
        _i32ptr(a32), ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def sortperm_words(words, fallback_cols) -> np.ndarray:
    """Stable permutation sorting rows by up to three uint64 words
    (``words[0]`` major).  The caller packs its key columns into words
    with any order-preserving encoding (non-negative int64 reinterpret
    directly; int32 pairs pack as ``hi<<32 | lo`` after biasing).
    ``fallback_cols`` is the np.lexsort key tuple (minor first) producing
    the identical permutation when the native library is unavailable."""
    L = lib()
    n = int(words[0].shape[0])
    if L is None or n < (1 << 16):
        return np.lexsort(fallback_cols)
    def as_u64(w):
        if w.dtype == np.int64 and w.flags.c_contiguous:
            return w.view(np.uint64)  # non-negative by contract: free
        return np.ascontiguousarray(w, np.uint64)

    ws = [as_u64(w) for w in words[:3]]
    out = np.empty(n, np.int64)
    pu = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    ptrs = [pu(w) for w in ws] + [None] * (3 - len(ws))
    L.gi_sortperm3(
        ptrs[0], ptrs[1], ptrs[2], ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def sorted_runs(k: np.ndarray) -> np.ndarray:
    """Start indices of the equal-key runs of a SORTED key column — the
    group-by/offset primitive of build_range_hash and the fold dedups.
    One parallel native pass; the numpy fallback materializes the usual
    boolean first-mask."""
    n = int(k.shape[0])
    L = lib()
    if L is None or n < (1 << 16):
        if n == 0:
            return np.zeros(0, np.int64)
        first = np.ones(n, bool)
        first[1:] = k[1:] != k[:-1]
        return np.nonzero(first)[0]
    starts = np.empty(n, np.int64)
    p64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if k.dtype == np.int32:
        kk = np.ascontiguousarray(k, np.int32)
        G = L.gi_run_bounds32(_i32ptr(kk), ctypes.c_int64(n), p64(starts))
    else:
        kk = np.ascontiguousarray(k, np.int64)
        G = L.gi_run_bounds64(p64(kk), ctypes.c_int64(n), p64(starts))
    return starts[:G]


def take32(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Parallel ``src[idx]`` for an int32 source and int64 index — the
    permutation-apply of the snapshot/fold builds."""
    L = lib()
    n = int(idx.shape[0])
    if L is None or n < (1 << 16):
        return np.ascontiguousarray(src, np.int32)[idx]
    s = np.ascontiguousarray(src, np.int32)
    ii = np.ascontiguousarray(idx, np.int64)
    out = np.empty(n, np.int32)
    L.gi_take32(
        _i32ptr(s), ii.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), _i32ptr(out),
    )
    return out


def take64(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Parallel ``src[idx]`` for an int64 source and int64 index."""
    L = lib()
    n = int(idx.shape[0])
    if L is None or n < (1 << 16):
        return np.ascontiguousarray(src, np.int64)[idx]
    s = np.ascontiguousarray(src, np.int64)
    ii = np.ascontiguousarray(idx, np.int64)
    out = np.empty(n, np.int64)
    p64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    L.gi_take64(p64(s), p64(ii), ctypes.c_int64(n), p64(out))
    return out


def fill_interleaved(
    out: np.ndarray, cols, rows: "np.ndarray | None"
) -> bool:
    """Fill ``out[i, j] = cols[j][rows[i]]`` (identity when ``rows`` is
    None) for the first ``len(cols[0])`` rows of a C-contiguous int32
    [n_pad, w] matrix — the gather+transpose of interleave_buckets /
    interleave_rows in one parallel row-major pass.  Returns False when
    the native library is unavailable (caller falls back)."""
    L = lib()
    n = int(cols[0].shape[0]) if cols else 0
    if L is None or n < (1 << 16):
        return False
    # the native pass writes n rows through raw pointers: a mismatched
    # permutation or an undersized output must fail loudly here, not
    # corrupt the heap
    if rows is not None and int(rows.shape[0]) != n:
        raise ValueError(
            f"fill_interleaved: rows has {rows.shape[0]} entries, "
            f"columns have {n}"
        )
    if out.shape[0] < n or out.shape[1] < len(cols):
        raise ValueError(
            f"fill_interleaved: out {out.shape} too small for "
            f"{n}x{len(cols)}"
        )
    cc = [np.ascontiguousarray(c, np.int32) for c in cols]
    ptrs = np.array([c.ctypes.data for c in cc], np.int64)
    rr = None
    if rows is not None:
        rr = np.ascontiguousarray(rows, np.int32)
    L.gi_interleave32(
        ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(cc)),
        _i32ptr(rr) if rr is not None else None,
        ctypes.c_int64(n), _i32ptr(out), ctypes.c_int64(out.shape[1]),
    )
    return True


def hash_index32(h_full: np.ndarray, size: int):
    """Stable bucket-grouped rows + offsets for 32-bit hashes masked to
    ``size`` buckets: (rows int32[n], off int32[size+1], cap) — or None
    when the native library is unavailable (build_hash falls back to the
    mask/bincount/argsort/cumsum chain)."""
    L = lib()
    n = int(h_full.shape[0])
    if L is None or n < (1 << 16):
        return None
    h = np.ascontiguousarray(h_full, np.uint32)
    rows = np.empty(n, np.int32)
    off = np.empty(size + 1, np.int32)
    cap = L.gi_hash_index32(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(n), ctypes.c_int64(size), _i32ptr(rows), _i32ptr(off),
    )
    return rows, off, int(cap)


def mix32_native(cols) -> "np.ndarray | None":
    """Native parallel mix32 over int32 columns (bit-identical to
    engine/hash.py mix32), or None when unavailable."""
    L = lib()
    n = int(cols[0].shape[0]) if cols else 0
    if L is None or n < (1 << 16):
        return None
    cc = [np.ascontiguousarray(c, np.int32) for c in cols]
    ptrs = np.array([c.ctypes.data for c in cc], np.int64)
    out = np.empty(n, np.uint32)
    L.gi_mix32(
        ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(cc)), ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def pack32(a: np.ndarray, b: np.ndarray, radix: int) -> np.ndarray:
    """Parallel ``(a * radix + b).astype(int32)`` without the int64
    temporaries — engine/flat.py's dense key packing."""
    L = lib()
    n = int(a.shape[0])
    if L is None or n < (1 << 16):
        return (a.astype(np.int64) * radix + b).astype(np.int32)
    aa = np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(b, np.int32)
    out = np.empty(n, np.int32)
    L.gi_pack32(
        _i32ptr(aa), _i32ptr(bb), ctypes.c_int64(radix), ctypes.c_int64(n),
        _i32ptr(out),
    )
    return out


def join_sorted2(
    th: np.ndarray, tl: np.ndarray, qh: np.ndarray, ql: np.ndarray
) -> np.ndarray:
    """Exact join of (h, l)-lexsorted int64 pair sets: first table
    position per query, -1 on miss.  One native linear merge; the numpy
    fallback is the two-level grouped search (store/delta.py)."""
    L = lib()
    nq = qh.shape[0]
    if L is None or nq < (1 << 12):
        from ..store.delta import find_in_view

        return find_in_view(th, tl, qh, ql)
    th = np.ascontiguousarray(th, np.int64)
    tl = np.ascontiguousarray(tl, np.int64)
    qh = np.ascontiguousarray(qh, np.int64)
    ql = np.ascontiguousarray(ql, np.int64)
    out = np.empty(nq, np.int64)
    p64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    L.gi_join_sorted2(
        p64(th), p64(tl), ctypes.c_int64(th.shape[0]),
        p64(qh), p64(ql), ctypes.c_int64(nq), p64(out),
    )
    return out
