"""Bit-packed device tables: the HBM-lean stacked layout.

The aligned/interleaved tables of engine/flat.py spend one int32 lane
per logical column at fixed row width, and their bucket-offset arrays
grow up to 8x the entry count chasing a probe cap of 4 — at the 1B-edge
deployment this (not host RSS) is the binding constraint: ~82 GB of
table bytes per device at the reference's widths (BENCHMARKS.md "Partitioned
serving").  TpuGraphs (arXiv:2308.13490) documents layout/packing
dominating TPU graph-workload cost; this module is that observation
applied to the probe tables:

- **bit-packed columns** — a dense (slot, node) key needs
  ⌈log2(slots·N)⌉ bits, a caveat id ⌈log2(ncav)⌉, a userset fan length
  a handful; multiple logical columns share uint16 lanes, and the
  kernel decodes with compiled shift/mask ops fused into the existing
  block gathers (the bytes cross HBM packed; registers are free);
- **dictionary columns** — the closure/T until-values are almost always
  one of {NEVER, NO_EXP, pad}: the lane stores a ≤4-bit dictionary
  index and the kernel rematerializes the int32 through a trace-time
  constant table (the round-3 "alllive" elision, generalized from
  all-or-nothing to any small value set);
- **delta-run ranges** — the range group tables store (key, lo, hi)
  with hi a full-width row offset; packed they store (key, lo,
  hi - lo), and the run LENGTH fits the view's fan bits (the
  sorted-runs structure the host build already derives);
- **offset residuals** — bucket offsets are monotone, so ``off[i]``
  splits into a coarse int32 anchor every 2^A buckets plus a uint16
  residual; two tiny gathers replace one over an array 2x the size.

Pack specs are HASHABLE TUPLES riding FlatMeta (they are part of the
compiled-kernel cache key), and crucially they derive from table
GEOMETRY + globally-replicated domains (radices, fan caps, caveat/ctx
counts, until-value dictionaries) — never from scanning a built shard —
so every process of a multihost partitioned build agrees on the packed
bytes before any table exists (the agreement-before-build discipline of
engine/partition.py), and Watch delta chains keep one compiled kernel
(domains are radix-stable under deltas).

Field encoding: ``stored = value - base`` (or a dictionary index) in
``bits`` bits at ``off_bit`` in the row's uint16 lane stream; a field
never spans more than two lanes (decode stays in int32).  ``bits == 0``
is a constant column: nothing is stored, decode broadcasts ``base``.
Decode is exact for every value the spec admits — parity with the
unpacked layout is bit-for-bit by construction, and the packers VERIFY
range membership (a value outside its declared domain raises rather
than aliasing).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .consts import device_const

#: rows per packing chunk: the pack pass walks the source table in
#: bounded windows, so converting a 100M-row table never materializes a
#: second full-width copy (tests/test_packed.py arms alloc_guard on it)
CHUNK = 1 << 20

#: Field = (bits, base, delta_of, dict_id, off_bit)
#:   bits      storage width (0 = constant column, value == base)
#:   base      subtracted before store / added after load (dict: unused)
#:   delta_of  column index whose DECODED value adds back in (-1 = none)
#:   dict_id   index into the spec's dictionaries (-1 = plain range)
#:   off_bit   starting bit offset in the row's uint16 lane stream
#: Spec = (w, lanes, fields, dicts) with dicts a tuple of sorted value
#: tuples — everything ints, hashable, FlatMeta-safe.
Field = Tuple[int, int, int, int, int]
Spec = Tuple[int, int, Tuple[Field, ...], Tuple[Tuple[int, ...], ...]]


class PackError(ValueError):
    """A value fell outside its declared pack domain (builder bug or a
    delta that outgrew a pinned spec — callers bail to unpacked)."""


# ---------------------------------------------------------------------------
# alloc guard (tests): bound every temporary the packers allocate
# ---------------------------------------------------------------------------

_ALLOC_CAP = [None]  # type: List[Optional[int]]


class alloc_guard:
    """Context manager bounding per-temporary bytes inside this module.
    tests/test_packed.py arms it below the full-width table size and
    runs a packed prepare: any single full-size intermediate trips it."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)

    def __enter__(self):
        _ALLOC_CAP[0] = self.max_bytes
        return self

    def __exit__(self, *exc):
        _ALLOC_CAP[0] = None
        return False


def _tmp(shape, dtype) -> np.ndarray:
    """Temporary buffer, checked against the armed alloc guard."""
    a = np.empty(shape, dtype)
    cap = _ALLOC_CAP[0]
    if cap is not None and a.nbytes > cap:
        raise AssertionError(
            f"packed.py temporary of {a.nbytes} bytes exceeds the armed"
            f" alloc guard ({cap}): full-width intermediate materialized"
        )
    return a


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------


def bits_for(lo: int, hi: int) -> int:
    """Storage bits for the inclusive value range [lo, hi]."""
    span = int(hi) - int(lo)
    if span <= 0:
        return 0
    return max(1, span.bit_length())


def col_range(lo: int, hi: int) -> Tuple[str, int, int]:
    """Column descriptor: plain range (pad/-1 must be inside it)."""
    return ("range", int(lo), int(hi))


def col_const(v: int) -> Tuple[str, int, int]:
    return ("range", int(v), int(v))


def col_dict(values) -> Tuple:
    """Column descriptor: small-set dictionary (sorted, deduped here)."""
    vs = tuple(sorted({int(v) for v in values}))
    return ("dict", vs)


def col_delta(lo: int, hi: int, of: int) -> Tuple[str, int, int, int]:
    """Column stored as (value - decoded column ``of``) in [lo, hi]."""
    return ("delta", int(lo), int(hi), int(of))


def make_spec(descs: Sequence[Tuple]) -> Optional[Spec]:
    """Field placement over uint16 lanes; None when packing does not
    shrink the row (lanes*2 >= w*4) or a field cannot be represented."""
    w = len(descs)
    placed: List[Tuple[int, int, int, int, int]] = []
    dicts: List[Tuple[int, ...]] = []
    off = 0
    for d in descs:
        kind = d[0]
        if kind == "dict":
            vs = d[1]
            if len(vs) > 256:
                return None  # not a small set: give up on the table
            bits, base, delta_of, dict_id = (
                bits_for(0, len(vs) - 1), 0, -1, len(dicts)
            )
            dicts.append(vs)
        elif kind == "delta":
            _, lo, hi, of = d
            bits, base, delta_of, dict_id = bits_for(lo, hi), lo, of, -1
        else:
            _, lo, hi = d
            bits, base, delta_of, dict_id = bits_for(lo, hi), lo, -1, -1
        if bits > 32:
            return None
        # a field may straddle at most ONE lane boundary (decode
        # reassembles in int32); bump to the next lane otherwise
        if bits > 16 and (off & 15) + bits > 32:
            off = (off + 15) & ~15
        placed.append((bits, int(base), int(delta_of), int(dict_id), off))
        off += bits
    lanes = max((off + 15) >> 4, 1)
    if lanes * 2 >= w * 4:
        return None  # no byte win: keep the int32 layout
    return (w, lanes, tuple(placed), tuple(dicts))


# ---------------------------------------------------------------------------
# host-side pack (chunked, alloc-guarded)
# ---------------------------------------------------------------------------


def _encode_field(v: np.ndarray, bits, base, delta_of, dict_id, dicts,
                  decoded_prev) -> np.ndarray:
    """int32 column chunk → unsigned field values (int64 for safety)."""
    if delta_of >= 0:
        v = v.astype(np.int64) - decoded_prev[delta_of].astype(np.int64)
    else:
        v = v.astype(np.int64)
    if dict_id >= 0:
        dv = np.asarray(dicts[dict_id], np.int64)
        idx = np.searchsorted(dv, v)
        idxc = np.clip(idx, 0, len(dv) - 1)
        if not bool((dv[idxc] == v).all()):
            raise PackError("value outside dictionary domain")
        return idxc.astype(np.int64)
    u = v - base
    if bits == 0:
        if not bool((u == 0).all()):
            raise PackError("non-constant value in constant column")
        return u
    if bool((u < 0).any()) or bool((u >> bits).any()):
        raise PackError("value outside declared pack range")
    return u


def pack_rows(tbl: np.ndarray, spec: Spec) -> np.ndarray:
    """Pack an int32 [n, w] table into uint16 [n, lanes], in CHUNK-row
    windows (every temporary is chunk-sized; see alloc_guard)."""
    w, lanes, fields, dicts = spec
    n = int(tbl.shape[0])
    assert tbl.shape[1] == w, (tbl.shape, w)
    out = np.zeros((n, lanes), np.uint16)
    for at in range(0, max(n, 1), CHUNK):
        hi = min(at + CHUNK, n)
        if hi <= at:
            break
        chunk = tbl[at:hi]
        decoded = [chunk[:, j] for j in range(w)]
        acc = _tmp((hi - at, lanes), np.uint32)
        acc[:] = 0
        for j, (bits, base, delta_of, dict_id, off_bit) in enumerate(fields):
            if bits == 0:
                _encode_field(  # validates constancy
                    decoded[j], bits, base, delta_of, dict_id, dicts, decoded
                )
                continue
            u = _encode_field(
                decoded[j], bits, base, delta_of, dict_id, dicts, decoded
            )
            lane, sh = off_bit >> 4, off_bit & 15
            acc[:, lane] |= ((u << sh) & 0xFFFF).astype(np.uint32)
            if sh + bits > 16:
                acc[:, lane + 1] |= ((u >> (16 - sh)) & 0xFFFF).astype(
                    np.uint32
                )
        out[at:hi] = acc.astype(np.uint16)
    return out


# ---------------------------------------------------------------------------
# offset residuals (single-chip layouts; sharded offs stay int32)
# ---------------------------------------------------------------------------

#: anchor block shift: one int32 anchor per 2^A buckets.  Larger A →
#: smaller anchors, wider residual range; 11 keeps the anchor array at
#: 1/2048 of the offsets while typical loads (≤4 rows/bucket) stay far
#: inside uint16
OFF_ANCHOR_SHIFT = 11


def pack_off(off: np.ndarray, shift: int = OFF_ANCHOR_SHIFT):
    """(residual uint16[len], anchor int32[ceil(len/2^A)]) with
    ``off[i] == anchor[i >> A] + residual[i]`` — or None when some
    anchor block spans ≥ 2^16 rows (keep int32).  The anchor is the
    block MINIMUM, so residuals are non-negative by construction."""
    n = int(off.shape[0])
    blocks = (n + (1 << shift) - 1) >> shift
    o = off.astype(np.int64)
    pad = blocks * (1 << shift) - n
    if pad:
        o = np.concatenate([o, np.full(pad, o[-1] if n else 0, np.int64)])
    ob = o.reshape(blocks, 1 << shift)
    anchor = ob.min(axis=1)
    res = ob - anchor[:, None]
    if int(res.max(initial=0)) >= (1 << 16):
        return None
    return (
        res.reshape(-1)[:n].astype(np.uint16),
        anchor.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# device-side decode (traced; fused into the probe gathers)
# ---------------------------------------------------------------------------


def decode_block(blk, spec: Spec):
    """[..., lanes] probe block of uint16 lanes (stored as int16) →
    int32[..., w] logical columns.  Pure elementwise shift/mask plus a
    tiny dictionary gather; lanes widen ``& 0xFFFF`` before any shift
    (torch has no shifts on uint16 on the CPU).  Dictionary indices clamp
    into the dictionary, as the reference's gather does; pack_rows only
    ever stores in-domain indices."""
    w, lanes, fields, dicts = spec
    l32 = blk.to(torch.int32) & 0xFFFF
    cols: List = [None] * w
    for j, (bits, base, delta_of, dict_id, off_bit) in enumerate(fields):
        if bits == 0:
            col = torch.full(blk.shape[:-1], base, dtype=torch.int32,
                             device=blk.device)
        else:
            lane, sh = off_bit >> 4, off_bit & 15
            v = l32[..., lane] >> sh if sh else l32[..., lane]
            if sh + bits > 16:
                v = v | (l32[..., lane + 1] << (16 - sh))
            if bits < 32:
                v = v & ((1 << bits) - 1)
            if dict_id >= 0:
                vals = tuple(dicts[dict_id])
                dv = device_const(
                    ("dict", vals), blk.device,
                    lambda d, v=vals: torch.tensor(v, dtype=torch.int32,
                                                   device=d))
                col = dv[v.clamp(0, dv.shape[0] - 1).long()]
            else:
                col = v + _i32(base) if base else v
        if delta_of >= 0:
            col = col + cols[delta_of]
        cols[j] = col
    return torch.stack(cols, dim=-1)


def _i32(x: int) -> int:
    """``x`` wrapped into the int32 range (a base added in int32
    arithmetic wraps the way the reference's int32 add does)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def narrow_nodes(a: np.ndarray, num_types: int) -> np.ndarray:
    """node_type column in the narrowest dtype its domain allows
    (values in [-1, num_types); the kernel widens after the gather)."""
    if num_types < 127:
        return a.astype(np.int8)
    if num_types < (1 << 15) - 1:
        return a.astype(np.int16)
    return a
