"""Columnar base segments: the scalable half of the Store.

The reference's BulkImport streams to a server engineered for bulk load
(client/client.go:438-465).  Here the equivalent is this layer: bulk
imports land as immutable int32 column blocks (one per import call) with
a sorted key sidecar, instead of per-edge Python ``Relationship`` objects
in the live dict — the dict stays for small interactive writes.  100M+
edges then cost numpy/native work (batch interning, vectorized
validation by *shape*, sorted-key dedup), not 100M Python objects.

Key packing: an edge key (res, rel, subj, srel1) packs into two int64s
h=(rel<<32)|res, l=(subj<<32)|srel1 (all components non-negative), and a
numpy structured array of (h, l) compares lexicographically — giving
O(log N) existence probes via ``searchsorted`` with no Python sets.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..native.sort import lexsort4
from ..rel.filter import Filter
from ..rel.relationship import Relationship, expiration_micros
from ..schema.compiler import CompiledSchema
from ..utils.errors import SchemaError

KEY_DT = np.dtype([("h", np.int64), ("l", np.int64)])


def pack_keys(
    res: np.ndarray, rel: np.ndarray, subj: np.ndarray, srel1: np.ndarray
) -> np.ndarray:
    out = np.empty(res.shape[0], KEY_DT)
    out["h"] = (rel.astype(np.int64) << 32) | res.astype(np.int64)
    out["l"] = (subj.astype(np.int64) << 32) | srel1.astype(np.int64)
    return out


def filter_columns(
    cols: Mapping[str, np.ndarray], rows: np.ndarray
) -> Dict[str, np.ndarray]:
    """Bucket-filtered column view: one vectorized (native-parallel) take
    per column, shared by the feed-partition path (engine/partition.py)
    — a multihost process keeps only the store-feed rows whose bucket
    shard it owns, as a gather over the feed columns, never a row-wise
    copy of the world.  int64 columns (exact expiry micros, packed keys)
    keep their width; everything else is int32 by construction."""
    from ..native.sort import take32, take64

    idx = np.ascontiguousarray(rows, np.int64)
    return {
        k: take64(v, idx) if v.dtype == np.int64 else take32(v, idx)
        for k, v in cols.items()
    }


class ColumnSegment:
    """One immutable bulk-imported block of edges with a mutable liveness
    mask (TOUCH/DELETE of an imported edge marks its row dead; the
    replacement lives in a newer segment or the live dict)."""

    __slots__ = (
        "res", "rel", "subj", "srel1", "caveat", "ctx", "exp_us",
        "live", "sorder", "_skey_h", "_skey_l",
    )

    def __init__(self, res, rel, subj, srel1, caveat, ctx, exp_us,
                 presorted=None) -> None:
        self.res = res
        self.rel = rel
        self.subj = subj
        self.srel1 = srel1
        self.caveat = caveat
        self.ctx = ctx
        self.exp_us = exp_us
        self.live = np.ones(res.shape[0], bool)
        if presorted is not None:
            # the commit path already key-sorted the batch: reuse its
            # (sorder, h-keys, l-keys) instead of re-sorting 10M rows
            self.sorder, self._skey_h, self._skey_l = presorted
        else:
            # native stable radix lexsort: np.argsort on the structured
            # key dtype is ~10s at 10M rows on this host, lexsort4 ~1.5s
            # (all key components are non-negative, so signed order ==
            # key order).  Only the two contiguous int64 halves are kept
            # — a structured copy would double per-segment key memory
            self.sorder = lexsort4(rel, res, subj, srel1)
            self._skey_h = (
                (rel.astype(np.int64) << 32) | res.astype(np.int64)
            )[self.sorder]
            self._skey_l = (
                (subj.astype(np.int64) << 32) | srel1.astype(np.int64)
            )[self.sorder]

    def __len__(self) -> int:
        return int(self.res.shape[0])

    @property
    def live_count(self) -> int:
        return int(np.count_nonzero(self.live))

    # -- key probes ------------------------------------------------------
    def rows_of_sorted_halves(
        self, qh: np.ndarray, ql: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(hit_mask, row_index) per query for queries ALREADY lexsorted
        by (h, l): one native linear merge against the segment's sorted
        keys (native/sort.py join_sorted2) — the bulk-import dup-probe
        path, O(E + B) with no per-key bisection."""
        from ..native.sort import join_sorted2

        n = int(self._skey_h.shape[0])
        hit = np.zeros(qh.shape[0], bool)
        rows = np.zeros(qh.shape[0], np.int64)
        if n:
            pos = join_sorted2(self._skey_h, self._skey_l, qh, ql)
            found = pos >= 0
            rows = self.sorder[np.clip(pos, 0, n - 1)]
            hit = found & self.live[rows]
        return hit, rows

    def rows_of_keys(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(hit_mask, row_index) per query key; only LIVE rows hit.  Keys
        are unique within a segment, so at most one row matches.

        The probe is a two-level int64 search over the (h, l) halves —
        np.searchsorted on the structured KEY_DT dtype falls off numpy's
        fast path (~4us per lookup, 37s for a 10M-row batch); the split
        search is plain int64 bisection (~100x faster)."""
        from .delta import find_in_view

        n = int(self._skey_h.shape[0])
        hit = np.zeros(keys.shape[0], bool)
        rows = np.zeros(keys.shape[0], np.int64)
        if n:
            pos = find_in_view(
                self._skey_h, self._skey_l,
                np.ascontiguousarray(keys["h"]),
                np.ascontiguousarray(keys["l"]),
            )
            found = pos >= 0
            rows = self.sorder[np.clip(pos, 0, n - 1)]
            hit = found & self.live[rows]
        return hit, rows

    def row_of_key(self, key: np.ndarray) -> int:
        """Live row index for one packed key, or -1."""
        hit, rows = self.rows_of_keys(key.reshape(1))
        return int(rows[0]) if hit[0] else -1

    # -- decoding --------------------------------------------------------
    def decode(
        self,
        row: int,
        interner,
        slot_names: Mapping[int, str],
        caveat_names: Mapping[int, str],
        contexts: Sequence[Mapping[str, Any]],
    ) -> Relationship:
        rtype, rid = interner.key_of(int(self.res[row]))
        stype, sid = interner.key_of(int(self.subj[row]))
        srel1 = int(self.srel1[row])
        cav = int(self.caveat[row])
        ctx_i = int(self.ctx[row])
        exp_us = int(self.exp_us[row])
        expiration = None
        if exp_us:
            expiration = _dt.datetime.fromtimestamp(
                exp_us / 1_000_000, tz=_dt.timezone.utc
            )
        return Relationship(
            resource_type=rtype,
            resource_id=rid,
            resource_relation=slot_names[int(self.rel[row])],
            subject_type=stype,
            subject_id=sid,
            subject_relation=slot_names[srel1 - 1] if srel1 > 0 else "",
            caveat_name=caveat_names[cav] if cav else "",
            caveat_context=contexts[ctx_i] if ctx_i >= 0 else {},
            expiration=expiration,
        )

    # -- vectorized filter matching -------------------------------------
    def filter_mask(
        self,
        f: Optional[Filter],
        compiled: CompiledSchema,
        interner,
        node_type: np.ndarray,
        now_us: Optional[int],
    ) -> np.ndarray:
        """Boolean mask of LIVE, unexpired rows matching the filter —
        the columnar mirror of Filter.matches/Snapshot.iter_relationships."""
        mask = self.live.copy()
        if now_us is not None:
            mask &= (self.exp_us == 0) | (self.exp_us > now_us)
        if f is None:
            return mask
        none = np.zeros(len(self), bool)
        if f.resource_type != "":
            tid = interner.type_lookup(f.resource_type)
            if tid < 0:
                return none
            mask &= node_type[self.res] == tid
        if f.optional_resource_id != "":
            n = interner.lookup(f.resource_type, f.optional_resource_id)
            if n < 0:
                return none
            mask &= self.res == n
        if f.optional_relation != "":
            s = compiled.slot_of_name.get(f.optional_relation)
            if s is None:
                return none
            mask &= self.rel == s
        sf = f.optional_subject_filter
        if sf is not None:
            if sf.subject_type != "":
                tid = interner.type_lookup(sf.subject_type)
                if tid < 0:
                    return none
                mask &= node_type[self.subj] == tid
            if sf.optional_subject_id != "":
                n = interner.lookup(sf.subject_type, sf.optional_subject_id)
                if n < 0:
                    return none
                mask &= self.subj == n
            if sf.optional_relation is not None:
                if sf.optional_relation == "":
                    mask &= self.srel1 == 0
                else:
                    s = compiled.slot_of_name.get(sf.optional_relation)
                    if s is None:
                        return none
                    mask &= self.srel1 == s + 1
        return mask

    # -- schema migration ------------------------------------------------
    def remap_slots(
        self, slot_map: np.ndarray, caveat_map: np.ndarray
    ) -> None:
        """Renumber relation/caveat ids after a schema write (slot
        numbering is schema-derived; segments outlive schemas).  Maps are
        old-id → new-id arrays; -1 entries never occur for ids referenced
        by validated live rows."""
        self.rel = slot_map[self.rel]
        srel = self.srel1.astype(np.int64) - 1
        remapped = np.where(srel >= 0, slot_map[np.clip(srel, 0, None)], -1)
        self.srel1 = (remapped + 1).astype(np.int32)
        self.caveat = caveat_map[self.caveat]
        self.sorder = lexsort4(self.rel, self.res, self.subj, self.srel1)
        self._skey_h = (
            (self.rel.astype(np.int64) << 32) | self.res.astype(np.int64)
        )[self.sorder]
        self._skey_l = (
            (self.subj.astype(np.int64) << 32) | self.srel1.astype(np.int64)
        )[self.sorder]


def relationships_to_columns(
    batch: Sequence[Relationship],
    compiled: CompiledSchema,
    interner,
    contexts: List[Mapping[str, Any]],
    ctx_index: Dict[str, int],
) -> Dict[str, np.ndarray]:
    """Convert a batch of Relationship objects to int columns with batch
    interning and *shape-level* validation: write-validity depends only on
    (resource_type, relation, subject_type, subject_relation, wildcard,
    caveat, has_expiration) — one validate per distinct shape, not per
    edge.  Appends novel caveat contexts to ``contexts`` (deduplicated by
    canonical repr through ``ctx_index``)."""
    B = len(batch)
    slot_of = compiled.slot_of_name
    caveat_ids = compiled.caveat_ids

    rtypes: List[str] = [""] * B
    rids: List[str] = [""] * B
    stypes: List[str] = [""] * B
    sids: List[str] = [""] * B
    rrels: List[str] = [""] * B
    srels: List[str] = [""] * B
    cavs: List[str] = [""] * B
    caveat = np.zeros(B, np.int32)
    ctx = np.full(B, -1, np.int32)
    exp_us = np.zeros(B, np.int64)

    # single pass over the Python objects: attribute copies only; the
    # conditional work (caveat context dedup, expiry lowering) runs per
    # row ONLY where the fields are set — bulk restores are dominated by
    # plain rows, and every avoidable per-row op costs ~0.2s per million
    shape_rep: Dict[tuple, int] = {}
    for i, r in enumerate(batch):
        rtypes[i] = r.resource_type
        rids[i] = r.resource_id
        stypes[i] = r.subject_type
        sids[i] = r.subject_id
        rrels[i] = r.resource_relation
        srels[i] = r.subject_relation
        if r.caveat_name:
            cavs[i] = r.caveat_name
            cid = caveat_ids.get(r.caveat_name)
            if cid is None:
                # unknown caveat: validation (which runs after this
                # loop) owns the error type — raise ITS error, not a
                # bare KeyError
                compiled.validate_relationship(r)
                raise SchemaError(f"caveat `{r.caveat_name}` not found")
            caveat[i] = cid
            if r.caveat_context:
                ck = repr(sorted(r.caveat_context.items(), key=lambda kv: kv[0]))
                at = ctx_index.get(ck)
                if at is None:
                    at = len(contexts)
                    ctx_index[ck] = at
                    contexts.append(r.caveat_context)
                ctx[i] = at
        if r.expiration is not None and r.has_expiration():
            exp_us[i] = expiration_micros(r.expiration)

    # shape-level validation OUTSIDE the row loop: zip+set runs at C
    # speed, one validate per distinct shape
    for shape, i in {
        (rt, rr, st, sr, sid == "*", cv, bool(e)): i
        for i, (rt, rr, st, sr, sid, cv, e) in enumerate(
            zip(rtypes, rrels, stypes, srels, sids, cavs, exp_us)
        )
    }.items():
        compiled.validate_relationship(batch[i])

    rel = np.fromiter((slot_of[x] for x in rrels), np.int32, B)
    srel1 = np.fromiter(
        (slot_of[x] + 1 if x else 0 for x in srels), np.int32, B
    )

    if hasattr(interner, "node_batch_typed"):
        tid_of: Dict[str, int] = {}

        def tids(names: List[str]) -> np.ndarray:
            # distinct type names are few: resolve them once, then map
            # the column through the dict at C speed
            for n in set(names) - tid_of.keys():
                tid_of[n] = interner.type_id(n)
            return np.fromiter((tid_of[n] for n in names), np.int32, len(names))

        res = interner.node_batch_typed(tids(rtypes), rids)
        subj = interner.node_batch_typed(tids(stypes), sids)
    else:
        res = np.fromiter(
            (interner.node(t, i) for t, i in zip(rtypes, rids)), np.int32, B
        )
        subj = np.fromiter(
            (interner.node(t, i) for t, i in zip(stypes, sids)), np.int32, B
        )
    return {
        "res": res, "rel": rel, "subj": subj, "srel1": srel1,
        "caveat": caveat, "ctx": ctx, "exp_us": exp_us,
    }


def iter_segment_rows(seg: ColumnSegment, rows: Iterator[int]):
    """Helper for lazy Update views (see store._ColumnUpdates)."""
    return rows
