"""Incremental snapshot materialization (Watch-driven re-index).

A full rebuild (`build_snapshot`) walks every live relationship through
Python objects, re-interns, and re-sorts — O(E log E) with a Python-loop
constant.  That is fine at write-schema time, but BASELINE config 5
(Leopard-scale Watch-driven re-index) needs each new revision to cost
O(E + D log D) for a delta of D updates against an E-edge graph, with no
per-old-edge Python work.

`apply_delta` takes the previous revision's Snapshot plus the collapsed
delta (last-writer-wins per tuple key) and produces the next Snapshot by:

1. lowering only the delta's relationships to int32 columns (interning at
   most O(D) new strings),
2. locating the delta keys in the previous primary order with a two-level
   packed-int64 binary search ((rel,res) run, then (subj,srel1) inside the
   run — the primary sort is lex (rel, res, subj, srel1) so both levels
   are sorted),
3. tombstoning replaced/deleted rows and merging the surviving rows with
   the sorted additions in one O(E + D) pass, and
4. re-deriving the secondary views (userset / membership / arrow) through
   the same `finish_snapshot` used by the full build, so delta and full
   materialization produce identical snapshots by construction.

The derived views are O(E) vectorized work with small constants; the
expensive parts of a full rebuild (per-edge Python, global lexsort,
re-interning) are all avoided.  Reference semantics being reproduced:
the Watch feed is the ordered update log (client/client.go:364-413) and a
revision is a consistent snapshot of it (consistency/consistency.go).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..rel.relationship import Relationship, expiration_micros
from ..schema.compiler import CompiledSchema
from .interner import Interner
from .snapshot import Snapshot, _exp_to_rel32, finish_snapshot


@dataclass
class DeltaInfo:
    """Machine-readable description of the delta that produced a snapshot,
    attached to it by ``apply_delta`` (as ``snap.delta_info``) so the
    device engine can advance its resident tables incrementally
    (engine/flat.py build_delta_arrays) instead of re-shipping O(E) state.

    ``a_*``: the upserted rows (lowered, epoch-relative expiry).
    ``g_*``: primary-identity columns of every row REMOVED from the
    previous snapshot — deletions plus rows replaced by an upsert.
    """

    prev_revision: int
    a_rel: np.ndarray
    a_res: np.ndarray
    a_subj: np.ndarray
    a_srel1: np.ndarray
    a_cav: np.ndarray
    a_ctx: np.ndarray
    a_exp: np.ndarray  # epoch-relative int32 (device form)
    g_rel: np.ndarray
    g_res: np.ndarray
    g_subj: np.ndarray
    g_srel1: np.ndarray
    #: True when context indices were renumbered by compaction — stored
    #: ctx ids inside device-resident base tables are then stale and the
    #: device must do a full prepare
    contexts_renumbered: bool = False

#: contexts-list compaction floor: below this length, dead context dicts
#: are retained so indices stay append-only stable (the device delta-
#: prepare depends on that; tests lower it to force renumbering)
CTX_COMPACT_MIN = 1024

# (rel, res) packed: rel < 2**15 slots, res < 2**31 nodes → 46 bits.
_RES_BITS = 31
# (subj, srel1) packed: subj < 2**31, srel1 < 2**16 → 47 bits.
_SREL_BITS = 16


def _pack_rr(rel: np.ndarray, res: np.ndarray) -> np.ndarray:
    return (rel.astype(np.int64) << _RES_BITS) | res.astype(np.int64)


def _pack_ss(subj: np.ndarray, srel1: np.ndarray) -> np.ndarray:
    return (subj.astype(np.int64) << _SREL_BITS) | srel1.astype(np.int64)


def _grouped(inverse: np.ndarray) -> "list[np.ndarray]":
    """Index arrays of each group in ``inverse`` (np.unique's inverse),
    in group order — argsort+split so grouping is O(D log D) total, not
    O(runs × D)."""
    order = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse)
    return np.split(order, np.cumsum(counts)[:-1])


def find_in_view(
    old_k1: np.ndarray, old_k2: np.ndarray, q1: np.ndarray, q2: np.ndarray
) -> np.ndarray:
    """Row index of each (q1, q2) in a view lexsorted by (k1, k2); -1 when
    absent.  Two-level binary search vectorized over the k1 runs."""
    D = q1.shape[0]
    out = np.full(D, -1, dtype=np.int64)
    if D == 0 or old_k1.shape[0] == 0:
        return out
    lo = np.searchsorted(old_k1, q1, side="left")
    hi = np.searchsorted(old_k1, q1, side="right")
    run = hi > lo
    if np.any(run):
        runs, inverse = np.unique(lo[run], return_inverse=True)
        idx_run = np.nonzero(run)[0]
        for run_lo, group in zip(runs, _grouped(inverse)):
            members = idx_run[group]
            run_hi = hi[members[0]]
            seg = old_k2[run_lo:run_hi]
            pos = run_lo + np.searchsorted(seg, q2[members], side="left")
            ok = (pos < run_hi) & (old_k2[np.clip(pos, 0, old_k2.shape[0] - 1)] == q2[members])
            out[members[ok]] = pos[ok]
    return out


def merge_positions(
    old_k1: np.ndarray, old_k2: np.ndarray, new_k1: np.ndarray, new_k2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Interleave positions merging two (k1, k2)-lexsorted row sets:
    returns (pos_old, pos_new) into the merged array of len(old)+len(new).
    O(E + D log E) — the argsort-free merge the Watch-driven re-index
    depends on (BASELINE config 5)."""
    E0, A = old_k1.shape[0], new_k1.shape[0]
    ins = np.searchsorted(old_k1, new_k1, side="left")
    hi = np.searchsorted(old_k1, new_k1, side="right")
    run = hi > ins
    if np.any(run):
        runs, inverse = np.unique(ins[run], return_inverse=True)
        idx_run = np.nonzero(run)[0]
        for run_lo, group in zip(runs, _grouped(inverse)):
            members = idx_run[group]
            run_hi = hi[members[0]]
            seg = old_k2[run_lo:run_hi]
            ins[members] = run_lo + np.searchsorted(
                seg, new_k2[members], side="left"
            )
    add_before = np.zeros(E0 + 1, dtype=np.int64)
    np.add.at(add_before, ins, 1)
    add_before = np.cumsum(add_before)[: E0 + 1]
    pos_old = np.arange(E0, dtype=np.int64) + add_before[:E0]
    pos_new = ins + np.arange(A, dtype=np.int64)
    return pos_old, pos_new


def _locate(
    prev: Snapshot, rel: np.ndarray, res: np.ndarray,
    subj: np.ndarray, srel1: np.ndarray,
) -> np.ndarray:
    """Row index in prev's primary arrays of each (rel,res,subj,srel1)
    identity, or -1 when absent.  Two-level search, vectorized over the
    (rel,res) runs the queries land in."""
    D = rel.shape[0]
    out = np.full(D, -1, dtype=np.int64)
    if D == 0 or prev.e_rel.shape[0] == 0:
        return out
    # packed identity keys cached per snapshot: a delta chain locates
    # against the same base every revision, and re-packing 2·E int64
    # columns per delta was the only remaining O(E) term of the LSM path
    packed = prev.__dict__.get("_packed_id_keys")
    if packed is None:
        packed = (
            _pack_rr(prev.e_rel, prev.e_res),
            _pack_ss(prev.e_subj, prev.e_srel1),
        )
        prev.__dict__["_packed_id_keys"] = packed
    prev_rr, prev_ss = packed
    q_rr = _pack_rr(rel, res)
    q_ss = _pack_ss(subj, srel1)
    lo = np.searchsorted(prev_rr, q_rr, side="left")
    hi = np.searchsorted(prev_rr, q_rr, side="right")
    # group queries by run so each run's slice is searched once
    nonempty = hi > lo
    runs, inverse = np.unique(lo[nonempty], return_inverse=True)
    idx_nonempty = np.nonzero(nonempty)[0]
    for run_lo, group in zip(runs, _grouped(inverse)):
        members = idx_nonempty[group]
        run_hi = hi[members[0]]
        seg = prev_ss[run_lo:run_hi]
        pos = np.searchsorted(seg, q_ss[members], side="left")
        ok = (pos < seg.shape[0]) & (seg[np.minimum(pos, seg.shape[0] - 1)] == q_ss[members])
        out[members[ok]] = run_lo + pos[ok]
    return out


def _lower_delta(
    compiled: CompiledSchema,
    interner: Interner,
    rels: Sequence[Relationship],
    contexts: List[Mapping[str, Any]],
    ctx_index: Optional[dict] = None,
) -> Tuple[np.ndarray, ...]:
    """Relationship objects → unsorted int columns (interning new strings),
    appending any caveat contexts to ``contexts`` in place.  Contexts are
    deduplicated by value so re-touching a caveated tuple revision after
    revision reuses one stored dict instead of growing the list."""
    D = len(rels)
    res = np.empty(D, dtype=np.int64)
    rel_s = np.empty(D, dtype=np.int64)
    subj = np.empty(D, dtype=np.int64)
    srel1 = np.empty(D, dtype=np.int64)
    cav = np.zeros(D, dtype=np.int32)
    ctx = np.full(D, -1, dtype=np.int32)
    exp_us = np.zeros(D, dtype=np.int64)
    slot_of = compiled.slot_of_name
    caveat_ids = compiled.caveat_ids
    if ctx_index is None:
        ctx_index = {}
        for i, c in enumerate(contexts):
            ctx_index.setdefault(
                repr(sorted(c.items(), key=lambda kv: kv[0])), i
            )
    for i, r in enumerate(rels):
        res[i] = interner.node(r.resource_type, r.resource_id)
        rel_s[i] = slot_of[r.resource_relation]
        subj[i] = interner.node(r.subject_type, r.subject_id)
        srel1[i] = slot_of[r.subject_relation] + 1 if r.subject_relation else 0
        if r.caveat_name:
            cav[i] = caveat_ids[r.caveat_name]
            if r.caveat_context:
                key = repr(sorted(r.caveat_context.items(), key=lambda kv: kv[0]))
                at = ctx_index.get(key)
                if at is None:
                    at = len(contexts)
                    ctx_index[key] = at
                    contexts.append(r.caveat_context)
                ctx[i] = at
        exp_us[i] = expiration_micros(r.expiration) if r.has_expiration() else 0
    return res, rel_s, subj, srel1, cav, ctx, exp_us


#: host-side LSM compaction floor: once the accumulated overlay (adds +
#: tombstones) crosses max(this, E/8), apply_delta materializes the chain
#: into a fresh base instead of growing it.  Mirrors the device's
#: EngineConfig.flat_delta_min_compact so host and device compact on the
#: same revision (the device bails to a full prepare at the same bound,
#: which touches every view and would materialize anyway).  Tunable per
#: store via EngineConfig.lsm_compact_min (threaded through apply_delta's
#: ``compact_min``); this module constant is only the default.
LSM_COMPACT_MIN = 65_536


class _lazycol:
    """Non-data descriptor for one deferred Snapshot column: first access
    materializes the whole snapshot (filling the instance __dict__, after
    which instance attributes win and this descriptor is never consulted
    again)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        obj._materialize()
        return obj.__dict__[self.name]


#: every Snapshot column derived from the primary arrays — exactly the
#: fields LsmSnapshot defers until something actually reads them
_LAZY_FIELDS = (
    "e_rel", "e_res", "e_subj", "e_srel1", "e_caveat", "e_ctx", "e_exp",
    "e_exp_us",
    "us_rel", "us_res", "us_subj", "us_srel", "us_caveat", "us_ctx",
    "us_exp", "us_perm", "pus_n", "pus_r",
    "ms_subj", "ms_res", "ms_rel", "ms_caveat", "ms_ctx", "ms_exp",
    "mp_subj", "mp_srel", "mp_res", "mp_rel", "mp_caveat", "mp_ctx",
    "mp_exp",
    "ar_rel", "ar_res", "ar_child", "ar_caveat", "ar_ctx", "ar_exp",
)


class LsmSnapshot(Snapshot):
    """Deferred-merge snapshot: a materialized base plus one collapsed,
    (rel,res,subj,srel1)-sorted overlay of adds and a tombstone set of
    base rows.  ``apply_delta`` returns these so a Watch-driven revision
    costs O(D log E) host work instead of rewriting E rows — the host
    half of BASELINE config 5's re-index budget.

    The device's incremental prepare reads only ``delta_info`` and the
    eager scalars (num_nodes, node_type, wildcard table, us_used_keys);
    every derived column is a non-data descriptor that materializes the
    full merge on first touch (host oracle fallback, exports, full
    device prepares), after which the instance behaves exactly like the
    snapshot the eager path would have produced — same
    ``finish_snapshot``, so identical by construction."""

    def __init__(self, base: Snapshot, revision: int, *, interner,
                 contexts, ov, gone_base: np.ndarray, num_nodes: int,
                 node_type: np.ndarray, wc: np.ndarray):
        # deliberately NOT calling the dataclass __init__: column fields
        # stay unset so the class-level _lazycol descriptors fire
        self.revision = revision
        self.compiled = base.compiled
        self.interner = interner
        self.num_nodes = num_nodes
        self.num_slots = base.num_slots
        self.epoch_us = base.epoch_us
        self.node_type = node_type
        self.wildcard_node_of_type = wc
        self.contexts = contexts
        # conservative carry-forward: eligible deltas never grow the set
        # (new userset subjects bail the device to a full prepare, which
        # materializes and recomputes); a stale superset only causes
        # extra full prepares, never wrong answers
        self.us_used_keys = getattr(base, "us_used_keys", None)
        self._lsm_base = base
        self._lsm_ov = ov  # dict of sorted overlay columns
        self._lsm_gone = gone_base  # sorted unique base-row tombstones
        self._lsm_lock = threading.Lock()  # one merge even under races

    @property
    def num_edges(self) -> int:
        if self.__dict__.get("_lsm_done"):
            return int(self.__dict__["e_rel"].shape[0])
        return int(
            self._lsm_base.e_rel.shape[0]
            - self._lsm_gone.shape[0]
            + self._lsm_ov["rel"].shape[0]
        )

    @property
    def overlay_rows(self) -> int:
        """Accumulated chain size (overlay adds + base tombstones): the
        quantity the compaction bound compares against max(compact_min,
        E/8), and what every probe pays an extra binary search over.
        0 once materialized."""
        if self.__dict__.get("_lsm_done"):
            return 0
        return int(self._lsm_ov["rel"].shape[0] + self._lsm_gone.shape[0])

    @property
    def chain_base_revision(self) -> int:
        """Revision of the materialized base this chain grows from (the
        chain length in revisions is ``revision - chain_base_revision``);
        own revision once materialized."""
        if self.__dict__.get("_lsm_done"):
            return int(self.revision)
        return int(self._lsm_base.revision)

    def _materialize(self, compact_ctx: bool = False) -> bool:
        if self.__dict__.get("_lsm_done"):
            return False
        with self._lsm_lock:
            return self._materialize_locked(compact_ctx)

    def _materialize_locked(self, compact_ctx: bool) -> bool:
        if self.__dict__.get("_lsm_done"):
            return False
        base, ov = self._lsm_base, self._lsm_ov
        keep = np.ones(base.e_rel.shape[0], dtype=bool)
        keep[self._lsm_gone] = False
        old_rr = _pack_rr(base.e_rel, base.e_res)[keep]
        old_ss = _pack_ss(base.e_subj, base.e_srel1)[keep]
        new_rr = _pack_rr(ov["rel"], ov["res"])
        new_ss = _pack_ss(ov["subj"], ov["srel1"])
        E0, A = old_rr.shape[0], new_rr.shape[0]
        pos_old, pos_new = merge_positions(old_rr, old_ss, new_rr, new_ss)

        def interleave(old: np.ndarray, new: np.ndarray) -> np.ndarray:
            out = np.empty(E0 + A, dtype=old.dtype)
            out[pos_old] = old[keep]
            out[pos_new] = new
            return out

        e_ctx = interleave(base.e_ctx, ov["ctx"])
        contexts = self.contexts
        renumbered = False
        if compact_ctx:
            # renumbering is only sound at BUILD time (before the device
            # consumed this revision's delta_info): the caller flags the
            # delta contexts_renumbered so baked-in ctx ids are not
            # trusted.  A lazy (post-handoff) materialization must never
            # compact — the device may already hold the old ids
            used = e_ctx >= 0
            if not used.any():
                renumbered = bool(contexts)
                contexts = []
            else:
                live_ctx, inv = np.unique(e_ctx[used], return_inverse=True)
                if len(contexts) > live_ctx.shape[0]:
                    contexts = [contexts[i] for i in live_ctx]
                    e_ctx[used] = inv.astype(np.int32)
                    renumbered = True
            self.contexts = contexts
        nxt = finish_snapshot(
            self.revision, self.compiled, self.interner,
            e_rel=interleave(base.e_rel, ov["rel"]),
            e_res=interleave(base.e_res, ov["res"]),
            e_subj=interleave(base.e_subj, ov["subj"]),
            e_srel1=interleave(base.e_srel1, ov["srel1"]),
            e_caveat=interleave(base.e_caveat, ov["cav"]),
            e_ctx=e_ctx,
            e_exp=interleave(base.e_exp, ov["exp"]),
            e_exp_us=interleave(base.e_exp_us, ov["exp_us"]),
            contexts=contexts, epoch_us=self.epoch_us,
        )
        for f in _LAZY_FIELDS:
            self.__dict__[f] = getattr(nxt, f)
        # finish_snapshot recomputes the used-userset set from the merged
        # rows — replace the conservative carry-forward with the truth
        self.__dict__["us_used_keys"] = nxt.us_used_keys
        # carry the lookup index across the chain BEFORE the state that
        # feeds the advance is dropped: identity-based advance from the
        # base's index with the accumulated tombstones + overlay — the
        # O(E + D log E) path that keeps warm lookup_resources warm
        # across a Watch chain (engine/lookup.py advance_lookup_index).
        # _lsm_done publishes only AFTER this block, so a concurrent
        # first lookup either waits on the lock (and finds the carried
        # index) or arrives later — it can never slip between the merge
        # and the carry and pay a redundant rebuild
        if (
            getattr(base, "_lookup_index", None) is None
            and base.__dict__.get("_lookup_chain_stash") is not None
        ):
            # the base itself carries an unredeemed stash (it was the
            # tip of an earlier chain, materialized while its index was
            # still unused): redeem it now so the carry below has a base
            # index to advance from — otherwise the stash is orphaned
            # and the chain's index lineage is silently dropped
            from ..engine.lookup import redeem_chain_stash

            redeem_chain_stash(base)
        if (
            getattr(self, "_lookup_index", None) is None
            and getattr(base, "_lookup_index", None) is not None
        ):
            g = ~keep  # the accumulated base-row tombstone mask
            if (
                getattr(base, "_lookup_used", False)
                or getattr(self, "_lookup_used", False)
            ):
                # lookups are live on this store: advance eagerly so the
                # next one stays warm
                from ..engine.lookup import advance_lookup_index

                advance_lookup_index(
                    base._lookup_index, self,
                    num_slots=base.num_slots,
                    tupleset_slots=base.compiled.tupleset_slots,
                    ra_rel_src=base,
                    g_rel=base.e_rel[g], g_res=base.e_res[g],
                    g_subj=base.e_subj[g], g_srel1=base.e_srel1[g],
                    a_rel=ov["rel"], a_res=ov["res"],
                    a_subj=ov["subj"], a_srel1=ov["srel1"],
                )
            else:
                # index exists but nobody reads it (the prepare-time
                # prewarm): paying the O(E) advance on every Watch
                # revision costs ~4x the whole re-index step (measured,
                # bench5 r05: 17.9 -> 78ms overlay+probe).  Stash the
                # O(D) advance inputs instead — the FIRST real lookup
                # advances from the stash (engine/lookup.py
                # redeem_chain_stash) and flips the store onto the
                # eager path above
                from ..engine.lookup import _ra_rel_of

                _ra_rel_of(base, base._lookup_index)  # self-contain idx
                self.__dict__["_lookup_chain_stash"] = (
                    base._lookup_index,
                    base.e_rel[g], base.e_res[g],
                    base.e_subj[g], base.e_srel1[g],
                    ov["rel"], ov["res"], ov["subj"], ov["srel1"],
                )
        self.__dict__["_lsm_done"] = True
        # drop the chain state: a materialized snapshot otherwise pins
        # the whole previous base's columns (~2× E-row memory) forever
        self._lsm_base = self._lsm_ov = self._lsm_gone = None
        return renumbered


for _f in _LAZY_FIELDS:
    setattr(LsmSnapshot, _f, _lazycol(_f))


def apply_delta(
    prev: Snapshot,
    revision: int,
    adds: Sequence[Relationship],
    deletes: Sequence[Relationship],
    *,
    interner: Optional[Interner] = None,
    defer: Optional[bool] = None,
    compact_min: Optional[int] = None,
) -> Snapshot:
    """Next-revision Snapshot from the previous one plus a collapsed delta.

    ``adds`` are upserts (CREATE/TOUCH both replace any existing row with
    the same tuple key, matching the store's keyed ``_live`` dict);
    ``deletes`` are tuple keys to remove (extra keys not present are
    ignored, matching DELETE semantics).  A key must not appear in both —
    the store collapses the delta last-writer-wins before calling this.

    ``defer`` controls the host LSM: True returns an LsmSnapshot whose
    column merge is deferred to first access (O(D log E) now); False
    merges eagerly; None (default) defers unless the previous snapshot
    carries a live lookup index (advance_lookup_index needs merged-row
    positions) or the accumulated overlay would cross the compaction
    bound (then the merge is due anyway).

    ``compact_min`` overrides the module-level LSM_COMPACT_MIN floor —
    the store threads EngineConfig.lsm_compact_min through here so the
    tuner can trade probe depth against materialization frequency."""
    interner = interner if interner is not None else prev.interner
    compiled = prev.compiled
    contexts = list(prev.contexts)

    # the value→index dedup map is append-only between renumberings, so
    # chained deltas carry it forward instead of re-hashing every stored
    # context dict per revision
    ctx_index = getattr(prev, "_ctx_index", None)
    if ctx_index is None:
        ctx_index = {}
        for i, c in enumerate(contexts):
            ctx_index.setdefault(repr(sorted(c.items(), key=lambda kv: kv[0])), i)
    a_res, a_rel, a_subj, a_srel1, a_cav, a_ctx, a_exp_us = _lower_delta(
        compiled, interner, adds, contexts, ctx_index=ctx_index
    )
    d_contexts: List[Mapping[str, Any]] = []
    d_res, d_rel, d_subj, d_srel1, _, _, _ = _lower_delta(
        compiled, interner, deletes, d_contexts
    )
    a_exp32 = _exp_to_rel32(a_exp_us, prev.epoch_us)
    a_order = np.lexsort((a_srel1, a_subj, a_res, a_rel))

    # resolve the chain: an unmaterialized LsmSnapshot extends its own
    # base/overlay; anything else (plain or already-materialized) starts
    # a fresh chain with itself as base
    chained = isinstance(prev, LsmSnapshot) and not prev.__dict__.get(
        "_lsm_done"
    )
    base = prev._lsm_base if chained else prev
    ov0 = prev._lsm_ov if chained else {
        k: np.zeros(0, np.int64 if k in ("rel", "res", "subj", "srel1", "exp_us") else np.int32)
        for k in ("rel", "res", "subj", "srel1", "cav", "ctx", "exp", "exp_us")
    }
    gone0 = prev._lsm_gone if chained else np.zeros(0, np.int64)

    # locate this delta's identities in the base and in the overlay
    all_rel = np.concatenate([a_rel, d_rel])
    all_res = np.concatenate([a_res, d_res])
    all_subj = np.concatenate([a_subj, d_subj])
    all_srel1 = np.concatenate([a_srel1, d_srel1])
    base_hit = _locate(base, all_rel, all_res, all_subj, all_srel1)
    ov_hit = find_in_view(
        _pack_rr(ov0["rel"], ov0["res"]), _pack_ss(ov0["subj"], ov0["srel1"]),
        _pack_rr(all_rel, all_res), _pack_ss(all_subj, all_srel1),
    )

    # per-revision removal set (delta_info.g_*): identities live at prev —
    # a base row not already tombstoned, or an overlay row
    base_live = base_hit >= 0
    if gone0.size:
        pos = np.searchsorted(gone0, base_hit)
        already = (pos < gone0.shape[0]) & (
            gone0[np.clip(pos, 0, gone0.shape[0] - 1)] == base_hit
        )
        base_live &= ~already
    was_live = base_live | (ov_hit >= 0)
    g_rel = all_rel[was_live].astype(np.int32)
    g_res = all_res[was_live].astype(np.int32)
    g_subj = all_subj[was_live].astype(np.int32)
    g_srel1 = all_srel1[was_live].astype(np.int32)

    # new chain state: tombstones grow by the base hits; replaced/deleted
    # overlay rows drop; sorted adds merge in
    gone = np.union1d(gone0, base_hit[base_hit >= 0])
    ov_keep = np.ones(ov0["rel"].shape[0], dtype=bool)
    ov_keep[ov_hit[ov_hit >= 0]] = False
    new_cols = {
        "rel": a_rel[a_order], "res": a_res[a_order],
        "subj": a_subj[a_order], "srel1": a_srel1[a_order],
        "cav": a_cav[a_order], "ctx": a_ctx[a_order],
        "exp": a_exp32[a_order], "exp_us": a_exp_us[a_order],
    }
    pos_old, pos_new = merge_positions(
        _pack_rr(ov0["rel"], ov0["res"])[ov_keep],
        _pack_ss(ov0["subj"], ov0["srel1"])[ov_keep],
        _pack_rr(new_cols["rel"], new_cols["res"]),
        _pack_ss(new_cols["subj"], new_cols["srel1"]),
    )
    O0, A = int(ov_keep.sum()), new_cols["rel"].shape[0]
    ov = {}
    for k in ov0:
        out = np.empty(O0 + A, dtype=ov0[k].dtype)
        out[pos_old] = ov0[k][ov_keep]
        out[pos_new] = new_cols[k].astype(ov0[k].dtype)
        ov[k] = out

    cm = LSM_COMPACT_MIN if compact_min is None else int(compact_min)
    over_bound = ov["rel"].shape[0] + gone.shape[0] > max(
        cm, base.e_rel.shape[0] // 8
    )
    # contexts-list compaction check on an O(delta)-maintained UPPER bound
    # of live context uses (base count at chain start + overlay ctx rows;
    # tombstones only shrink the truth, so this over-estimates and
    # compacts no more often than the exact check would)
    base_nctx = (
        prev.__dict__.get("_lsm_base_nctx") if chained else None
    )
    if base_nctx is None:
        base_nctx = int(np.count_nonzero(base.e_ctx >= 0))
    nctx_ub = base_nctx + int(np.count_nonzero(ov["ctx"] >= 0))
    ctx_over = len(contexts) > CTX_COMPACT_MIN and (
        nctx_ub == 0 or len(contexts) > 2 * nctx_ub
    )
    if defer is None:
        # "_lookup_used" (set when a lookup actually consumes the index,
        # engine/lookup.py) — NOT mere index presence: the prepare-time
        # prewarm plants an index on every big snapshot, and keying on it
        # would push all Watch revisions onto the eager O(E) path
        defer = (
            not getattr(prev, "_lookup_used", False)
            and not over_bound
            and not ctx_over
        )

    num_nodes = max(len(interner), 1)
    node_type = np.concatenate([
        base.node_type, interner.node_type_tail(base.node_type.shape[0])
    ]) if num_nodes > base.node_type.shape[0] else base.node_type
    wc = np.full(max(interner.num_types, 1), -1, dtype=np.int32)
    from ..rel.relationship import WILDCARD_ID

    for tname in compiled.type_ids:
        n = interner.lookup(tname, WILDCARD_ID)
        if n >= 0:
            wc[interner.type_lookup(tname)] = n

    nxt = LsmSnapshot(
        base, revision, interner=interner, contexts=contexts, ov=ov,
        gone_base=gone, num_nodes=num_nodes, node_type=node_type, wc=wc,
    )
    nxt._lsm_base_nctx = base_nctx
    renumbered = False
    if not defer:
        renumbered = nxt._materialize(compact_ctx=ctx_over)
    if not renumbered:
        nxt._ctx_index = ctx_index  # still valid: indices were append-only
    nxt.delta_info = DeltaInfo(
        prev_revision=prev.revision,
        a_rel=a_rel.astype(np.int32), a_res=a_res.astype(np.int32),
        a_subj=a_subj.astype(np.int32), a_srel1=a_srel1.astype(np.int32),
        a_cav=a_cav, a_ctx=a_ctx, a_exp=a_exp32,
        g_rel=g_rel, g_res=g_res, g_subj=g_subj, g_srel1=g_srel1,
        contexts_renumbered=renumbered,
    )
    if (
        not defer
        and getattr(nxt, "_lookup_index", None) is None
        and getattr(prev, "_lookup_index", None) is not None
    ):
        # carry the lookup index forward: advance prev's by this
        # revision's removal identities + additions (O(E + D log E)
        # merges) instead of letting the next lookup pay a full
        # O(E log E) rebuild.  Removal is identity-based, so the chained
        # path works too: g_* is exactly the set of identities live at
        # prev that this revision removes or replaces (base rows not
        # already tombstoned, plus overlay rows).  A chained prev WITHOUT
        # an index leaves the work to lookup_index()'s chain-advance
        from ..engine.lookup import advance_lookup_index

        advance_lookup_index(
            prev._lookup_index, nxt,
            num_slots=prev.num_slots,
            tupleset_slots=prev.compiled.tupleset_slots,
            ra_rel_src=prev,
            g_rel=g_rel, g_res=g_res, g_subj=g_subj, g_srel1=g_srel1,
            a_rel=a_rel, a_res=a_res, a_subj=a_subj, a_srel1=a_srel1,
        )
    return nxt
