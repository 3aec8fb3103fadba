"""Columnar snapshot materialization.

A Snapshot is the device-facing form of the tuple graph at one revision:
lexicographically sorted int32 columns built once on the host, then shipped
to TPU.  Everything is int32 on purpose — TPU has no native int64, so keys
are kept as column tuples compared lexicographically (custom binary search /
multi-operand ``lax.sort``) instead of packed 64-bit scalars.  Expirations
are epoch-relative seconds clipped into int32 around a per-snapshot epoch.

Four views cover every access pattern the evaluator needs:

- **primary** (``e_*``): every live edge sorted by (rel, res, subj, srel) —
  O(log E) exact-match direct/wildcard leaf tests.
- **usersets** (``us_*``): edges with userset subjects sorted by (rel, res)
  — leaf tests gather the userset grants under (relation, resource).
- **membership** (``ms_*``/``mp_*``): the group-nesting subgraph — direct
  seeds by subject node, userset propagation edges by (subject, srel) — the
  Phase-A subject-closure BFS arrays.  Restricted to usersets that actually
  appear as tuple subjects, which keeps the closure the size of the *group*
  structure rather than the whole grant set.
- **arrows** (``ar_*``): edges of tupleset (arrow-LHS) relations by
  (rel, res) — the Phase-B resource-subgraph BFS.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from ..native.sort import argsort1, lexsort2, lexsort4
from ..rel.filter import Filter
from ..rel.relationship import Relationship, WILDCARD_ID, expiration_micros
from ..schema.compiler import CompiledSchema
from .interner import Interner

#: int32 sentinel used to pad sorted key columns past the end.
I32_MAX = np.int32(2**31 - 1)


def _exp_to_rel32(exp_us: np.ndarray, epoch_us: int) -> np.ndarray:
    """Expiry micros → epoch-relative seconds in int32 (ceiling, so an
    expiry never rounds earlier).  0 stays 0 ("no expiration"); an expiry
    that would land exactly on 0 (i.e. at/before the snapshot epoch) maps
    to -1 so it can't collide with the no-expiration sentinel; out-of-range
    futures clip to I32_MAX-1 (still in the future for any plausible query
    time)."""
    if not exp_us.any():
        # bulk imports rarely carry expirations: skip the int64 clip
        # chain for the all-zero column (identical output — zero maps
        # to the no-expiration sentinel 0 either way)
        return np.zeros(exp_us.shape[0], np.int32)
    rel = np.clip(
        -(-(exp_us - epoch_us) // 1_000_000),  # ceil division
        -(2**31) + 2,
        2**31 - 2,
    )
    rel = np.where(rel == 0, np.int64(-1), rel)
    return np.where(exp_us == 0, np.int64(0), rel).astype(np.int32)


@dataclass
class Snapshot:
    """Immutable columnar view of the graph at one revision."""

    revision: int
    compiled: CompiledSchema
    interner: Interner
    num_nodes: int
    num_slots: int
    epoch_us: int  # expiration reference epoch (snapshot build time)
    node_type: np.ndarray  # int32[num_nodes] INTERNER type ids
    wildcard_node_of_type: np.ndarray  # int32[interner num_types]; -1 = none

    # primary: all edges sorted lex by (rel, res, subj, srel1)
    e_rel: np.ndarray  # int32[E]
    e_res: np.ndarray  # int32[E]
    e_subj: np.ndarray  # int32[E]
    e_srel1: np.ndarray  # int32[E]  subject relation slot + 1; 0 = direct
    e_caveat: np.ndarray  # int32[E]  0 = none
    e_ctx: np.ndarray  # int32[E]  index into contexts, -1 = none
    e_exp: np.ndarray  # int32[E]  epoch-relative expiry seconds, 0 = none
    e_exp_us: np.ndarray  # int64[E] exact expiry micros (host-only; 0 = none)

    # userset edges sorted lex by (rel, res)
    us_rel: np.ndarray
    us_res: np.ndarray
    us_subj: np.ndarray
    us_srel: np.ndarray  # subject relation slot (>= 0)
    us_caveat: np.ndarray
    us_ctx: np.ndarray
    us_exp: np.ndarray
    #: 1 where the userset's relation is a *permission* on the subject's
    #: type (rel/relationship.go:35-37 makes these first-class): the device
    #: can't decide membership (it's the permission fixpoint), so such leaf
    #: grants hit only the possible plane → per-query host resolution
    us_perm: np.ndarray

    #: static possibly-userset pairs, sorted lex (node, rel): relation
    #: usersets whose membership may be extended through a permission-valued
    #: userset chain (transitive mp-closure of permission-srel edge targets);
    #: leaf probes treat containment as possible for every subject
    pus_n: np.ndarray
    pus_r: np.ndarray

    # membership seeds (direct edges into used usersets) sorted by ms_subj
    ms_subj: np.ndarray
    ms_res: np.ndarray
    ms_rel: np.ndarray
    ms_caveat: np.ndarray
    ms_ctx: np.ndarray
    ms_exp: np.ndarray

    # membership propagation (userset edges into used usersets) sorted lex
    # by (mp_subj, mp_srel)
    mp_subj: np.ndarray
    mp_srel: np.ndarray
    mp_res: np.ndarray
    mp_rel: np.ndarray
    mp_caveat: np.ndarray
    mp_ctx: np.ndarray
    mp_exp: np.ndarray

    # arrow (tupleset) edges sorted lex by (rel, res)
    ar_rel: np.ndarray
    ar_res: np.ndarray
    ar_child: np.ndarray  # int32 subject node
    ar_caveat: np.ndarray
    ar_ctx: np.ndarray
    ar_exp: np.ndarray

    contexts: List[Mapping[str, Any]] = field(default_factory=list)

    # ------------------------------------------------------------------
    @property
    def num_edges(self) -> int:
        return int(self.e_rel.shape[0])

    def now_rel32(self, now_us: Optional[int] = None) -> int:
        """Query time in the snapshot's epoch-relative seconds."""
        import time as _time

        if now_us is None:
            now_us = int(_time.time() * 1_000_000)
        return int(
            np.clip((now_us - self.epoch_us) // 1_000_000, -(2**31) + 2, 2**31 - 2)
        )

    # -- host-side reads ------------------------------------------------
    def decode_edge(self, i: int) -> Relationship:
        # one definition of field decoding: the batched path is it
        return next(self._decode_rows(np.asarray([i], np.int64)))

    def _slot_names(self) -> Dict[int, str]:
        return self.compiled.name_of_slot

    def _caveat_names(self) -> Dict[int, str]:
        if not hasattr(self, "_caveat_name_cache"):
            self._caveat_name_cache = {v: k for k, v in self.compiled.caveat_ids.items()}
        return self._caveat_name_cache

    def iter_relationships(
        self, f: Optional[Filter] = None, now_us: Optional[int] = None
    ) -> Iterator[Relationship]:
        """Filtered scan, vectorized on the interned columns; expired edges
        are excluded (they no longer grant, rel/relationship.go:43-45)."""
        if self.num_edges == 0:
            return
        mask = np.ones(self.num_edges, dtype=bool)
        if now_us is not None:
            mask &= (self.e_exp_us == 0) | (self.e_exp_us > now_us)
        if f is not None:
            if f.resource_type != "":
                # node_type holds INTERNER type ids, not schema type ids
                tid = self.interner.type_lookup(f.resource_type)
                if tid < 0:
                    return
                mask &= self.node_type[self.e_res] == tid
            if f.optional_resource_id != "":
                if f.resource_type == "":
                    return  # resource type is required by construction
                n = self.interner.lookup(f.resource_type, f.optional_resource_id)
                if n < 0:
                    return
                mask &= self.e_res == n
            if f.optional_relation != "":
                s = self.compiled.slot_of_name.get(f.optional_relation)
                if s is None:
                    return
                mask &= self.e_rel == s
            sf = f.optional_subject_filter
            if sf is not None:
                if sf.subject_type != "":
                    tid = self.interner.type_lookup(sf.subject_type)
                    if tid < 0:
                        return
                    mask &= self.node_type[self.e_subj] == tid
                if sf.optional_subject_id != "":
                    if sf.subject_type == "":
                        return
                    n = self.interner.lookup(sf.subject_type, sf.optional_subject_id)
                    if n < 0:
                        return
                    mask &= self.e_subj == n
                if sf.optional_relation is not None:
                    if sf.optional_relation == "":
                        mask &= self.e_srel1 == 0
                    else:
                        s = self.compiled.slot_of_name.get(sf.optional_relation)
                        if s is None:
                            return
                        mask &= self.e_srel1 == s + 1
        yield from self._decode_rows(np.nonzero(mask)[0])

    def decode_columns(
        self, rows: np.ndarray, chunk: int = 1 << 16
    ) -> Iterator[Dict[str, list]]:
        """Columnar row decoding: yields chunks of parallel string/value
        lists instead of Relationship objects — the native export path
        (the backup mirror of Store.import_columns).  Each chunk dict
        holds resource_types/resource_ids/resource_relations/
        subject_types/subject_ids/subject_relations (lists of str) plus
        caveat_names, caveat_contexts, expirations_us for rows that
        carry them.  ~4× faster than object decoding: no dataclass
        construction, one batched interner fetch per chunk."""
        slot_names = self._slot_names()
        caveat_names = self._caveat_names()
        contexts = self.contexts
        cols_of = getattr(self.interner, "keys_columns", None)
        at = 0
        while at < rows.shape[0]:
            blk = rows[at : at + chunk]
            at += chunk
            if cols_of is not None:
                rtypes, rids = cols_of(self.e_res[blk])
                stypes, sids = cols_of(self.e_subj[blk])
            else:
                rkeys = self.interner.keys_batch(self.e_res[blk])
                skeys = self.interner.keys_batch(self.e_subj[blk])
                rtypes, rids = map(list, zip(*rkeys)) if rkeys else ([], [])
                stypes, sids = map(list, zip(*skeys)) if skeys else ([], [])
            srel1 = self.e_srel1[blk].tolist()
            cav = self.e_caveat[blk].tolist()
            ctx_i = self.e_ctx[blk].tolist()
            yield {
                "resource_types": rtypes,
                "resource_ids": rids,
                "resource_relations": [
                    slot_names[s] for s in self.e_rel[blk].tolist()
                ],
                "subject_types": stypes,
                "subject_ids": sids,
                "subject_relations": [
                    slot_names[s - 1] if s > 0 else "" for s in srel1
                ],
                "caveat_names": [
                    caveat_names[c] if c else "" for c in cav
                ],
                "caveat_contexts": [
                    contexts[i] if c and i >= 0 else {}
                    for c, i in zip(cav, ctx_i)
                ],
                "expirations_us": self.e_exp_us[blk].tolist(),
            }

    def _decode_rows(self, rows: np.ndarray) -> Iterator[Relationship]:
        """Batched row decoding to Relationship objects, built ON TOP of
        decode_columns so there is ONE definition of field decoding (the
        columnar path).  Progressive chunks: an early-exiting consumer
        (first-match reads) pays a 256-row decode; full exports amortize
        at 64k.  Rows materialize through the bulk-decode fast
        constructor (rel/relationship.py decoded_relationship) with a
        C-speed zip over the column lists — the frozen-dataclass
        ``__init__`` was the export path's throughput ceiling."""
        from ..rel.relationship import decoded_relationship

        ch, at = 256, 0
        while at < rows.shape[0]:
            blk = rows[at : at + ch]
            at += ch
            ch = min(ch * 4, 1 << 16)
            for cols in self.decode_columns(blk, chunk=int(blk.shape[0])):
                # C-level map over the column lists: no per-row Python
                # loop frame (~1.3× over the explicit zip loop; the
                # remaining cost IS the object construction itself)
                exps = [
                    _dt.datetime.fromtimestamp(
                        e / 1_000_000, tz=_dt.timezone.utc
                    ) if e else None
                    for e in cols["expirations_us"]
                ]
                yield from map(
                    decoded_relationship,
                    cols["resource_types"], cols["resource_ids"],
                    cols["resource_relations"], cols["subject_types"],
                    cols["subject_ids"], cols["subject_relations"],
                    cols["caveat_names"], cols["caveat_contexts"], exps,
                )


def relationships_to_raw_columns(
    compiled: CompiledSchema,
    interner: Interner,
    relationships: Sequence[Relationship],
):
    """Intern live relationships into UNSORTED raw columns + contexts —
    the store-feed form ``build_snapshot`` sorts into a Snapshot and the
    feed-partition path (engine/partition.py partition_feed) buckets by
    shard ownership instead.  Row order is the input order, which is
    what makes both paths' stable sorts break ties identically."""
    E = len(relationships)
    res = np.empty(E, dtype=np.int64)
    rel_s = np.empty(E, dtype=np.int64)
    subj = np.empty(E, dtype=np.int64)
    srel = np.empty(E, dtype=np.int64)  # -1 = direct
    cav = np.zeros(E, dtype=np.int32)
    ctx = np.full(E, -1, dtype=np.int32)
    exp_us = np.zeros(E, dtype=np.int64)
    contexts: List[Mapping[str, Any]] = []

    slot_of = compiled.slot_of_name
    caveat_ids = compiled.caveat_ids
    for i, r in enumerate(relationships):
        res[i] = interner.node(r.resource_type, r.resource_id)
        rel_s[i] = slot_of[r.resource_relation]
        subj[i] = interner.node(r.subject_type, r.subject_id)
        srel[i] = slot_of[r.subject_relation] if r.subject_relation else -1
        if r.caveat_name:
            cav[i] = caveat_ids[r.caveat_name]
            if r.caveat_context:
                ctx[i] = len(contexts)
                contexts.append(r.caveat_context)
        exp_us[i] = expiration_micros(r.expiration) if r.has_expiration() else 0

    return (
        dict(res=res, rel=rel_s, subj=subj, srel=srel, caveat=cav,
             ctx=ctx, exp_us=exp_us),
        contexts,
    )


def build_snapshot(
    revision: int,
    compiled: CompiledSchema,
    interner: Interner,
    relationships: Sequence[Relationship],
    *,
    epoch_us: Optional[int] = None,
) -> Snapshot:
    """Materialize sorted columnar arrays from live relationships."""
    import time as _time

    if epoch_us is None:
        epoch_us = int(_time.time() * 1_000_000)
    raw, contexts = relationships_to_raw_columns(
        compiled, interner, relationships
    )
    return build_snapshot_from_columns(
        revision, compiled, interner,
        contexts=contexts, epoch_us=epoch_us, **raw,
    )


def build_snapshot_from_columns(
    revision: int,
    compiled: CompiledSchema,
    interner: Interner,
    *,
    res: np.ndarray,
    rel: np.ndarray,
    subj: np.ndarray,
    srel: np.ndarray,
    caveat: Optional[np.ndarray] = None,
    ctx: Optional[np.ndarray] = None,
    exp_us: Optional[np.ndarray] = None,
    contexts: Optional[List[Mapping[str, Any]]] = None,
    epoch_us: Optional[int] = None,
) -> Snapshot:
    """Materialize directly from pre-interned integer columns — the fast
    bulk path synthetic benchmarks use so 100M+-edge graphs never pass
    through per-tuple Python objects (SURVEY.md §7 "interning throughput
    at 1B edges is the real bottleneck")."""
    import time as _time

    if epoch_us is None:
        epoch_us = int(_time.time() * 1_000_000)
    E = res.shape[0]
    if caveat is None:
        caveat = np.zeros(E, dtype=np.int32)
    if ctx is None:
        ctx = np.full(E, -1, dtype=np.int32)
    if exp_us is None:
        exp_us = np.zeros(E, dtype=np.int64)
    contexts = contexts or []

    # node ids and slots are int32 by construction (interner/compiler):
    # keep every key column int32 end-to-end — the int64 round trips this
    # path used to make cost ~8 full passes over a 30M-edge import
    res = np.ascontiguousarray(res, np.int32)
    rel = np.ascontiguousarray(rel, np.int32)
    subj = np.ascontiguousarray(subj, np.int32)
    exp_us = np.ascontiguousarray(exp_us, np.int64)
    exp32 = _exp_to_rel32(exp_us, epoch_us)

    num_slots = max(compiled.num_slots, 1)
    if num_slots > 2**15:
        raise ValueError("schemas with >32768 relation/permission names unsupported")

    srel1 = np.ascontiguousarray(srel, np.int32) + 1

    # primary order (rel, res, subj, srel1) — native parallel sort when the
    # C++ ingest layer is available (the 100M-edge rebuild bottleneck);
    # permutation applies through the parallel native gathers
    from ..native.sort import take32, take64

    order = lexsort4(rel, res, subj, srel1)
    return finish_snapshot(
        revision, compiled, interner,
        e_rel=take32(rel, order),
        e_res=take32(res, order),
        e_subj=take32(subj, order),
        e_srel1=take32(srel1, order),
        e_caveat=take32(caveat, order),
        e_ctx=take32(ctx, order),
        e_exp=take32(exp32, order),
        e_exp_us=take64(exp_us, order),
        contexts=contexts,
        epoch_us=epoch_us,
    )


def finish_snapshot(
    revision: int,
    compiled: CompiledSchema,
    interner: Interner,
    *,
    e_rel: np.ndarray,
    e_res: np.ndarray,
    e_subj: np.ndarray,
    e_srel1: np.ndarray,
    e_caveat: np.ndarray,
    e_ctx: np.ndarray,
    e_exp: np.ndarray,
    e_exp_us: np.ndarray,
    contexts: List[Mapping[str, Any]],
    epoch_us: int,
) -> Snapshot:
    """Derive every secondary view from primary columns already sorted lex
    by (rel, res, subj, srel1).  Shared by the full build above and the
    incremental delta path (store/delta.py), so both produce identical
    snapshots by construction."""
    import time as _time

    from ..utils import faults, metrics

    # injection site: both the full build and the delta path funnel
    # through here, so one armed site covers every snapshot construction
    faults.fire("snapshot.finish")
    _t0 = _time.perf_counter()
    node_type = interner.node_type_array()
    num_nodes = max(len(interner), 1)
    num_slots = max(compiled.num_slots, 1)

    wc = np.full(max(interner.num_types, 1), -1, dtype=np.int32)
    for tname in compiled.type_ids:
        n = interner.lookup(tname, WILDCARD_ID)
        if n >= 0:
            wc[interner.type_lookup(tname)] = n

    e_cav = e_caveat
    rel_o = e_rel.astype(np.int64)
    res_o = e_res.astype(np.int64)
    subj_o = e_subj.astype(np.int64)
    srel_o = e_srel1.astype(np.int64) - 1

    # userset view (sorted by rel, res — inherited from the primary order)
    is_us = srel_o >= 0
    us_rel = e_rel[is_us]
    us_res = e_res[is_us]
    us_subj = e_subj[is_us]
    us_srel = srel_o[is_us].astype(np.int32)
    us_cav = e_cav[is_us]
    us_ctx = e_ctx[is_us]
    us_exp = e_exp[is_us]

    # usersets used as subjects anywhere (packed int64 keys, host-only)
    us_subj_key = subj_o[is_us] * num_slots + srel_o[is_us]
    used = np.unique(us_subj_key)
    edge_key = res_o * num_slots + rel_o  # the userset each edge grants
    # membership of edge_key in the sorted-unique ``used`` via binary
    # search: np.isin sorts the 30M-row edge_key column, this is
    # O(E log U) with no big sort (identical boolean output)
    if used.shape[0]:
        pos = np.clip(
            np.searchsorted(used, edge_key), 0, used.shape[0] - 1
        )
        feeds = used[pos] == edge_key
    else:
        feeds = np.zeros(edge_key.shape[0], bool)
    used_keys = used  # persisted below: the delta-prepare bail test

    from ..native.sort import take32

    # seeds: direct edges into used usersets, by subject node
    seed_mask = feeds & (srel_o < 0)
    seed_sort = argsort1(e_subj[seed_mask])
    ms_subj = take32(e_subj[seed_mask], seed_sort)
    ms_res = take32(e_res[seed_mask], seed_sort)
    ms_rel = take32(e_rel[seed_mask], seed_sort)
    ms_cav = take32(e_cav[seed_mask], seed_sort)
    ms_ctx = take32(e_ctx[seed_mask], seed_sort)
    ms_exp = take32(e_exp[seed_mask], seed_sort)

    # propagation: userset edges into used usersets, by (subj, srel)
    prop_mask = feeds & (srel_o >= 0)
    prop_srel = e_srel1[prop_mask] - 1
    prop_sort = lexsort2(e_subj[prop_mask], prop_srel)
    mp_subj = take32(e_subj[prop_mask], prop_sort)
    mp_srel = take32(prop_srel, prop_sort)
    mp_res = take32(e_res[prop_mask], prop_sort)
    mp_rel = take32(e_rel[prop_mask], prop_sort)
    mp_cav = take32(e_cav[prop_mask], prop_sort)
    mp_ctx = take32(e_ctx[prop_mask], prop_sort)
    mp_exp = take32(e_exp[prop_mask], prop_sort)

    # permission-valued userset machinery: per-(interner type, slot) "is a
    # permission" table → us_perm leaf flags + the transitive possibly-
    # userset pair set (see Snapshot.us_perm / pus_n docs)
    perm_table = np.zeros((max(interner.num_types, 1), num_slots), bool)
    for tname2, d2 in compiled.schema.definitions.items():
        itid = interner.type_lookup(tname2)
        if itid < 0:
            continue
        for pname2 in d2.permissions:
            perm_table[itid, compiled.slot_of_name[pname2]] = True
    if us_subj.shape[0]:
        us_perm = perm_table[
            node_type[us_subj], np.clip(us_srel, 0, num_slots - 1)
        ].astype(np.int32)
    else:
        us_perm = np.zeros(0, np.int32)

    pus_n = np.zeros(0, np.int32)
    pus_r = np.zeros(0, np.int32)
    if mp_subj.shape[0] and compiled.has_permission_usersets:
        mp_is_perm = perm_table[
            node_type[mp_subj], np.clip(mp_srel, 0, num_slots - 1)
        ]
        seeds = np.unique(
            mp_res[mp_is_perm].astype(np.int64) * num_slots + mp_rel[mp_is_perm]
        )
        mp_key = mp_subj.astype(np.int64) * num_slots + mp_srel.astype(np.int64)
        visited = seeds
        frontier = seeds
        while frontier.size:
            lo = np.searchsorted(mp_key, frontier, "left")
            hi = np.searchsorted(mp_key, frontier, "right")
            counts = (hi - lo).astype(np.int64)
            total = int(counts.sum())
            if total == 0:
                break
            starts = np.repeat(lo.astype(np.int64), counts)
            ends = np.cumsum(counts)
            ii = starts + (np.arange(total) - np.repeat(ends - counts, counts))
            nxt = np.unique(
                mp_res[ii].astype(np.int64) * num_slots + mp_rel[ii]
            )
            frontier = nxt[~np.isin(nxt, visited)]
            visited = np.union1d(visited, frontier)
        if visited.size:
            pus_n = (visited // num_slots).astype(np.int32)
            pus_r = (visited % num_slots).astype(np.int32)

    # arrow view: tupleset relations, direct subjects only (SpiceDB arrows
    # traverse ellipsis subjects)
    ts_slots = np.asarray(sorted(compiled.tupleset_slots), dtype=np.int64)
    ar_mask = np.isin(rel_o, ts_slots) & (srel_o < 0)
    ar_rel = e_rel[ar_mask]
    ar_res = e_res[ar_mask]
    ar_child = e_subj[ar_mask]
    ar_cav = e_cav[ar_mask]
    ar_ctx = e_ctx[ar_mask]
    ar_exp = e_exp[ar_mask]

    snap = Snapshot(
        revision=revision,
        compiled=compiled,
        interner=interner,
        num_nodes=num_nodes,
        num_slots=num_slots,
        epoch_us=epoch_us,
        node_type=node_type,
        wildcard_node_of_type=wc,
        e_rel=e_rel, e_res=e_res, e_subj=e_subj, e_srel1=e_srel1,
        e_caveat=e_cav, e_ctx=e_ctx, e_exp=e_exp, e_exp_us=e_exp_us,
        us_rel=us_rel, us_res=us_res, us_subj=us_subj, us_srel=us_srel,
        us_caveat=us_cav, us_ctx=us_ctx, us_exp=us_exp, us_perm=us_perm,
        pus_n=pus_n, pus_r=pus_r,
        ms_subj=ms_subj, ms_res=ms_res, ms_rel=ms_rel,
        ms_caveat=ms_cav, ms_ctx=ms_ctx, ms_exp=ms_exp,
        mp_subj=mp_subj, mp_srel=mp_srel, mp_res=mp_res, mp_rel=mp_rel,
        mp_caveat=mp_cav, mp_ctx=mp_ctx, mp_exp=mp_exp,
        ar_rel=ar_rel, ar_res=ar_res, ar_child=ar_child,
        ar_caveat=ar_cav, ar_ctx=ar_ctx, ar_exp=ar_exp,
        contexts=contexts,
    )
    # packed (subj · num_slots + srel) int64 keys of usersets that appear
    # as tuple subjects: the device delta-prepare (engine/flat.py
    # build_delta_arrays) bails to a full rebuild when a delta row touches
    # the membership subgraph, which it detects against this set
    snap.us_used_keys = used_keys
    metrics.default.observe(
        "prepare.snapshot_s", _time.perf_counter() - _t0
    )
    return snap


def partitioned_snapshot(
    mem_snap: Snapshot,
    *,
    e_cols: Mapping[str, np.ndarray],
    us_rows: np.ndarray,
    ar_cols: Mapping[str, np.ndarray],
    owned,
) -> Snapshot:
    """Bucket-filtered Snapshot: the process-local view of one feed
    partition (engine/partition.py partition_feed).

    The big per-edge views hold ONLY shard-owned rows — primary rows by
    their (k1, k2) bucket, userset/arrow rows by their (rel, res) group
    bucket — each in global sort order restricted to the owned set
    (equal keys co-locate per shard, so local stable sorts reproduce the
    global tie-breaks).  The membership subgraph (``ms_*``/``mp_*``),
    the used-userset key set, ``pus_*``, node types, and contexts come
    whole from ``mem_snap`` (the replicated membership snapshot): the
    flattened closure must be derivable on every process.  NOT a full
    snapshot: host-oracle fallbacks and exports over it see only the
    local partition — the sharded dispatch path never consults those
    for in-cap queries."""
    from .columns import filter_columns

    us = filter_columns(
        {
            "rel": mem_snap.us_rel, "res": mem_snap.us_res,
            "subj": mem_snap.us_subj, "srel": mem_snap.us_srel,
            "caveat": mem_snap.us_caveat, "ctx": mem_snap.us_ctx,
            "exp": mem_snap.us_exp, "perm": mem_snap.us_perm,
        },
        us_rows,
    )
    snap = Snapshot(
        revision=mem_snap.revision,
        compiled=mem_snap.compiled,
        interner=mem_snap.interner,
        num_nodes=mem_snap.num_nodes,
        num_slots=mem_snap.num_slots,
        epoch_us=mem_snap.epoch_us,
        node_type=mem_snap.node_type,
        wildcard_node_of_type=mem_snap.wildcard_node_of_type,
        e_rel=e_cols["rel"], e_res=e_cols["res"], e_subj=e_cols["subj"],
        e_srel1=e_cols["srel1"], e_caveat=e_cols["caveat"],
        e_ctx=e_cols["ctx"], e_exp=e_cols["exp"],
        e_exp_us=e_cols["exp_us"],
        us_rel=us["rel"], us_res=us["res"], us_subj=us["subj"],
        us_srel=us["srel"], us_caveat=us["caveat"], us_ctx=us["ctx"],
        us_exp=us["exp"], us_perm=us["perm"],
        pus_n=mem_snap.pus_n, pus_r=mem_snap.pus_r,
        ms_subj=mem_snap.ms_subj, ms_res=mem_snap.ms_res,
        ms_rel=mem_snap.ms_rel, ms_caveat=mem_snap.ms_caveat,
        ms_ctx=mem_snap.ms_ctx, ms_exp=mem_snap.ms_exp,
        mp_subj=mem_snap.mp_subj, mp_srel=mem_snap.mp_srel,
        mp_res=mem_snap.mp_res, mp_rel=mem_snap.mp_rel,
        mp_caveat=mem_snap.mp_caveat, mp_ctx=mem_snap.mp_ctx,
        mp_exp=mem_snap.mp_exp,
        ar_rel=ar_cols["rel"], ar_res=ar_cols["res"],
        ar_child=ar_cols["child"], ar_caveat=ar_cols["caveat"],
        ar_ctx=ar_cols["ctx"], ar_exp=ar_cols["exp"],
        contexts=mem_snap.contexts,
    )
    snap.us_used_keys = mem_snap.us_used_keys
    snap.partition_owned = tuple(owned)  # marker: bucket-filtered view
    return snap
