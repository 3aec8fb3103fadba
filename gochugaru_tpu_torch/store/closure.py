"""Precomputed membership closure: the Leopard-style flattened index.

SpiceDB's dispatch cluster re-walks group nesting on every check; Zanzibar's
Leopard index instead flattens the member→group transitive closure offline so
a check becomes one set-membership probe (BASELINE.md config 5 names it).
That is the TPU-shaped move: closure computation happens ONCE per snapshot
revision on the host (vectorized numpy sort-merge joins over the snapshot's
membership columns, native parallel sorts), and the per-check device work
collapses to O(1) hash probes into the flattened table — no per-query
frontier walk, no device-side sort/dedup (the round-2 hot-path bottleneck,
engine/device.py Phase A).

Two planes, one max-min expiry semiring each (SURVEY.md §2.6 expiration +
three-valued permissionship):

- ``definite``: paths made only of caveat-free edges.  The stored value is
  ``max over paths of (min over path edges of expiry)`` — an edge with no
  expiration contributes +inf (stored ``NO_EXP``).  At query time the pair
  grants definitely iff ``value > now``.
- ``possible``: paths through any edge (caveated edges admitted — the host
  oracle resolves the caveat per query with real context).  Same semiring,
  so expiry alone never sends a check to the host: the max-min value
  answers "is some path fully live at ``now``" exactly.

A source whose closure exceeds ``per_source_cap`` — or that is still
unconverged when ``max_hops`` runs out — is dropped from the table and
recorded in the overflow set; queries whose subject hits the overflow set
are re-checked on the host oracle (caps bound memory, never correctness —
the same contract as engine/plan.py's EngineConfig).

Replaces (the membership half of) the reference's server-side graph walk
behind CheckBulkPermissions (client/client.go:238-266).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

from ..utils import metrics

if TYPE_CHECKING:  # pragma: no cover
    from .snapshot import Snapshot

#: semiring +inf: "no expiration along the best path"
NO_EXP = np.int32(2**31 - 1)
#: semiring -inf: "no admissible path on this plane"
NEVER = np.int32(-(2**31))


@dataclass
class ClosureIndex:
    """Flattened membership closure at one revision.

    Rows are sorted lexicographically by (src, srel1, g, grel) where
    ``src``/``srel1`` identify the member (``srel1 == 0`` → a direct object
    subject, e.g. a user node; ``srel1 == r+1`` → the userset ``src#r``)
    and (``g``, ``grel``) is a userset the member transitively belongs to.
    Reflexive pairs (``X#r ∈ X#r``) are NOT stored — probes test identity
    directly.  ``d_until``/``p_until`` are the per-plane semiring values.
    """

    revision: int
    c_src: np.ndarray  # int32[P]
    c_srel1: np.ndarray  # int32[P]
    c_g: np.ndarray  # int32[P]
    c_grel: np.ndarray  # int32[P]
    c_d_until: np.ndarray  # int32[P]  NEVER = not definite via any path
    c_p_until: np.ndarray  # int32[P]
    # sources whose closure overflowed per_source_cap, sorted lex
    ovf_src: np.ndarray  # int32[O]
    ovf_srel1: np.ndarray  # int32[O]

    @property
    def num_pairs(self) -> int:
        return int(self.c_src.shape[0])


def _in_sorted(sorted_arr: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Membership of x in a sorted unique array, via binary search."""
    if sorted_arr.size == 0 or x.size == 0:
        return np.zeros(x.shape[0], bool)
    pos = np.clip(np.searchsorted(sorted_arr, x), 0, sorted_arr.shape[0] - 1)
    return sorted_arr[pos] == x


class _Builder:
    """Mutable state of one build_closure run."""

    def __init__(self, S1: np.int64, per_source_cap: int) -> None:
        self.S1 = S1
        self.cap = per_source_cap
        self.ovf = np.zeros(0, np.int64)  # sorted unique overflowed src keys

    def add_overflow(self, keys: np.ndarray) -> None:
        if keys.size:
            self.ovf = np.union1d(self.ovf, keys)

    def group_max(self, src, dst, d, p):
        """Combine duplicate (src, dst) rows, per-plane max; lexsorted out.
        Sorts via the native parallel radix directly on the packed
        non-negative int64 keys (order-equivalent to the unpacked column
        lexsort — the packing is monotone), applied with parallel
        gathers; numpy lexsort is tens of seconds at 100M rows."""
        if src.size == 0:
            return src, dst, d, p
        from ..native.sort import sortperm_words, take32, take64

        order = sortperm_words([src, dst], (dst, src))
        src, dst = take64(src, order), take64(dst, order)
        d, p = take32(d, order), take32(p, order)
        first = np.ones(src.shape[0], bool)
        first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        starts = np.nonzero(first)[0]
        return (
            src[first],
            dst[first],
            np.maximum.reduceat(d, starts),
            np.maximum.reduceat(p, starts),
        )

    def drop_oversized(self, src, dst, d, p):
        """Enforce per_source_cap; src must be sorted (post group_max)."""
        if src.size == 0:
            return src, dst, d, p
        uniq, counts = np.unique(src, return_counts=True)
        self.add_overflow(uniq[counts > self.cap])
        return self.drop_overflowed(src, dst, d, p)

    def drop_overflowed(self, src, dst, d, p):
        if self.ovf.size == 0 or src.size == 0:
            return src, dst, d, p
        keep = ~_in_sorted(self.ovf, src)
        return src[keep], dst[keep], d[keep], p[keep]


def _pair_ids(
    src_a: np.ndarray, dst_a: np.ndarray, src_b: np.ndarray, dst_b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense int64 ids for (src, dst) pairs, consistent across both inputs
    and monotone w.r.t. (src, dst) lexicographic order (so a lexsorted
    table yields sorted ids, and np.searchsorted applies)."""
    ns, nb = src_a.shape[0], src_b.shape[0]
    _, inv_s = np.unique(np.concatenate([src_a, src_b]), return_inverse=True)
    ud, inv_d = np.unique(np.concatenate([dst_a, dst_b]), return_inverse=True)
    ids = inv_s.astype(np.int64) * np.int64(max(ud.shape[0], 1)) + inv_d
    return ids[:ns], ids[ns : ns + nb]


def _edge_values(cav: np.ndarray, exp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge semiring weights: expiry 0 → +inf; caveated edges are
    NEVER on the definite plane (resolving them needs per-query context).
    Pure int32 (both sentinels fit): no int64 round trip."""
    w = np.where(exp == 0, NO_EXP, exp).astype(np.int32)
    return np.where(cav == 0, w, NEVER), w


def _expand_join(
    keys_sorted: np.ndarray, probe: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs sort-merge join: for each probe[i], the row indices of
    every match in keys_sorted.  Returns (probe_row, match_row) flattened."""
    lo = np.searchsorted(keys_sorted, probe, "left")
    hi = np.searchsorted(keys_sorted, probe, "right")
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    reps = np.repeat(np.arange(probe.shape[0], dtype=np.int64), counts)
    ends = np.cumsum(counts)
    ii = np.repeat(lo.astype(np.int64), counts) + (
        np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)
    )
    return reps, ii


def build_closure(
    snap: "Snapshot",
    *,
    per_source_cap: int = 4096,
    global_cap: int = 200_000_000,
    max_hops: int = 10_000,
) -> ClosureIndex:
    """Flatten the snapshot's membership graph (ms_/mp_ views) into a
    ClosureIndex via a semi-naive fixpoint of vectorized joins."""
    metrics.default.inc("closure.rebuilds")
    from ..utils import trace as _trace

    _trace.event_if_active("closure.rebuild", revision=int(snap.revision))
    S1 = np.int64(snap.num_slots + 1)  # srel1 radix
    b = _Builder(S1, per_source_cap)

    def src_key(node: np.ndarray, srel1) -> np.ndarray:
        return node.astype(np.int64) * S1 + srel1

    # -- pair-level closure over userset-propagation edges ----------------
    # direct pair edges: (mp_subj # mp_srel)  →  (mp_res # mp_rel)
    e_src = src_key(snap.mp_subj, snap.mp_srel.astype(np.int64) + 1)
    e_dst = src_key(snap.mp_res, snap.mp_rel.astype(np.int64) + 1)
    e_d, e_p = _edge_values(snap.mp_caveat, snap.mp_exp)
    # self-loop edges (a#m @ a#m) add nothing to any path: drop them so the
    # no-reflexive-rows invariant holds from the initial table on
    loop = e_src == e_dst
    if loop.any():
        e_src, e_dst, e_d, e_p = e_src[~loop], e_dst[~loop], e_d[~loop], e_p[~loop]
    e_order = np.argsort(e_src, kind="stable")
    e_src, e_dst = e_src[e_order], e_dst[e_order]
    e_d, e_p = e_d[e_order], e_p[e_order]

    c_src, c_dst, c_d, c_p = b.group_max(e_src, e_dst, e_d, e_p)
    c_src, c_dst, c_d, c_p = b.drop_oversized(c_src, c_dst, c_d, c_p)
    n_src, n_dst, n_d, n_p = c_src, c_dst, c_d, c_p  # frontier

    for _ in range(max_hops):
        if n_src.size == 0:
            break
        reps, ii = _expand_join(e_src, n_dst)
        if reps.size == 0:
            n_src = n_src[:0]
            break
        j_src = n_src[reps]
        j_dst = e_dst[ii]
        j_d = np.minimum(n_d[reps], e_d[ii])
        j_p = np.minimum(n_p[reps], e_p[ii])
        keep = j_src != j_dst  # reflexivity is the probe's job
        j_src, j_dst, j_d, j_p = j_src[keep], j_dst[keep], j_d[keep], j_p[keep]
        j_src, j_dst, j_d, j_p = b.group_max(j_src, j_dst, j_d, j_p)
        # an overflowed source stays overflowed: no partial creep-back
        j_src, j_dst, j_d, j_p = b.drop_overflowed(j_src, j_dst, j_d, j_p)
        if j_src.size == 0:
            n_src = j_src
            break

        # improvement test against the current table
        c_ids, j_ids = _pair_ids(c_src, c_dst, j_src, j_dst)
        pos = np.searchsorted(c_ids, j_ids)
        posc = np.clip(pos, 0, max(c_ids.shape[0] - 1, 0))
        found = (c_ids.shape[0] > 0) & (c_ids[posc] == j_ids)
        old_d = np.where(found, c_d[posc], NEVER)
        old_p = np.where(found, c_p[posc], NEVER)
        improved = (j_d > old_d) | (j_p > old_p)
        j_src, j_dst = j_src[improved], j_dst[improved]
        j_d, j_p = j_d[improved], j_p[improved]
        if j_src.size == 0:
            n_src = j_src
            break

        c_src, c_dst, c_d, c_p = b.group_max(
            np.concatenate([c_src, j_src]),
            np.concatenate([c_dst, j_dst]),
            np.concatenate([c_d, j_d]),
            np.concatenate([c_p, j_p]),
        )
        c_src, c_dst, c_d, c_p = b.drop_oversized(c_src, c_dst, c_d, c_p)
        if c_src.size > global_cap:
            raise MemoryError(
                f"membership closure exceeded global cap ({c_src.size} pairs)"
            )
        n_src, n_dst, n_d, n_p = b.drop_overflowed(j_src, j_dst, j_d, j_p)
    if n_src.size:
        # hop budget exhausted before convergence: the unconverged sources'
        # rows may be incomplete — overflow them so queries fall back to the
        # host oracle instead of silently missing memberships
        b.add_overflow(np.unique(n_src))

    # -- user-level closure: direct seeds ∪ (seeds ⋈ pair closure) --------
    s_src = src_key(snap.ms_subj, 0)  # direct-object members, srel1 = 0
    s_dst = src_key(snap.ms_res, snap.ms_rel.astype(np.int64) + 1)
    s_d, s_p = _edge_values(snap.ms_caveat, snap.ms_exp)

    reps, ii = _expand_join(c_src, s_dst)
    if reps.size:
        u_src = np.concatenate([s_src, s_src[reps]])
        u_dst = np.concatenate([s_dst, c_dst[ii]])
        u_d = np.concatenate([s_d, np.minimum(s_d[reps], c_d[ii])])
        u_p = np.concatenate([s_p, np.minimum(s_p[reps], c_p[ii])])
    else:
        u_src, u_dst, u_d, u_p = s_src, s_dst, s_d, s_p
    # a user whose seed points at an overflowed pair overflows too: the
    # pair's (dropped) closure would have been part of the user's closure
    if b.ovf.size:
        b.add_overflow(np.unique(s_src[_in_sorted(b.ovf, s_dst)]))
    u_src, u_dst, u_d, u_p = b.group_max(u_src, u_dst, u_d, u_p)
    u_src, u_dst, u_d, u_p = b.drop_oversized(u_src, u_dst, u_d, u_p)

    # -- assemble (final sweep drops any row of an overflowed source) -----
    a_src = np.concatenate([u_src, c_src])
    a_dst = np.concatenate([u_dst, c_dst])
    a_d = np.concatenate([u_d, c_d]).astype(np.int32)
    a_p = np.concatenate([u_p, c_p]).astype(np.int32)
    a_src, a_dst, a_d, a_p = b.drop_overflowed(a_src, a_dst, a_d, a_p)
    from ..native.sort import sortperm_words, take32, take64

    order = sortperm_words([a_src, a_dst], (a_dst, a_src))
    a_src, a_dst = take64(a_src, order), take64(a_dst, order)
    a_d, a_p = take32(a_d, order), take32(a_p, order)

    return ClosureIndex(
        revision=snap.revision,
        c_src=(a_src // S1).astype(np.int32),
        c_srel1=(a_src % S1).astype(np.int32),
        c_g=(a_dst // S1).astype(np.int32),
        c_grel=(a_dst % S1 - 1).astype(np.int32),
        c_d_until=a_d,
        c_p_until=a_p,
        ovf_src=(b.ovf // S1).astype(np.int32),
        ovf_srel1=(b.ovf % S1).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# incremental maintenance: O(Δ·depth) closure advance along a Watch chain
# ---------------------------------------------------------------------------
#
# A membership-edge delta (rows of the ms/mp subgraph) used to force a full
# rebuild of the flattened closure — the top bail class of the device's
# incremental prepare (ROADMAP "Incremental closure maintenance").  The
# machinery below advances the index instead:
#
# 1. **Affected-set discovery** (reverse reachability): a source's closure
#    can only change if it reaches the tail of a touched edge, so walk the
#    membership graph BACKWARDS from the touched edge sources over the
#    union of old and new edges — O(Δ·depth) frontier work, capped.
# 2. **Subset recompute**: rerun build_closure's exact fixpoint restricted
#    to the affected sources over the full new edge set — the same
#    group_max/cap/overflow machinery, so the recomputed rows are the rows
#    a full rebuild would produce (deletions need no derivation counting:
#    affected sources are recomputed wholesale).
# 3. **Merge**: drop the affected sources' old rows, interleave the
#    recomputed rows into the lex-sorted arrays (O(P + Δ') searchsorted
#    merge, no global re-sort) — bitwise-identical to a from-scratch
#    build_closure by construction (the final table is a pure function of
#    the deduped pair→value map and the overflow set, both reproduced
#    exactly; tests/test_closure.py asserts array equality).
#
# Any condition the subset recompute cannot keep sound or cheap —
# affected set past the cap, unconverged fixpoint, global-cap overflow —
# returns None and the caller falls back to build_closure (counted by the
# ``closure.rebuilds`` / ``closure.delta_applies`` metrics pair).


@dataclass
class ClosureState:
    """Host-side state for advancing a ClosureIndex by membership deltas.

    Everything is packed int64 keys (``node·S1 + srel1`` sources,
    ``node·S1 + rel + 1`` targets, S1 = num_slots + 1 — the same radix
    build_closure uses internally).  Edge identities are unique (they
    mirror primary-row identities), so removal is exact.  Instances are
    immutable in practice: ``advance_closure`` returns a new state and
    never mutates its input, which makes a retried advance (fault
    injection, utils/faults.py ``closure.delta``) idempotent."""

    S1: np.int64
    per_source_cap: int
    revision: int
    cl: ClosureIndex
    a_src: np.ndarray  # int64[P] packed src per closure row (lex order)
    a_dst: np.ndarray  # int64[P] packed dst per closure row
    ovf: np.ndarray  # int64[O] sorted packed overflowed sources
    # membership edge sets at this revision, sorted by (src, dst):
    e_src: np.ndarray  # pair (mp) edges; self-loops dropped
    e_dst: np.ndarray
    e_d: np.ndarray  # int32 per-plane edge weights (_edge_values)
    e_p: np.ndarray
    s_src: np.ndarray  # seed (ms) edges
    s_dst: np.ndarray
    s_d: np.ndarray
    s_p: np.ndarray
    # reverse views sorted by (dst, src): affected-set discovery
    er_dst: np.ndarray
    er_src: np.ndarray
    sr_dst: np.ndarray
    sr_src: np.ndarray


@dataclass
class AdvanceResult:
    """Outcome of one successful advance_closure call."""

    state: ClosureState
    #: sorted unique packed dst keys whose member set (or a member's
    #: admissibility value) changed — exactly the groups whose baked
    #: T-index rows are stale (engine/flat.py turns these into dirty keys)
    changed_dsts: np.ndarray
    #: the affected source sets (diagnostics + wildcard checks upstream)
    affected_pairs: np.ndarray
    affected_users: np.ndarray


def _sort_pairs(S1: np.int64, k1, k2, *vals):
    if k1.shape[0] == 0:
        return (k1, k2) + tuple(vals)
    from ..native.sort import sortperm_words, take64

    order = sortperm_words([k1, k2], (k2, k1))
    return (take64(k1, order), take64(k2, order)) + tuple(
        v[order] for v in vals
    )


def build_closure_state(snap: "Snapshot", cl: ClosureIndex,
                        *, per_source_cap: int = 4096) -> ClosureState:
    """The advance-ready form of a freshly built closure (full prepare)."""
    S1 = np.int64(snap.num_slots + 1)
    e_src = snap.mp_subj.astype(np.int64) * S1 + snap.mp_srel.astype(np.int64) + 1
    e_dst = snap.mp_res.astype(np.int64) * S1 + snap.mp_rel.astype(np.int64) + 1
    e_d, e_p = _edge_values(snap.mp_caveat, snap.mp_exp)
    keep = e_src != e_dst  # build_closure drops self-loop pair edges
    e_src, e_dst, e_d, e_p = e_src[keep], e_dst[keep], e_d[keep], e_p[keep]
    e_src, e_dst, e_d, e_p = _sort_pairs(S1, e_src, e_dst, e_d, e_p)
    er_dst, er_src = _sort_pairs(S1, e_dst, e_src)

    s_src = snap.ms_subj.astype(np.int64) * S1
    s_dst = snap.ms_res.astype(np.int64) * S1 + snap.ms_rel.astype(np.int64) + 1
    s_d, s_p = _edge_values(snap.ms_caveat, snap.ms_exp)
    s_src, s_dst, s_d, s_p = _sort_pairs(S1, s_src, s_dst, s_d, s_p)
    sr_dst, sr_src = _sort_pairs(S1, s_dst, s_src)

    return ClosureState(
        S1=S1, per_source_cap=per_source_cap, revision=snap.revision, cl=cl,
        a_src=cl.c_src.astype(np.int64) * S1 + cl.c_srel1,
        a_dst=cl.c_g.astype(np.int64) * S1 + cl.c_grel + 1,
        ovf=cl.ovf_src.astype(np.int64) * S1 + cl.ovf_srel1,
        e_src=e_src, e_dst=e_dst, e_d=e_d, e_p=e_p,
        s_src=s_src, s_dst=s_dst, s_d=s_d, s_p=s_p,
        er_dst=er_dst, er_src=er_src, sr_dst=sr_dst, sr_src=sr_src,
    )


def _apply_edge_delta(S1, k1, k2, vals, del1, del2, add1, add2, addvals):
    """Remove identities (del1, del2) from a (k1, k2)-lexsorted edge set
    and merge the (sorted) additions; returns the new sorted columns.
    Fully vectorized: pair-id membership for the removal (identities are
    unique) and ONE native lexsort for the merge — the per-run binary
    search loops of the generic store merge cost more than this whole
    advance at typical delta sizes."""
    if del1.shape[0]:
        e_ids, d_ids = _pair_ids(k1, k2, del1, del2)
        keep = ~_in_sorted(np.sort(d_ids), e_ids)
        k1k, k2k = k1[keep], k2[keep]
        valsk = [v[keep] for v in vals]
    else:
        k1k, k2k = k1, k2
        valsk = list(vals)
    if add1.shape[0] == 0:
        return (k1k, k2k) + tuple(valsk)
    return _sort_pairs(
        S1,
        np.concatenate([k1k, add1]),
        np.concatenate([k2k, add2]),
        *(
            np.concatenate([o, a.astype(o.dtype)])
            for o, a in zip(valsk, addvals)
        ),
    )


def advance_closure(
    st: ClosureState,
    revision: int,
    *,
    pair_add=None,  # (src, dst, cav, exp) int64/int32 columns
    pair_del=None,  # (src, dst)
    seed_add=None,
    seed_del=None,
    affected_cap: int = 65_536,
    global_cap: int = 200_000_000,
    max_hops: int = 10_000,
) -> Optional[AdvanceResult]:
    """Advance the closure by one revision's membership-edge delta, or
    None when the subset recompute cannot stay sound/cheap (the caller
    then rebuilds).  Pure: ``st`` is never mutated."""
    from ..utils import faults

    faults.fire("closure.delta")
    S1 = st.S1
    z64 = np.zeros(0, np.int64)

    def unpack4(t):
        if t is None:
            return z64, z64, np.zeros(0, np.int32), np.zeros(0, np.int32)
        src, dst, cav, exp = (np.asarray(x) for x in t)
        d, p = _edge_values(np.asarray(cav, np.int32), np.asarray(exp, np.int32))
        return src.astype(np.int64), dst.astype(np.int64), d, p

    def unpack2(t):
        if t is None:
            return z64, z64
        return np.asarray(t[0], np.int64), np.asarray(t[1], np.int64)

    pa_src, pa_dst, pa_d, pa_p = unpack4(pair_add)
    pd_src, pd_dst = unpack2(pair_del)
    sa_src, sa_dst, sa_d, sa_p = unpack4(seed_add)
    sd_src, sd_dst = unpack2(seed_del)
    # self-loop pair edges never enter the edge set: drop from both sides
    if pa_src.shape[0]:
        keep = pa_src != pa_dst
        pa_src, pa_dst, pa_d, pa_p = (
            pa_src[keep], pa_dst[keep], pa_d[keep], pa_p[keep]
        )
    if pd_src.shape[0]:
        keep = pd_src != pd_dst
        pd_src, pd_dst = pd_src[keep], pd_dst[keep]

    if not (pa_src.shape[0] or pd_src.shape[0] or sa_src.shape[0]
            or sd_src.shape[0]):
        return AdvanceResult(st, z64, z64, z64)

    # -- 1. affected sources: reverse reachability over old ∪ new edges --
    touched = np.unique(np.concatenate([pa_src, pd_src]))
    add_rd, add_rs = _sort_pairs(S1, pa_dst, pa_src)  # adds by dst
    R = touched
    frontier = touched
    hops = 0
    while frontier.shape[0]:
        preds = []
        _, ii = _expand_join(st.er_dst, frontier)
        if ii.shape[0]:
            preds.append(st.er_src[ii])
        _, jj = _expand_join(add_rd, frontier)
        if jj.shape[0]:
            preds.append(add_rs[jj])
        if not preds:
            break
        cand = np.unique(np.concatenate(preds))
        frontier = cand[~_in_sorted(R, cand)]
        if frontier.shape[0]:
            R = np.union1d(R, frontier)
        if R.shape[0] > affected_cap:
            return None
        hops += 1
        if hops > max_hops:
            return None
    A_p = R  # sorted unique pair-source keys (srel1 > 0 by construction)

    # affected users: touched seeds, plus seeds (old ∪ added) whose target
    # reaches a touched pair source
    u_parts = [np.unique(np.concatenate([sa_src, sd_src]))]
    if A_p.shape[0]:
        _, ii = _expand_join(st.sr_dst, A_p)
        if ii.shape[0]:
            u_parts.append(st.sr_src[ii])
        if sa_src.shape[0]:
            hit = _in_sorted(A_p, sa_dst)
            if hit.any():
                u_parts.append(sa_src[hit])
    A_u = np.unique(np.concatenate(u_parts))
    if A_p.shape[0] + A_u.shape[0] > affected_cap:
        return None
    A_all = np.union1d(A_p, A_u)  # srel1 planes are disjoint

    # -- 2. edge-set update ------------------------------------------------
    pa_s, pa_ds, pa_dv, pa_pv = _sort_pairs(S1, pa_src, pa_dst, pa_d, pa_p)
    ne_src, ne_dst, ne_d, ne_p = _apply_edge_delta(
        S1, st.e_src, st.e_dst, (st.e_d, st.e_p),
        pd_src, pd_dst, pa_s, pa_ds, (pa_dv, pa_pv),
    )
    ner_dst, ner_src = _apply_edge_delta(
        S1, st.er_dst, st.er_src, (), pd_dst, pd_src, add_rd, add_rs, ()
    )
    sa_s, sa_ds, sa_dv, sa_pv = _sort_pairs(S1, sa_src, sa_dst, sa_d, sa_p)
    ns_src, ns_dst, ns_d, ns_p = _apply_edge_delta(
        S1, st.s_src, st.s_dst, (st.s_d, st.s_p),
        sd_src, sd_dst, sa_s, sa_ds, (sa_dv, sa_pv),
    )
    sr_a_d, sr_a_s = _sort_pairs(S1, sa_dst, sa_src)
    nsr_dst, nsr_src = _apply_edge_delta(
        S1, st.sr_dst, st.sr_src, (), sd_dst, sd_src, sr_a_d, sr_a_s, ()
    )

    # -- 3. subset recompute over the new edge set -------------------------
    b = _Builder(S1, st.per_source_cap)

    # pair phase: the fixpoint of build_closure restricted to A_p (the
    # expansion never changes a row's source, so restriction is exact)
    if A_p.shape[0]:
        _, ii = _expand_join(ne_src, A_p)
        c_src, c_dst = ne_src[ii], ne_dst[ii]
        c_d, c_p = ne_d[ii], ne_p[ii]
    else:
        c_src = c_dst = z64
        c_d = c_p = np.zeros(0, np.int32)
    c_src, c_dst, c_d, c_p = b.group_max(c_src, c_dst, c_d, c_p)
    c_src, c_dst, c_d, c_p = b.drop_oversized(c_src, c_dst, c_d, c_p)
    n_src, n_dst, n_d, n_p = c_src, c_dst, c_d, c_p
    for _ in range(max_hops):
        if n_src.size == 0:
            break
        reps, ii = _expand_join(ne_src, n_dst)
        if reps.size == 0:
            n_src = n_src[:0]
            break
        j_src = n_src[reps]
        j_dst = ne_dst[ii]
        j_d = np.minimum(n_d[reps], ne_d[ii])
        j_p = np.minimum(n_p[reps], ne_p[ii])
        keep = j_src != j_dst
        j_src, j_dst, j_d, j_p = j_src[keep], j_dst[keep], j_d[keep], j_p[keep]
        j_src, j_dst, j_d, j_p = b.group_max(j_src, j_dst, j_d, j_p)
        j_src, j_dst, j_d, j_p = b.drop_overflowed(j_src, j_dst, j_d, j_p)
        if j_src.size == 0:
            n_src = j_src
            break
        c_ids, j_ids = _pair_ids(c_src, c_dst, j_src, j_dst)
        pos = np.searchsorted(c_ids, j_ids)
        posc = np.clip(pos, 0, max(c_ids.shape[0] - 1, 0))
        found = (c_ids.shape[0] > 0) & (c_ids[posc] == j_ids)
        old_d = np.where(found, c_d[posc], NEVER)
        old_p = np.where(found, c_p[posc], NEVER)
        improved = (j_d > old_d) | (j_p > old_p)
        j_src, j_dst = j_src[improved], j_dst[improved]
        j_d, j_p = j_d[improved], j_p[improved]
        if j_src.size == 0:
            n_src = j_src
            break
        c_src, c_dst, c_d, c_p = b.group_max(
            np.concatenate([c_src, j_src]),
            np.concatenate([c_dst, j_dst]),
            np.concatenate([c_d, j_d]),
            np.concatenate([c_p, j_p]),
        )
        c_src, c_dst, c_d, c_p = b.drop_oversized(c_src, c_dst, c_d, c_p)
        n_src, n_dst, n_d, n_p = b.drop_overflowed(j_src, j_dst, j_d, j_p)
    if n_src.size:
        return None  # unconverged within the hop budget: rebuild

    # user phase: A_u's seeds ∪ (those seeds ⋈ pair closure), where the
    # pair closure is the recomputed subset at affected targets and the
    # untouched stored rows elsewhere
    if A_u.shape[0]:
        _, ii = _expand_join(ns_src, A_u)
        su_src, su_dst = ns_src[ii], ns_dst[ii]
        su_d, su_p = ns_d[ii], ns_p[ii]
    else:
        su_src = su_dst = z64
        su_d = su_p = np.zeros(0, np.int32)
    u_cols = [(su_src, su_dst, su_d, su_p)]
    if su_src.shape[0]:
        in_a = _in_sorted(A_p, su_dst) if A_p.shape[0] else np.zeros(
            su_dst.shape[0], bool
        )
        # recomputed pair rows for affected targets
        if in_a.any():
            reps, jj = _expand_join(c_src, su_dst[in_a])
            if reps.shape[0]:
                base_idx = np.nonzero(in_a)[0][reps]
                u_cols.append((
                    su_src[base_idx], c_dst[jj],
                    np.minimum(su_d[base_idx], c_d[jj]),
                    np.minimum(su_p[base_idx], c_p[jj]),
                ))
        # stored pair rows for untouched targets (src ∉ A by definition)
        if (~in_a).any():
            pair_rows = (st.a_src % S1) > 0
            op_src, op_dst = st.a_src[pair_rows], st.a_dst[pair_rows]
            op_d = st.cl.c_d_until[pair_rows]
            op_p = st.cl.c_p_until[pair_rows]
            reps, jj = _expand_join(op_src, su_dst[~in_a])
            if reps.shape[0]:
                base_idx = np.nonzero(~in_a)[0][reps]
                u_cols.append((
                    su_src[base_idx], op_dst[jj],
                    np.minimum(su_d[base_idx], op_d[jj]),
                    np.minimum(su_p[base_idx], op_p[jj]),
                ))
    u_src = np.concatenate([t[0] for t in u_cols])
    u_dst = np.concatenate([t[1] for t in u_cols])
    u_d = np.concatenate([t[2] for t in u_cols]).astype(np.int32)
    u_p = np.concatenate([t[3] for t in u_cols]).astype(np.int32)

    # overflow propagation: a user whose seed points at an overflowed pair
    # overflows too (checked against the GLOBAL new overflow set — kept
    # old entries plus the subset recompute's; user-plane keys in it can
    # never match a seed target, so the mix is harmless)
    ovf_kept = st.ovf[~_in_sorted(A_all, st.ovf)] if st.ovf.shape[0] else z64
    ovf_glob = np.union1d(ovf_kept, b.ovf)
    if ovf_glob.shape[0] and su_src.shape[0]:
        over = np.unique(su_src[_in_sorted(ovf_glob, su_dst)])
        b.add_overflow(over)
    u_src, u_dst, u_d, u_p = b.group_max(u_src, u_dst, u_d, u_p)
    u_src, u_dst, u_d, u_p = b.drop_oversized(u_src, u_dst, u_d, u_p)

    # -- 4. merge into the stored arrays ----------------------------------
    new_src = np.concatenate([u_src, c_src])
    new_dst = np.concatenate([u_dst, c_dst])
    new_d = np.concatenate([u_d, c_d]).astype(np.int32)
    new_p = np.concatenate([u_p, c_p]).astype(np.int32)
    full_ovf = np.union1d(ovf_kept, b.ovf)
    if full_ovf.shape[0] and new_src.shape[0]:
        keep = ~_in_sorted(full_ovf, new_src)
        new_src, new_dst = new_src[keep], new_dst[keep]
        new_d, new_p = new_d[keep], new_p[keep]
    new_src, new_dst, new_d, new_p = _sort_pairs(
        S1, new_src, new_dst, new_d, new_p
    )

    keep_old = (
        ~_in_sorted(A_all, st.a_src)
        if A_all.shape[0] and st.a_src.shape[0]
        else np.ones(st.a_src.shape[0], bool)
    )
    rm_src, rm_dst = st.a_src[~keep_old], st.a_dst[~keep_old]
    rm_d = st.cl.c_d_until[~keep_old]
    rm_p = st.cl.c_p_until[~keep_old]

    from .delta import find_in_view

    o_src, o_dst = st.a_src[keep_old], st.a_dst[keep_old]
    o_d = st.cl.c_d_until[keep_old]
    o_p = st.cl.c_p_until[keep_old]
    P = o_src.shape[0] + new_src.shape[0]
    if P > global_cap:
        return None
    # one native lexsort interleaves kept + recomputed rows (keys are
    # unique across the two sets: recomputed sources were removed above)
    m_src, m_dst, m_d, m_p = _sort_pairs(
        S1,
        np.concatenate([o_src, new_src]),
        np.concatenate([o_dst, new_dst]),
        np.concatenate([o_d, new_d]),
        np.concatenate([o_p, new_p]),
    )

    # -- 5. exact changed-row diff (old affected rows vs recomputed) ------
    at = find_in_view(new_src, new_dst, rm_src, rm_dst)
    gone_or_changed = (at < 0)
    found = at >= 0
    if found.any():
        fi = at[found]
        gone_or_changed[found] = (
            (new_d[fi] != rm_d[found]) | (new_p[fi] != rm_p[found])
        )
    back = find_in_view(rm_src, rm_dst, new_src, new_dst)
    fresh = back < 0  # value-changed rows are already covered above
    changed_dsts = np.unique(np.concatenate([
        rm_dst[gone_or_changed], new_dst[fresh],
    ]))

    cl = ClosureIndex(
        revision=revision,
        c_src=(m_src // S1).astype(np.int32),
        c_srel1=(m_src % S1).astype(np.int32),
        c_g=(m_dst // S1).astype(np.int32),
        c_grel=(m_dst % S1 - 1).astype(np.int32),
        c_d_until=m_d,
        c_p_until=m_p,
        ovf_src=(full_ovf // S1).astype(np.int32),
        ovf_srel1=(full_ovf % S1).astype(np.int32),
    )
    metrics.default.inc("closure.delta_applies")
    if int(revision) - int(st.revision) > 1:
        # one advance covering a multi-revision span — the whole point
        # of group commit: k writes, one closure delta
        metrics.default.inc("closure.batch_applies")
    # write-path observability: a sampled request whose delta-prepare
    # reached this advance records it on the request's active span
    # (utils/trace.py thread-local; one branch when tracing is off)
    from ..utils import trace as _trace

    _trace.event_if_active(
        "closure.advance",
        revision=int(revision),
        affected_pairs=int(A_p.shape[0]),
        affected_users=int(A_u.shape[0]),
        changed_dsts=int(changed_dsts.shape[0]),
    )
    return AdvanceResult(
        state=ClosureState(
            S1=S1, per_source_cap=st.per_source_cap, revision=revision,
            cl=cl, a_src=m_src, a_dst=m_dst, ovf=full_ovf,
            e_src=ne_src, e_dst=ne_dst, e_d=ne_d, e_p=ne_p,
            s_src=ns_src, s_dst=ns_dst, s_d=ns_d, s_p=ns_p,
            er_dst=ner_dst, er_src=ner_src, sr_dst=nsr_dst, sr_src=nsr_src,
        ),
        changed_dsts=changed_dsts,
        affected_pairs=A_p,
        affected_users=A_u,
    )
