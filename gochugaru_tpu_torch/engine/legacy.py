"""The legacy two-phase check program, batched on a torch device.

The flat program (engine/flat.py) serves a batch only when the snapshot
has flat tables and the batch asks for at most ``flat_max_slots``
distinct permissions.  Everything else — a wider batch, a graph whose
dense keys do not pack into int32, an ``EngineConfig(use_flat=False)``
engine — runs here, on the raw sorted int32 columns of
``DeviceEngine._host_arrays``:

- **Phase A — subject closure**, batched over the batch's unique
  (subject, subject relation, wildcard node, request context) rows: the
  subject's direct memberships seed a sorted, deduplicated list of the
  usersets it belongs to (at most ``closure_size``), and
  ``closure_hops`` propagation hops over the membership columns grow it;
  one more hop detects nesting deeper than the cap.  A schema with
  caveats keeps two closures, definite and possible.
- **Phase B — resource subgraph and fixpoint**, batched over queries: a
  capped BFS over the arrow (tupleset) columns collects up to
  ``subgraph_nodes`` nodes, relation leaf tests (exact-match searches
  plus closure probes for userset grants) seed a boolean table
  ``V[node, slot]``, and the schema's permission programs iterate
  ``eval_iters`` times over it in topological order.

Every cap has an overflow flag; flagged rows are settled by the caller on
the host oracle.

On a mesh (parallel/sharded.py) the program runs once per model shard,
over that shard's contiguous slice of every sorted column (the node
types, the stored contexts and the ``pus_*`` pair set stay whole), with
the shard's ``Collectives`` handle: the closure seeds and propagation
candidates and the arrow BFS children all-gather from every shard
(``M * arrow_fanout`` children a node and tupleset), the leaf hits and
the overflow flags OR-reduce — the reference's ``axis`` program
(``_agather`` / ``_pany``).  The program reproduces the reference package's
``_closure_one`` / ``_query_one`` / ``_make_check_fn`` (its XLA program,
vmapped per subject and per query) bit for bit, overflow plane included:
the same searches land on the same rows, the same slots are assigned in
the same order, and caveated edges go through the same CEL tri-state VM
(caveats/device.py ``make_tri_fn``).  These are plain tensor operations:
the reference runs them as XLA ops, outside any Pallas kernel.

Composite keys are compared lexicographically.  A pair of int32 columns
packs exactly into one order-preserving int64 key (``pack2``), which
``torch.searchsorted`` searches; the four-column edge key is two such
pairs, searched by a vectorised lexicographic bisect (``lex_search``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from .plan import DevicePlan, EngineConfig

I32_MAX = 2**31 - 1
_LO_BIAS = 2**31
_HI_UNIT = 2**32
#: the packed (I32_MAX, I32_MAX) pair: the padding sentinel, sorting last
SENTINEL = I32_MAX * _HI_UNIT + I32_MAX + _LO_BIAS
#: packed keys below this have a first component below I32_MAX
_LIVE_BELOW = I32_MAX * _HI_UNIT

#: bytes of temporaries one chunk of subjects (phase A) or of queries
#: (phase B) may hold.  At config 3's caps (closure 256, 8 parents a hop)
#: a subject's hop holds ~0.2 MB, so a chunk is ~5,000 subjects; a
#: query's leaf tests ~0.1 MB, so a chunk is ~10,000 queries
CHUNK_BYTES = 1 << 30

def pack2(a, b) -> torch.Tensor:
    """The int64 key of int32 pairs (a, b), ordered as the pairs are
    lexicographically (``b`` is biased into the unsigned low word).
    Either side may be a Python int."""
    hi = a * _HI_UNIT if isinstance(a, int) else a.long() * _HI_UNIT
    lo = b + _LO_BIAS if isinstance(b, int) else b.long() + _LO_BIAS
    return hi + lo


def lex_search(cols, qs, side: str) -> torch.Tensor:
    """Insertion index of the rows ``qs`` into the lexicographically
    sorted columns ``cols`` (padded with sentinels that sort last): the
    reference's ``_lex_search``, one bisect step for every lane at once,
    with its step count."""
    n = cols[0].shape[0]
    steps = max(1, (n - 1).bit_length() + 1)
    shape = torch.broadcast_shapes(*(q.shape for q in qs))
    dev = cols[0].device
    lo = torch.zeros(shape, dtype=torch.long, device=dev)
    hi = torch.full(shape, n, dtype=torch.long, device=dev)
    for _ in range(steps):
        cont = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor").clamp_(0, n - 1)
        lt = torch.zeros(shape, dtype=torch.bool, device=dev)
        eq = torch.ones(shape, dtype=torch.bool, device=dev)
        for c, q in zip(cols, qs):
            v = c[mid]
            lt = lt | (eq & (v < q))
            eq = eq & (v == q)
        go_right = lt | eq if side == "right" else lt
        lo = torch.where(cont & go_right, mid + 1, lo)
        hi = torch.where(cont & ~go_right, mid, hi)
    return lo


def _contains_rows(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per row r, whether each key of ``q[r]`` occurs in the sorted row
    ``keys[r]`` (the reference's ``_lex_contains2`` on a closure)."""
    pos = torch.searchsorted(keys, q).clamp_(0, keys.shape[1] - 1)
    return keys.gather(1, pos) == q


def _contains(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Whether each key of ``q`` occurs in the sorted 1-D ``keys``."""
    pos = torch.searchsorted(keys, q).clamp_(0, keys.shape[0] - 1)
    return keys[pos] == q


def dedup_truncate(keys: torch.Tensor, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: sort the packed pairs, drop duplicates and pairs whose
    first component is the sentinel, keep the first ``C``; with the
    overflow flag (more than ``C`` distinct pairs).  The reference's
    ``_dedup_truncate``."""
    R, L = keys.shape
    if L < C:
        pad = torch.full((R, C - L), SENTINEL, dtype=torch.long, device=keys.device)
        keys = torch.cat([keys, pad], 1)
    s = keys.sort(dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    keep = first & (s < _LIVE_BELOW)
    out = torch.where(keep, s, SENTINEL).sort(dim=1).values[:, :C]
    return out.contiguous(), keep.sum(1) > C


def _gather_rows(comm, x: torch.Tensor) -> torch.Tensor:
    """``x`` [R, L] with every shard's ``x`` appended along the row:
    [R, M·L] in shard order (identity off a mesh)."""
    if comm is None:
        return x
    g = comm.all_gather(x)  # [M, R, L]
    return g.permute(1, 0, 2).reshape(x.shape[0], -1)


def _gather_last(comm, x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] with every shard's ``x`` concatenated along the
    last axis: [..., M·K] in shard order (identity off a mesh)."""
    if comm is None:
        return x
    g = comm.all_gather(x)  # [M, ..., K]
    g = g.movedim(0, -2)  # [..., M, K]
    return g.reshape(x.shape[:-1] + (-1,))


def legacy_tables(arrays: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The program's argument dict: the raw columns (and any ``ectx_*``
    stored-context tables) plus their packed search keys, built on the
    columns' device once per snapshot."""
    t = dict(arrays)
    t["e_hi"] = pack2(arrays["e_rel"], arrays["e_res"])
    t["e_lo"] = pack2(arrays["e_subj"], arrays["e_srel1"])
    t["us_key"] = pack2(arrays["us_rel"], arrays["us_res"])
    t["pus_key"] = pack2(arrays["pus_n"], arrays["pus_r"])
    t["mp_key"] = pack2(arrays["mp_subj"], arrays["mp_srel"])
    t["ar_key"] = pack2(arrays["ar_rel"], arrays["ar_res"])
    return t


class LegacyProgram:
    """The whole-batch check of one schema plan and config:
    ``program(tables, tid_map, now, uniq, queries, qctx)`` →
    (definite, possible, overflow) bool tensors of the batch length.

    ``uniq`` holds the unique subject rows (``u_subj``, ``u_srel``,
    ``u_wc``, ``u_qctx``), ``queries`` the per-query columns (``q_res``,
    ``q_perm``, ``q_subj``, ``q_srel``, ``q_wc``, ``q_row``, ``q_self``,
    ``q_ctx``), all on the tables' device; ``q_row`` indexes ``uniq``.
    ``qctx`` holds the request-context tables (``vi``/``vf``/``pr``/
    ``host``) when the schema has caveats."""

    def __init__(self, plan: DevicePlan, cfg: EngineConfig,
                 tri: Optional[Callable] = None, num_params: int = 1) -> None:
        self.plan = plan
        self.cfg = cfg
        #: the caveat tri-state VM (None: the schema has no caveats)
        self.tri = tri
        #: the request-context width, for the chunk-size estimates
        self._num_params = max(1, num_params)
        self.chunk_bytes = CHUNK_BYTES

    # -- the gate -------------------------------------------------------
    def _gate(self, cav, ctx, exp, now, plane, qctx, tables):
        """Edge admissibility (the reference's ``_gate``): expired edges
        grant nothing; caveated ones go through the tri-state VM against
        the stored-over-request context — TRUE for the definite plane,
        TRUE or UNKNOWN for the possible one.  Without caveats in the
        schema the definite plane admits only uncaveated edges."""
        live = (exp == 0) | (exp > now)
        if self.tri is None:
            return live if plane == "p" else live & (cav == 0)
        t = self.tri(cav, ctx, torch.broadcast_to(qctx, cav.shape), tables)
        return live & (t >= 1) if plane == "p" else live & (t == 2)

    # -- phase A ----------------------------------------------------------
    def _closure(self, T, plane, now, u_subj, u_srel, u_wc, u_qctx, tables,
                 comm=None):
        """Closure keys [U, closure_size] (sorted packed pairs, sentinel
        padded) and the shard-local overflow flag per subject row.  On a
        mesh every shard's local candidates are gathered before each
        dedup, so the closure itself is the same on every shard."""
        cfg = self.cfg
        C, SC, P = cfg.closure_size, cfg.seed_cap, cfg.prop_cap
        dev = u_subj.device
        ovf = torch.zeros(u_subj.shape, dtype=torch.bool, device=dev)
        own = u_srel >= 0
        keys = [pack2(torch.where(own, u_subj, I32_MAX),
                      torch.where(own, u_srel, I32_MAX))[:, None]]
        ms_subj = T["ms_subj"]
        last = max(ms_subj.shape[0] - 1, 0)
        ar = torch.arange(SC, device=dev)
        qc = u_qctx[:, None]
        for src0 in (u_subj, u_wc):
            src = torch.where(u_srel < 0, src0, -1)
            lo = torch.searchsorted(ms_subj, src, side="left")
            hi = torch.searchsorted(ms_subj, src, side="right")
            ovf |= (hi - lo) > SC
            idx = lo[:, None] + ar
            valid = (idx < hi[:, None]) & (src >= 0)[:, None]
            idxc = idx.clamp(0, last)
            keep = valid & self._gate(
                T["ms_caveat"][idxc], T["ms_ctx"][idxc], T["ms_exp"][idxc],
                now, plane, qc, tables)
            keys.append(_gather_rows(comm, torch.where(
                keep, pack2(T["ms_res"][idxc], T["ms_rel"][idxc]), SENTINEL)))
        ck, o = dedup_truncate(torch.cat(keys, 1), C)
        ovf |= o

        mp_key = T["mp_key"]
        lastp = max(mp_key.shape[0] - 1, 0)
        arp = torch.arange(P, device=dev)
        qcp = u_qctx[:, None, None]

        def hop(ck, ovf):
            lo = torch.searchsorted(mp_key, ck, side="left")
            hi = torch.searchsorted(mp_key, ck, side="right")
            # as in the reference, a sentinel slot's range (the columns'
            # sentinel padding) counts too: padding past P rows flags
            # every subject (ROADMAP queue 3 item 8)
            ovf = ovf | ((hi - lo) > P).any(1)
            idx = lo[..., None] + arp
            valid = (idx < hi[..., None]) & (ck < _LIVE_BELOW)[..., None]
            idxc = idx.clamp(0, lastp)
            keep = valid & self._gate(
                T["mp_caveat"][idxc], T["mp_ctx"][idxc], T["mp_exp"][idxc],
                now, plane, qcp, tables)
            cand = torch.where(
                keep, pack2(T["mp_res"][idxc], T["mp_rel"][idxc]), SENTINEL)
            cand = _gather_rows(comm, cand.reshape(ck.shape[0], -1))
            ck, o = dedup_truncate(torch.cat([ck, cand], 1), C)
            return ck, ovf | o

        for _ in range(cfg.closure_hops):
            ck, ovf = hop(ck, ovf)
        if cfg.closure_hops > 0:
            # detection pass: a closure that still grows one hop further
            # nests deeper than closure_hops — flag it for the host
            before = (ck < _LIVE_BELOW).sum(1)
            ck, ovf = hop(ck, ovf)
            ovf |= (ck < _LIVE_BELOW).sum(1) > before
        return ck, ovf

    # -- phase B ------------------------------------------------------------
    @staticmethod
    def _assign(nodes, count, c, N):
        """The reference's sequential ``lax.scan(assign, ...)`` over one
        hop's candidate children ``c`` [Bq, M], in candidate order, for
        every query at once: a candidate already among ``nodes`` takes its
        slot; the first occurrence of each new one takes slot ``count +
        rank`` (rank = how many distinct new candidates came before it)
        while that is below ``N``; every later occurrence takes its first
        occurrence's slot; a new candidate past ``N`` takes -1 and flags
        overflow.  Returns (slots, nodes, count, overflow)."""
        Bq, M = c.shape
        dev = c.device
        valid = c >= 0
        eq0 = c[:, :, None] == nodes[:, None, :]
        found0 = eq0.any(2)
        slot0 = eq0.int().argmax(2)
        new = valid & ~found0
        big = torch.iinfo(torch.long).max
        skey, perm = torch.where(new, c.long(), big).sort(dim=1, stable=True)
        first_s = torch.ones_like(skey, dtype=torch.bool)
        first_s[:, 1:] = skey[:, 1:] != skey[:, :-1]
        first_s &= skey != big
        is_first = torch.zeros_like(first_s).scatter_(1, perm, first_s)
        rank_seq = torch.cumsum(is_first.long(), 1) - 1
        pos = torch.arange(M, device=dev).expand(Bq, M)
        start = torch.where(first_s, pos, 0).cummax(1).values
        rank_s = rank_seq.gather(1, perm).gather(1, start)
        rank = torch.empty_like(rank_s).scatter_(1, perm, rank_s)
        avail = (N - count)[:, None]
        added = new & (rank < avail)
        slot = torch.where(
            found0, slot0, torch.where(added, count[:, None] + rank, -1))
        slot = torch.where(valid, slot, -1)
        overflow = (new & ~added).any(1)
        wr = is_first & added
        tgt = torch.where(wr, count[:, None] + rank, N)
        buf = torch.cat([nodes, torch.zeros_like(nodes[:, :1])], 1)
        buf.scatter_(1, tgt, c.to(buf.dtype))
        return slot, buf[:, :N], count + wr.sum(1), overflow

    def _queries(self, T, tid_of, now, Ck_d, Ck_p, q, tables, comm=None):
        """Phase B for one chunk of queries: (definite, possible,
        shard-local overflow).  On a mesh each BFS hop gathers every
        shard's candidate children (``M * K`` a node and tupleset, in
        shard order) before the slots are assigned, so the subgraph is
        the same on every shard, and the leaf hits OR-reduce."""
        plan, cfg = self.plan, self.cfg
        N, K, KU = cfg.subgraph_nodes, cfg.arrow_fanout, cfg.us_leaf_cap
        M = 1 if comm is None else comm.axis_size()
        KE = K * M
        TS, SLOTS = len(plan.ts_slots), plan.num_slots
        q_res, q_subj, q_srel = q["q_res"], q["q_subj"], q["q_srel"]
        qc = q["q_ctx"]
        Bq = q_res.shape[0]
        dev = q_res.device
        overflow = torch.zeros(Bq, dtype=torch.bool, device=dev)
        my_d = Ck_d[q["q_row"]]
        my_p = my_d if Ck_p is Ck_d else Ck_p[q["q_row"]]

        # ---- B1: arrow-subgraph BFS ----------------------------------
        nodes = torch.full((Bq, N), -1, dtype=torch.int32, device=dev)
        nodes[:, 0] = q_res
        count = (q_res >= 0).long()
        TSax = max(TS, 1)
        child_slot = torch.full((Bq, N, TSax, KE), -1, dtype=torch.long, device=dev)
        child_gd = torch.zeros((Bq, N, TSax, KE), dtype=torch.bool, device=dev)
        child_gp = child_gd
        if TS > 0:
            ar_key = T["ar_key"]
            last_ar = max(ar_key.shape[0] - 1, 0)
            ark = torch.arange(K, device=dev)
            qc3 = qc[:, None, None]
            # N-1 hops discover a chain of N nodes; the extra hop scans
            # the last-discovered nodes' children so a deeper subgraph
            # trips the overflow instead of truncating silently
            for _hop in range(max(N - 1, 1) + 1):
                nq = torch.where(nodes >= 0, nodes, I32_MAX)
                cc, cgd, cgp = [], [], []
                for ts_slot in plan.ts_slots:
                    qk = pack2(ts_slot, nq)
                    lo = torch.searchsorted(ar_key, qk, side="left")
                    hi = torch.searchsorted(ar_key, qk, side="right")
                    overflow |= ((hi - lo) > K).any(1)
                    idx = lo[..., None] + ark
                    valid = (idx < hi[..., None]) & (nodes >= 0)[..., None]
                    idxc = idx.clamp(0, last_ar)
                    cav, ctx, exp = (T["ar_caveat"][idxc], T["ar_ctx"][idxc],
                                     T["ar_exp"][idxc])
                    cgd.append(valid & self._gate(cav, ctx, exp, now, "d", qc3, tables))
                    cgp.append(valid & self._gate(cav, ctx, exp, now, "p", qc3, tables))
                    cc.append(torch.where(valid, T["ar_child"][idxc], -1))
                # [Bq, TS, N, K]; on a mesh [Bq, TS, N, M·K], every
                # shard's children in shard order
                cc = _gather_last(comm, torch.stack(cc, 1))
                cgd = _gather_last(comm, torch.stack(cgd, 1))
                cgp = _gather_last(comm, torch.stack(cgp, 1))
                slots, nodes, count, o = self._assign(
                    nodes, count, cc.reshape(Bq, -1), N)
                overflow |= o
                child_slot = slots.reshape(Bq, TS, N, KE).permute(0, 2, 1, 3)
                child_gd = cgd.permute(0, 2, 1, 3)
                child_gp = cgp.permute(0, 2, 1, 3)

        # ---- B2: relation leaf tests -----------------------------------
        rs_list = list(plan.rel_leaf_slots) or [0]
        rs = torch.tensor(rs_list, dtype=torch.int32, device=dev)
        exists = (nodes >= 0)[..., None]  # [Bq, N, 1]
        node_k = torch.where(exists, nodes[..., None], I32_MAX)
        qhi = pack2(rs, node_k)  # [Bq, N, R]
        e_hi, e_lo = T["e_hi"], T["e_lo"]
        last_e = max(e_hi.shape[0] - 1, 0)
        qc3 = qc[:, None, None]

        def edge_hit(qlo, ok):
            pos = lex_search((e_hi, e_lo), (qhi, qlo), "left").clamp_(0, last_e)
            hit = exists & ok & (e_hi[pos] == qhi) & (e_lo[pos] == qlo)
            cav, ctx, exp = T["e_caveat"][pos], T["e_ctx"][pos], T["e_exp"][pos]
            return (hit & self._gate(cav, ctx, exp, now, "d", qc3, tables),
                    hit & self._gate(cav, ctx, exp, now, "p", qc3, tables))

        # direct subject
        leaf_d, leaf_p = edge_hit(
            pack2(q_subj, q_srel + 1)[:, None, None], (q_subj >= 0)[:, None, None])
        # wildcard (grants only direct-object subject queries)
        wq = torch.where((q["q_wc"] >= 0) & (q_srel < 0), q["q_wc"], I32_MAX)
        wd, wp = edge_hit(pack2(wq, 0)[:, None, None], (wq < I32_MAX)[:, None, None])
        leaf_d = leaf_d | wd
        leaf_p = leaf_p | wp
        # userset grants probed against the subject closure
        us_key = T["us_key"]
        lo = torch.searchsorted(us_key, qhi, side="left")
        hi = torch.searchsorted(us_key, qhi, side="right")
        leaf_ovf = (hi - lo) > KU
        idx = lo[..., None] + torch.arange(KU, device=dev)  # [Bq, N, R, KU]
        valid = (idx < hi[..., None]) & exists[..., None]
        idxc = idx.clamp(0, max(us_key.shape[0] - 1, 0))
        uk = pack2(T["us_subj"][idxc], T["us_srel"][idxc])
        flat_uk = uk.reshape(Bq, -1)
        in_d = _contains_rows(my_d, flat_uk).reshape(uk.shape)
        in_p = in_d if my_p is my_d else _contains_rows(my_p, flat_uk).reshape(uk.shape)
        if plan.has_permission_usersets:
            # permission-valued usersets: membership is a permission the
            # program does not run — the grant is possible (the host
            # settles it), never definite; so are relation usersets a
            # permission chain may extend (the static pus pair set)
            permf = T["us_perm"][idxc] != 0
            in_pus = _contains(T["pus_key"], uk)
            in_d = in_d & ~permf
            in_p = in_p | in_pus | permf
        cav, ctx, exp = T["us_caveat"][idxc], T["us_ctx"][idxc], T["us_exp"][idxc]
        qc4 = qc[:, None, None, None]
        leaf_d = leaf_d | (valid & in_d & self._gate(
            cav, ctx, exp, now, "d", qc4, tables)).any(-1)
        leaf_p = leaf_p | (valid & in_p & self._gate(
            cav, ctx, exp, now, "p", qc4, tables)).any(-1)
        if comm is not None:
            # a direct / wildcard / userset grant may live on any shard
            leaf_d, leaf_p = comm.por(leaf_d), comm.por(leaf_p)
        overflow |= (leaf_ovf & exists).flatten(1).any(1)

        V_d = torch.zeros((Bq, N, SLOTS), dtype=torch.bool, device=dev)
        V_p = torch.zeros((Bq, N, SLOTS), dtype=torch.bool, device=dev)
        if plan.rel_leaf_slots:
            cols = list(plan.rel_leaf_slots)
            V_d[:, :, cols] = leaf_d
            V_p[:, :, cols] = leaf_p

        # ---- B3: fixpoint over the permission programs -----------------
        ntype = torch.where(
            nodes >= 0, T["node_type"][nodes.clamp(min=0).long()].int(), -1)
        live = nodes >= 0

        def arrow(V, gates, ti, rslot):
            cs = child_slot[:, :, ti, :]
            got = V[:, :, rslot].gather(1, cs.clamp(min=0).reshape(Bq, -1))
            return (got.reshape(cs.shape) & (cs >= 0) & gates[:, :, ti, :]).any(-1)

        def eval_expr(ir):
            tag = ir[0]
            if tag == "ref":
                return V_d[:, :, ir[1]], V_p[:, :, ir[1]]
            if tag == "nil":
                z = torch.zeros((Bq, N), dtype=torch.bool, device=dev)
                return z, z
            if tag == "arrow":
                return (arrow(V_d, child_gd, ir[1], ir[2]),
                        arrow(V_p, child_gp, ir[1], ir[2]))
            if tag in ("union", "inter"):
                acc = None
                for c in ir[1]:
                    cd, cp = eval_expr(c)
                    if acc is None:
                        acc = (cd, cp)
                    elif tag == "union":
                        acc = (acc[0] | cd, acc[1] | cp)
                    else:
                        acc = (acc[0] & cd, acc[1] & cp)
                if acc is None:
                    fill = tag == "inter"
                    z = torch.full((Bq, N), fill, dtype=torch.bool, device=dev)
                    return z, z
                return acc
            if tag == "excl":
                bd, bp = eval_expr(ir[1])
                sd, sp = eval_expr(ir[2])
                # Kleene: definite iff base definite and subtracted
                # definitely absent; possible iff base possible and
                # subtracted not definite
                return bd & ~sp, bp & ~sd
            raise TypeError(f"bad expression IR {ir!r}")

        if plan.topo_programs:
            masks = {}
            for _ in range(cfg.eval_iters):
                for (_tname, tid, slot, expr) in plan.topo_programs:
                    mask = masks.get(tid)
                    if mask is None:
                        mask = masks[tid] = (ntype == tid_of[tid]) & live
                    d, p = eval_expr(expr)
                    V_d[:, :, slot] = torch.where(mask, d, V_d[:, :, slot])
                    V_p[:, :, slot] = torch.where(mask, p, V_p[:, :, slot])

        valid_q = (q_res >= 0) & (q["q_perm"] >= 0)
        perm_c = q["q_perm"].clamp(0, SLOTS - 1).long()[:, None]
        d = (V_d[:, 0, :].gather(1, perm_c)[:, 0] & valid_q) | q["q_self"]
        p = (V_p[:, 0, :].gather(1, perm_c)[:, 0] & valid_q) | q["q_self"]
        return d, p, overflow

    # -- chunking -------------------------------------------------------
    def subject_row_bytes(self, M: int = 1) -> int:
        """Estimated temporaries of one subject row's closure hop
        (``M`` shards' candidates gathered)."""
        cfg = self.cfg
        L = cfg.closure_size * (M * cfg.prop_cap + 1) + 2 * M * cfg.seed_cap
        return L * 64 + cfg.closure_size * cfg.prop_cap * self._num_params * 32

    def query_row_bytes(self, M: int = 1) -> int:
        """Estimated temporaries of one query's phase B (``M`` shards'
        BFS children gathered)."""
        plan, cfg = self.plan, self.cfg
        N, R = cfg.subgraph_nodes, max(len(plan.rel_leaf_slots), 1)
        lanes = N * R * cfg.us_leaf_cap
        bfs = len(plan.ts_slots) * N * M * cfg.arrow_fanout * (N + 96)
        return (4 * cfg.closure_size * 8 + lanes * (128 + 32 * self._num_params)
                + bfs + N * plan.num_slots * 4)

    def __call__(self, T, tid_map, now, uniq, queries, qctx=None, comm=None):
        """The batch's planes.  ``comm`` (a mesh shard's
        ``parallel.collectives.Collectives``) runs the sharded program
        over this shard's column slices; every shard of a model row
        returns the same planes."""
        M = 1 if comm is None else comm.axis_size()
        tables = None
        if self.tri is not None:
            tables = {
                "ectx_vi": T["ectx_vi"], "ectx_vf": T["ectx_vf"],
                "ectx_pr": T["ectx_pr"], "ectx_host": T["ectx_host"],
                "qctx_vi": qctx["vi"], "qctx_vf": qctx["vf"],
                "qctx_pr": qctx["pr"], "qctx_host": qctx["host"],
            }
        tid_of = [int(x) for x in tid_map.tolist()]
        U = uniq["u_subj"].shape[0]
        step = max(1, self.chunk_bytes // self.subject_row_bytes(M))
        cps, cds, uovf = [], [], []
        for a in range(0, U, step):
            args = [uniq[k][a:a + step] for k in ("u_subj", "u_srel", "u_wc", "u_qctx")]
            cp, op = self._closure(T, "p", now, *args, tables, comm)
            if self.plan.two_plane:
                cd, od = self._closure(T, "d", now, *args, tables, comm)
            else:
                cd, od = cp, op
            cps.append(cp)
            cds.append(cd)
            uovf.append(op | od)
        Ck_p = torch.cat(cps)
        Ck_d = torch.cat(cds) if self.plan.two_plane else Ck_p
        u_ovf = torch.cat(uovf)

        B = queries["q_res"].shape[0]
        step = max(1, self.chunk_bytes // self.query_row_bytes(M))
        ds, ps, os_ = [], [], []
        for a in range(0, B, step):
            q = {k: v[a:a + step] for k, v in queries.items()}
            d, p, o = self._queries(T, tid_of, now, Ck_d, Ck_p, q, tables,
                                    comm)
            ds.append(d)
            ps.append(p)
            os_.append(o | u_ovf[q["q_row"]])
        ovf = torch.cat(os_)
        if comm is not None:
            # overflow anywhere on the row overflows the query
            ovf = comm.por(ovf)
        return torch.cat(ds), torch.cat(ps), ovf
