"""One masked-SpMM sparse core: multi-hop lookups and the fold T-join as
instances of a single batched semiring primitive.

The reverse frontier SpMV (engine/spmv.py) and the factored fold T-join
(engine/fold.py) are the same computation: a masked sparse matrix
product over the relation graph,

    C = M .* (A ⊕.⊗ B)

with the semiring multiply ⊗ = the packed caveat/expiry gate (an edge
contributes only while live and unconditionally resolvable — the same
``decode_block`` filter the Check kernels apply), the add ⊕ =
short-circuited max/OR (a grant is a grant; until-values reduce by max),
and the mask M = the seen-set bitmaps plus the schema-level type-safety
pruning tables (RedisGraph runs a whole graph database on this GraphBLAS
reduction, arXiv:1905.01294).

This module makes the primitive explicit:

- **Fused multi-hop lookups**: LookupResources / LookupSubjects run their
  whole frontier fixpoint — up to ``spmm_rounds`` hops — in one device
  program.  The frontier is carried on the device between hops at a
  fixed pow2 capacity, dedup is on-device bitmaps (the ⊕ short-circuit:
  a key contributes once), and each hop reuses spmv.py's probe and
  emission steps (``FrontierKernels._runs_fn`` / ``_emit_fn``: the
  ``runs`` kernel, and ``block`` on the forward arrow hop) at fixed
  widths — one hop is one masked SpMV, the K-hop program is the SpMM.
  The host only seeds, paginates and resolves cursors: a lookup pays one
  dispatch and one read-back instead of two per hop.
- **One CUDA-graph replay**: a round over an empty frontier changes
  nothing, and a round after an overflow only changes an answer that is
  then thrown away, so K fixed rounds give the early-exit loop's answer
  bit for bit.  On ``cuda`` the K rounds are captured once per
  (snapshot, direction) into a ``torch.cuda.CUDAGraph`` over a static
  input vector (seeds, type, relation, wildcard node, clock) and
  replayed per lookup; on ``cpu`` the rounds run eagerly and stop, as
  the reference's ``while_loop`` does, when the frontier is empty, an
  overflow is set, or K rounds ran.  A graph reads the tensors it was
  captured on, so it lives with the snapshot's ``FusedLookup``, never
  with the meta-keyed ``SpmmKernels``.
- **Overflow honesty**: every fixed capacity (frontier width, per-round
  emission, candidate buffer, round budget) has an on-device overflow
  flag; an overflowing query falls back to the looped spmv path, so the
  fused program trades dispatch count for coverage, never correctness.
  A kernel that fails raises ``KernelError``; it never falls back.
- **The fold T-join** (``tjoin_spmm``): the userset⋈closure join that
  builds flat.py's T-index is the host instance of the same primitive
  over the (min, max) until-semiring.  Its output is byte for byte that
  of fold.py ``t_join_core``, which flat.py calls whatever the config;
  this one stays as the primitive's own host instance and its parity
  check.

Parity: ``EngineConfig.spmm`` (default on) is the lever — off serves the
looped spmv path.  Sharded snapshots keep the looped path.

Counters: ``spmm.dispatches`` (fused program runs — a multi-hop lookup
answers with exactly one), ``spmm.fallbacks`` (overflows to the looped
path, counted in spmv.py), ``spmm.captures`` (graphs captured), and the
``spmm.dispatch`` fault site (utils/faults.py), which fires after
``lookup.dispatch`` under the client's retry envelope.  The programs
register with the cost ledger (utils/perf.py, kind ``spmm``) through its
decline path, and ``/perf`` carries an ``spmm`` section.
"""

from __future__ import annotations

import threading
import time
import weakref
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import faults, metrics
from . import kernels as _K
from .capture import recording
from .hash import _ceil_pow2

_mt = metrics.default

#: host-side pad widths of the fused programs' seed arguments (static,
#: so every query of a snapshot replays one graph)
_SEED_KEYS = 4
_SEED_NODES = 2

#: int32 sentinel marking dead lanes in on-device pools (sorts last)
_SENT = (1 << 31) - 1



# ---------------------------------------------------------------------------
# the host instance: the fold T-join as a sorted-operand semiring product
# ---------------------------------------------------------------------------


def masked_semiring_spmm(
    a_i: np.ndarray, a_k: np.ndarray, a_v: np.ndarray,
    b_k: np.ndarray, b_j: np.ndarray, b_planes: Tuple[np.ndarray, ...],
    cap_rows: int,
) -> Optional[Tuple[np.ndarray, ...]]:
    """C = (A ⊕.⊗ B) + A⊗I over sorted sparse operands on the host:
    A's rows are (i, k, v), B's are (k, j, plane-values); ⊗ =
    ``np.minimum`` (until-window intersection), ⊕ = per-(i, j) max
    (the widest surviving window wins), and the identity term keeps A's
    own (i, k) rows riding along (the direct group entries of the
    T-index).  The mask is the size gate: the product is sized with two
    searchsorted passes BEFORE materializing, and ``None`` past
    ``cap_rows`` declines (a popular k with a huge B in-degree must
    disable the index, not OOM).  Returns (C_i, C_j, *plane-maxima)."""
    from ..store.closure import _expand_join

    order = np.argsort(b_k, kind="stable")
    b_sorted = b_k[order]
    join_rows = int(
        (
            np.searchsorted(b_sorted, a_k, "right")
            - np.searchsorted(b_sorted, a_k, "left")
        ).sum()
    )
    if join_rows + a_k.shape[0] > cap_rows:
        return None
    reps, ii = _expand_join(b_sorted, a_k)
    jj = order[ii]
    out_i = np.concatenate([a_i, a_i[reps]])
    out_j = np.concatenate([a_k, b_j[jj]])
    planes = [
        np.concatenate([a_v, np.minimum(a_v[reps], p[jj])]) for p in b_planes
    ]
    o2 = np.lexsort((out_j, out_i))
    out_i, out_j = out_i[o2], out_j[o2]
    first = np.ones(out_i.shape[0], bool)
    first[1:] = (out_i[1:] != out_i[:-1]) | (out_j[1:] != out_j[:-1])
    st = np.nonzero(first)[0]
    return (
        out_i[first], out_j[first],
        *[np.maximum.reduceat(p[o2], st) for p in planes],
    )


def tjoin_spmm(
    k1: np.ndarray, pe: np.ndarray, w: np.ndarray,
    cl_k1: np.ndarray, cl_k2: np.ndarray,
    c_d: np.ndarray, c_p: np.ndarray, cap_rows: int,
) -> Optional[Tuple[np.ndarray, ...]]:
    """The T-index join (flat.py ``_tindex_join``) as the host SpMM
    instance: A = userset entries (row-key k1, group-key pe, until w),
    B = the membership closure by target, planes = (definite, possible)
    untils.  Byte-for-byte the output of fold.py ``t_join_core``, the
    join a prepare calls."""
    return masked_semiring_spmm(
        k1, pe, w, cl_k2, cl_k1, (c_d, c_p), cap_rows
    )


# ---------------------------------------------------------------------------
# on-device set algebra (fixed shapes; the ⊕ short-circuit as bitmaps)
# ---------------------------------------------------------------------------


def _bitmap(bits: int, device) -> torch.Tensor:
    """A cleared bitmap of ``bits`` bits: int64 words holding 32 bits
    each, so a marked bit 31 stays a plain positive value."""
    return torch.zeros((bits + 31) // 32, dtype=torch.int64, device=device)


def _bm_mark(bm, ids, valid) -> None:
    """Set ``ids``' bits in place.  The ids are sorted-unique among
    ``valid`` and their bits clear, so the (word, bit) pairs are
    distinct and the scatter-add is an exact OR."""
    word = torch.where(valid, ids >> 5, 0).long()
    bit = torch.where(valid, torch.ones_like(word) << (ids & 31).long(), 0)
    bm.index_add_(0, word, bit)


def _bm_unseen(bm, ids, valid):
    """``valid`` entries whose bit is still clear."""
    word = torch.where(valid, ids >> 5, 0)
    got = (bm[word] >> (torch.where(valid, ids, 0) & 31)) & 1
    return valid & (got == 0)


def _fresh(pool, valid, bm):
    """Sorted-unique not-yet-seen subset of ``pool``, marked into ``bm``
    in place: returns (sorted pool, fresh mask).  The device twin of
    spmv._Seen.fresh — dead lanes ride as the sort-last sentinel."""
    x = torch.sort(torch.where(valid, pool, _SENT)).values
    uniq = x != _SENT
    uniq[1:] &= x[1:] != x[:-1]
    fresh = _bm_unseen(bm, x, uniq)
    _bm_mark(bm, x, fresh)
    return x, fresh


def _scatter_at(buf, pos, vals, mask, cap: int):
    """``vals[mask]`` written at ``pos`` of a [cap + 1] buffer in place;
    masked-off lanes and positions past ``cap`` land in the last slot,
    which is never read (the reference's ``mode="drop"``)."""
    idx = torch.where(mask & (pos < cap), pos, cap).long()
    buf.scatter_(0, idx, torch.where(mask, vals, 0))


def _compact(vals, mask, cap: int):
    """Masked entries packed order-stable into a fixed [cap] buffer
    (-1 fill): returns (buffer, count, overflowed)."""
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, 0, dtype=torch.int32) - 1
    cnt = m.sum(dtype=torch.int32)
    out = torch.full((cap + 1,), -1, dtype=torch.int32, device=vals.device)
    _scatter_at(out, pos, vals, mask, cap)
    return out[:cap], cnt, cnt > cap


def _append(buf, n, vals, mask, cap: int):
    """Masked entries appended in place at offset ``n`` of a [cap + 1]
    buffer: returns (n', overflowed)."""
    m = mask.to(torch.int32)
    pos = n + torch.cumsum(m, 0, dtype=torch.int32) - 1
    cnt = n + m.sum(dtype=torch.int32)
    _scatter_at(buf, pos, vals, mask, cap)
    return torch.clamp(cnt, max=cap), cnt > cap


# ---------------------------------------------------------------------------
# the fused K-hop programs (per FlatMeta, cached on the engine)
# ---------------------------------------------------------------------------


class SpmmKernels:
    """The fused K-hop lookup programs of one FlatMeta geometry: the spmv
    probe/emission steps composed at fixed widths, one function a round.
    F, E, C and K come from the config (F and E rounded up to powers of
    two, as the reference does); Ea is the reverse-arrow emission width.
    A program is (init, round, out) over a state tuple whose first two
    entries are the frontiers and whose last is the overflow flag.  Holds
    no tensor of a snapshot: the graphs live with each ``FusedLookup``."""

    def __init__(self, meta, config) -> None:
        self.meta = meta
        self.F = _ceil_pow2(int(config.spmm_frontier), 256)
        self.E = _ceil_pow2(int(config.spmm_emit), 1024)
        self.C = int(config.spmm_candidates)
        self.K = int(config.spmm_rounds)
        # reverse arrows are fan-in ~1 per frontier node (a folder has
        # one parent), so the arrow emission runs at a fraction of the
        # userset emission; overflow just falls back to the looped path
        self.Ea = max(self.E // 4, 512)
        #: directions registered with the cost ledger
        self._cost_reg: set = set()

    # -- running a program --------------------------------------------------
    def run(self, direction: str, kern, t, a, inp, fixed: bool):
        """The packed int32 outputs of one fused lookup: ``kern`` the
        FrontierKernels whose steps run (kernels or plain twins), ``t``
        the FusedLookup's device tables, ``a`` the FrontierState (table
        argument tuples), ``inp`` the int32 input vector.  ``fixed``
        runs exactly K rounds with no host read, as a graph capture
        needs; else the rounds stop as the reference's ``while_loop``
        does (one host read a round)."""
        init, step, out = (
            (self._res_init, self._res_round, self._res_out)
            if direction == "res"
            else (self._subj_init, self._subj_round, self._subj_out)
        )
        s = init(t, inp)
        for _ in range(self.K):
            if not fixed and not bool(self._unconverged(s) & ~s[-1]):
                break
            s = step(kern, t, a, inp, s)
        return out(s)

    @staticmethod
    def _runs(kern, kind, args, keys):
        """(lo, ln) of the probe step over ``keys``.  On the CPU only the
        live keys are probed (at least one lane): a key < 0 has an empty
        run and the emission reads the runs in key order, so its rows
        are the same; on ``cuda`` every lane, as a graph needs."""
        if keys.device.type == "cpu":
            live = keys[keys >= 0]
            keys = live if live.numel() else keys[:1]
        return kern._runs_fn(kind, *args, keys)

    @staticmethod
    def _rowt(t, nodes, valid):
        """(type row, type) of ``nodes``: the type or -1, and as a row
        of the pruning tables (-1 → the tables' last, all-false row)."""
        ty = torch.where(valid, t.nt[torch.where(valid, nodes, 0)], -1)
        return torch.where(ty < 0, t.n_types, ty), ty

    @staticmethod
    def _unconverged(s):
        return (s[0] >= 0).any() | (s[1] >= 0).any()

    # -- reverse reachability: LookupResources -----------------------------
    # inp: int32[8] = seed keys [4], seed nodes [2], rtid, now

    def _res_init(self, t, inp):
        dev = inp.device
        meta = self.meta
        F, C = self.F, self.C
        seed_keys = inp[:_SEED_KEYS]
        seed_nodes = inp[_SEED_KEYS:_SEED_KEYS + _SEED_NODES]
        bm_k = _bitmap(meta.N * meta.S1, dev)
        _bm_mark(bm_k, seed_keys, seed_keys >= 0)
        bm_n = _bitmap(meta.N, dev)
        _bm_mark(bm_n, seed_nodes, seed_nodes >= 0)
        kf = torch.full((F,), -1, dtype=torch.int32, device=dev)
        kf[:_SEED_KEYS] = seed_keys
        nf = torch.full((F,), -1, dtype=torch.int32, device=dev)
        cand = torch.zeros(C + 1, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        no = torch.zeros((), dtype=torch.bool, device=dev)
        return kf, nf, bm_k, bm_n, cand, zero, no

    def _res_round(self, kern, t, a, inp, s):
        kf, nf, bm_k, bm_n, cand, ncand, ovf = s
        meta = self.meta
        N, S1 = meta.N, meta.S1
        logN = N.bit_length() - 1
        F, E, Ea, C = self.F, self.E, self.Ea, self.C
        rtid, now = inp[6], inp[7]
        # one masked SpMV over the reverse userset view: which (slot,
        # resource) rows grant the frontier keys
        lo, ln = self._runs(kern, "rv", a.rv_args, kf)
        rows, live = kern._emit_fn("rv", a.rv_args[2], a.rv_args[3], lo, ln,
                                   0, now, E)
        ovf = ovf | (ln.sum(dtype=torch.int64) > E)
        k1 = torch.where(live, rows[:, 1], 0)
        res = k1 & (N - 1)
        slotd = k1 >> logN
        nk = t.k2p1[slotd.clamp(0, t.k2p1.shape[0] - 1)]
        row_res, _ty = self._rowt(t, res, live)
        chain = live & (nk > 0) & t.chain_ok[row_res, nk]
        ckeys = torch.where(chain, res * S1 + nk, -1)
        # one masked SpMV over the reverse arrows: parents of the node
        # frontier
        lo2, ln2 = self._runs(kern, "ra", a.ra_args, nf)
        rows2, live2 = kern._emit_fn("ra", a.ra_args[2], a.ra_args[3], lo2,
                                     ln2, 0, now, Ea)
        ovf = ovf | (ln2.sum(dtype=torch.int64) > Ea)
        par = torch.where(live2, rows2[:, 1] & (N - 1), -1)
        # fresh nodes (⊕ short-circuit): candidates, arrow children,
        # permission-chain sources
        pool_n = torch.cat([torch.where(live, res, -1), par])
        xn, freshn = _fresh(pool_n, pool_n >= 0, bm_n)
        rown, tn = self._rowt(t, xn, freshn)
        ncand, o1 = _append(cand, ncand, xn, freshn & (tn == rtid), C)
        nf2, _cn, o2 = _compact(xn, freshn & t.child_ok[rown], F)
        ptab = t.perm_tab[rown]
        pkeys = torch.where(freshn[:, None] & (ptab > 0),
                            xn[:, None] * S1 + ptab, -1).reshape(-1)
        pool_k = torch.cat([ckeys, pkeys])
        xk, freshk = _fresh(pool_k, pool_k >= 0, bm_k)
        kf2, _ck, o3 = _compact(xk, freshk, F)
        return kf2, nf2, bm_k, bm_n, cand, ncand, ovf | o1 | o2 | o3

    def _res_out(self, s):
        """int32[C + 2]: ncand, overflow (or not converged), candidates."""
        ovf = s[-1] | self._unconverged(s)
        return torch.cat([s[5].view(1), ovf.view(1).to(torch.int32),
                          s[4][: self.C]])

    # -- forward reachability: LookupSubjects ------------------------------
    # inp: int32[6] = seed nodes [2], stid, srel_slot, wc_node, now

    def _subj_init(self, t, inp):
        dev = inp.device
        N = self.meta.N
        F, C = self.F, self.C
        seed_nodes = inp[:_SEED_NODES]
        bm_n = _bitmap(N, dev)
        _bm_mark(bm_n, seed_nodes, seed_nodes >= 0)
        nf = torch.full((F,), -1, dtype=torch.int32, device=dev)
        nf[:_SEED_NODES] = seed_nodes
        pf = torch.full((F,), -1, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        no = torch.zeros((), dtype=torch.bool, device=dev)
        return (
            nf, pf, bm_n, _bitmap(N * t.NSp, dev), _bitmap(N, dev),
            torch.zeros(C + 1, dtype=torch.int32, device=dev), zero,
            torch.zeros(C + 1, dtype=torch.int32, device=dev), zero, no, no,
        )

    def _subj_round(self, kern, t, a, inp, s):
        nf, pf, bm_n, bm_p, bm_c, cand, ncand, gsr, ngsr, wc, ovf = s
        N, S1 = self.meta.N, self.meta.S1
        F, E, C = self.F, self.E, self.C
        NSp, num_slots = t.NSp, t.NSp - 1
        stid, srel_slot, wc_node, now = inp[2], inp[3], inp[4], inp[5]
        valid_n = nf >= 0
        rown, _tn = self._rowt(t, nf, valid_n)
        # forward arrow hop (the argx range view: mode ``block``)
        children = torch.full((E,), -1, dtype=torch.int32, device=nf.device)
        if t.ts_k1d.shape[0]:
            tok = valid_n[:, None] & t.slot_ts[rown]
            akeys = torch.where(tok, nf[:, None] + t.ts_k1d[None, :] * N,
                                -1).reshape(-1)
            lo, ln = self._runs(kern, "arg", a.arg_args, akeys)
            rowsa, livea = kern._emit_fn("arg", a.arx[0], a.arx[1], lo, ln,
                                         0, now, E)
            ovf = ovf | (ln.sum(dtype=torch.int64) > E)
            children = torch.where(livea, rowsa[:, 0], -1)
        # forward edge hop: node keys + relation-pair keys in one masked
        # SpMV over the fw view
        valid_p = pf >= 0
        g = torch.where(valid_p, pf // NSp, 0)
        rr = torch.where(valid_p, pf % NSp, 0)
        rrc = rr.clamp(0, num_slots - 1)
        rowg, _tg = self._rowt(t, g, valid_p)
        is_perm = valid_p & t.perm_raw[rowg, rrc] & (rr < num_slots)
        kd = t.k1d[rrc]
        relm = valid_p & ~is_perm & (kd >= 0) & (rr < num_slots)
        fkeys = torch.where(relm, kd * N + g, -1)
        if t.e_k1d.shape[0]:
            eok = valid_n[:, None] & t.slot_e[rown]
            fkeys1 = torch.where(eok, nf[:, None] + t.e_k1d[None, :] * N,
                                 -1).reshape(-1)
            fkeys = torch.cat([fkeys1, fkeys])
        lo2, ln2 = self._runs(kern, "fw", a.fw_args, fkeys)
        rowsf, livef = kern._emit_fn("fw", a.fw_args[2], a.fw_args[3], lo2,
                                     ln2, 0, now, E)
        ovf = ovf | (ln2.sum(dtype=torch.int64) > E)
        k2v = torch.where(livef, rowsf[:, 1], 0)
        direct = livef & (k2v % S1 == 0)
        dn = k2v // S1
        wc = wc | (direct & (dn == wc_node) & (wc_node >= 0)).any()
        # direct subjects: candidates (deduped on the device)
        _rowd, td = self._rowt(t, dn, direct)
        cpool = torch.where(direct & (td == stid) & (srel_slot < 0), dn, -1)
        xc, freshc = _fresh(cpool, cpool >= 0, bm_c)
        ncand, o1 = _append(cand, ncand, xc, freshc, C)
        # userset subjects: raw (group, relation) pairs
        um = livef & ~direct
        r2 = t.k2p1_raw[torch.where(um, k2v % S1, 0)]
        pairc = torch.where(um & (r2 >= 0), (k2v // S1) * NSp + r2, -1)
        xp, freshp = _fresh(pairc, pairc >= 0, bm_p)
        pf2, _cp, o2 = _compact(xp, freshp, F)
        srm = freshp & (srel_slot >= 0) & (xp % NSp == srel_slot)
        ngsr, o3 = _append(gsr, ngsr, xp // NSp, srm, C)
        # next node frontier: arrow children + permission-pair sources
        # (holders of g#p ⊆ expansion of g)
        pool_n = torch.cat([children, torch.where(is_perm, g, -1)])
        xn, freshn = _fresh(pool_n, pool_n >= 0, bm_n)
        nf2, _cn, o4 = _compact(xn, freshn, F)
        return (nf2, pf2, bm_n, bm_p, bm_c, cand, ncand, gsr, ngsr, wc,
                ovf | o1 | o2 | o3 | o4)

    def _subj_out(self, s):
        """int32[2C + 4]: ncand, ngsr, wildcard seen, overflow (or not
        converged), candidates, userset groups."""
        ovf = s[-1] | self._unconverged(s)
        C = self.C
        return torch.cat([
            s[6].view(1), s[8].view(1), s[9].view(1).to(torch.int32),
            ovf.view(1).to(torch.int32), s[5][:C], s[7][:C],
        ])


def spmm_kernels_for(engine, meta) -> SpmmKernels:
    """Engine-level cache of the fused programs, keyed by meta (at most
    8, FIFO): geometry-identical snapshots share one SpmmKernels, each
    with its own graphs."""
    cache = engine.__dict__.setdefault("_spmm_kernels", {})
    k = cache.get(meta)
    if k is None:
        k = SpmmKernels(meta, engine.config)
        while len(cache) >= 8:
            cache.pop(next(iter(cache)))
        cache[meta] = k
    return k


# ---------------------------------------------------------------------------
# per-snapshot fused lookup server
# ---------------------------------------------------------------------------


def _graph_state(engine):
    """(lock, live servers holding graphs) of an engine.  Its fused
    graphs share memory pools, so a capture, or a replay and its
    read-back, holds the lock; a capture borrows the pool of a live
    server's graph."""
    got = engine.__dict__.get("_spmm_graphs")
    if got is None:
        got = engine.__dict__.setdefault(
            "_spmm_graphs", (threading.Lock(), weakref.WeakSet()))
    return got


def fused_ok(engine, st) -> bool:
    """Whether the fused K-hop path may serve this FrontierState.
    Sharded snapshots keep the looped hops; key/pair domains must fit
    int32 (the on-device bitmap codes)."""
    if not engine.config.spmm or st.meta.sharded:
        return False
    num_slots = max(st.snap.num_slots, 1)
    if st.N * st.S1 >= 1 << 31 or st.N * (num_slots + 1) >= 1 << 31:
        return False
    return True


class _Graph:
    """One captured fused program: its static input vector, the graph,
    its static packed output, and the kernel launches the capture
    recorded (per ``kernels.LAUNCHES`` key; a replay launches them
    again without counting)."""

    def __init__(self, inp, graph, out, modes) -> None:
        self.inp = inp
        self.graph = graph
        self.out = out
        self.modes = modes


class FusedLookup:
    """One snapshot's fused-lookup server: the device constant tables
    (type map, pruning masks, permission chains), the captured graphs
    (``cuda``), and the dispatch wrappers.  Built by spmv.FrontierState
    when ``fused_ok``; answers are complete candidate blocks from one
    dispatch, or ``None`` on overflow (the caller falls back to the
    looped path)."""

    def __init__(self, engine, st) -> None:
        self.engine = engine
        # the FrontierState holds this server (``st._spmm``): a strong
        # reference back would make a cycle, so a dropped snapshot's
        # graphs and their pool memory would wait for the cyclic GC
        self._st = weakref.ref(st)
        self.kern = spmm_kernels_for(engine, st.meta)
        self.device = dev = engine.device
        N, S1 = st.N, st.S1
        snap = st.snap

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        nt = np.full(N, -1, np.int32)
        nt[: snap.node_type.shape[0]] = snap.node_type.astype(np.int32)
        n_types = st.child_ok.shape[0] - 1
        # permission-userset chains only when the compiled schema has
        # any (the host gate: FrontierState.perm_chains)
        chains = st.perm_k2p1_of_tid if st.perm_chains else {}
        pmax = max([v.shape[0] for v in chains.values()] or [1])
        ptab = np.zeros((n_types + 1, pmax), np.int32)
        for ty, k2p1 in chains.items():
            ptab[ty, : k2p1.shape[0]] = k2p1.astype(np.int32)
        t = SimpleNamespace(
            n_types=n_types, nt=on(nt),
            k2p1=on(st.k2p1_of_k1d.astype(np.int32)),
            chain_ok=on(st.chain_ok), child_ok=on(st.child_ok),
            perm_tab=on(ptab),
        )
        self.subj_ready = bool(st.meta.has_fw)
        if self.subj_ready:
            num_slots = max(snap.num_slots, 1)
            e_raw = np.asarray(
                [s for s in st.meta.e_slots if st.k1d[s] >= 0], np.int64)
            ts_raw = np.asarray(
                [s for s in st.ts_slots if st.k1d[s] >= 0], np.int64)
            k2p1_raw = np.full(S1 + 1, -1, np.int32)
            for raw, d in enumerate(st.k2d):
                if d >= 0:
                    k2p1_raw[d + 1] = raw
            # pad the raw-slot → dense-k1 map to exactly num_slots so the
            # device pair encoding (g·(num_slots+1)+r) matches the host's
            k1p = np.full(num_slots, -1, np.int32)
            m = min(num_slots, st.k1d.shape[0])
            k1p[:m] = st.k1d[:m]
            perm_raw = np.vstack([
                st.perm_raw_table,
                np.zeros((1, st.perm_raw_table.shape[1]), bool)])
            t.NSp = num_slots + 1
            t.slot_e = on(st.slot_of_type[:, e_raw])
            t.e_k1d = on(st.k1d[e_raw].astype(np.int32))
            t.slot_ts = on(st.slot_of_type[:, ts_raw])
            t.ts_k1d = on(st.k1d[ts_raw].astype(np.int32))
            t.k2p1_raw = on(k2p1_raw)
            t.k1d = on(k1p)
            t.perm_raw = on(perm_raw)
        self.tables = t
        #: captured graphs by direction (``cuda`` only)
        self.graphs: Dict[str, _Graph] = {}
        #: graphs captured by this server, per direction, and the wall
        #: seconds of the last capture (its eager warm-up run included)
        self.captures = {"res": 0, "subj": 0}
        self.capture_s: Dict[str, float] = {}
        self._plain = None
        _ensure_report_section()

    @property
    def st(self):
        """The FrontierState this server belongs to (alive while it is
        served, since only that state holds the server)."""
        return self._st()

    # -- dispatch plumbing ------------------------------------------------
    def _plain_kern(self):
        """The snapshot's probe steps as plain twins (the parity run)."""
        if self._plain is None:
            from .spmv import FrontierKernels

            self._plain = FrontierKernels(self.st.meta, self.engine.config,
                                          kernels=False)
        return self._plain

    def _dispatch(self, direction: str, inp: np.ndarray, run: Optional[str],
                  plain: bool) -> np.ndarray:
        # a fused launch IS a lookup dispatch: both sites fire, so a
        # fault armed on either exercises this path under the envelope
        faults.fire("lookup.dispatch")
        faults.fire("spmm.dispatch")
        _mt.inc("spmm.dispatches")
        self._register_cost(direction)
        if run is None and not plain and self.device.type == "cuda":
            return self._replay(direction, inp)
        kern = self._plain_kern() if plain else self.st.kern
        with torch.no_grad():
            out = self.kern.run(
                direction, kern, self.tables, self.st,
                torch.from_numpy(inp).to(self.device), run == "rounds",
            )
        return out.cpu().numpy()

    def _replay(self, direction: str, inp: np.ndarray) -> np.ndarray:
        with _graph_state(self.engine)[0]:
            g = self.graphs.get(direction)
            if g is None:
                g = self._capture(direction, inp)
            else:
                g.inp.copy_(torch.from_numpy(inp))
            g.graph.replay()
            return g.out.cpu().numpy()

    def _capture(self, direction: str, inp: np.ndarray) -> _Graph:
        """Capture the K rounds over a static input vector holding
        ``inp``, following engine/latency.py: one eager run on a side
        stream builds the kernels and the device constants, then the
        capture records the program on that stream, into the memory pool
        of a live fused graph of this engine (held until the capture
        ends), else a new pool — a pool whose graphs are all gone cannot
        take another capture.  A capture that fails raises, ends its
        allocation to the pool, and leaves no graph, so the next
        dispatch captures anew."""
        dev = self.device
        t0 = time.perf_counter()
        _mt.inc("spmm.captures")
        self.captures[direction] += 1
        live = _graph_state(self.engine)[1]
        donor = next((f for f in list(live) if f.graphs), None)
        pool = (next(iter(donor.graphs.values())).graph.pool()
                if donor is not None else torch.cuda.graph_pool_handle())
        static = torch.from_numpy(inp).to(dev)

        def program():
            return self.kern.run(direction, self.st.kern, self.tables,
                                 self.st, static, True)

        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side), torch.no_grad():
                program()
                before = dict(_K.LAUNCHES)
                with recording():
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    err = None
                    try:
                        out = program()
                    except BaseException as e:  # the error to see
                        err = e
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        index = (torch.cuda.current_device()
                                 if dev.index is None else dev.index)
                        torch._C._cuda_endAllocateToPool(index, pool)
                        if err is None:
                            raise
                if err is not None:
                    raise err
            cur.wait_stream(side)
        finally:
            del donor
        modes = {k: v - before[k] for k, v in _K.LAUNCHES.items()
                 if v > before[k]}
        g = _Graph(static, graph, out, modes)
        self.graphs[direction] = g
        live.add(self)
        self.capture_s[direction] = time.perf_counter() - t0
        return g

    def _register_cost(self, direction: str) -> None:
        # per-SpmmKernels (= per-meta) guard, as on the spmv hop path
        if direction in self.kern._cost_reg:
            return
        self.kern._cost_reg.add(direction)
        from ..utils import perf as _perf

        kern = self.kern
        mh = f"{hash(self.st.meta) & 0xFFFFFFFF:08x}"
        _perf.register_cost_thunk(
            "spmm", f"fused-{direction};F={kern.F};E={kern.E};K={kern.K}"
            f";meta={mh}",
            lambda: {"direction": direction, "F": kern.F, "E": kern.E,
                     "C": kern.C, "K": kern.K, "meta": mh},
        )

    # -- LookupResources: the whole reverse fixpoint, one dispatch -------
    def resources_inputs(self, rtid: int, subj_node: int, srel_slot: int,
                         wc_node: int, now_us: Optional[int]) -> np.ndarray:
        """The program's int32[8] input vector: seed keys, seed nodes,
        resource type, clock."""
        st = self.st
        N, S1 = st.N, st.S1
        seeds: List[int] = []
        if 0 <= subj_node < N:
            if srel_slot < 0:
                seeds.append(subj_node * S1)
            elif st.k2d[srel_slot] >= 0:
                seeds.append(subj_node * S1 + int(st.k2d[srel_slot]) + 1)
        if 0 <= wc_node < N:
            seeds.append(wc_node * S1)
        inp = np.full(_SEED_KEYS + _SEED_NODES + 2, -1, np.int32)
        uniq = sorted(set(seeds))[:_SEED_KEYS]
        inp[: len(uniq)] = uniq
        if 0 <= subj_node < N:
            inp[_SEED_KEYS] = subj_node
        inp[-2] = rtid
        inp[-1] = st._now(now_us)
        return inp

    def resources(
        self, rtid: int, subj_node: int, srel_slot: int, wc_node: int,
        now_us: Optional[int], *, run: Optional[str] = None,
        plain: bool = False,
    ) -> Optional[List[np.ndarray]]:
        """The candidate blocks of one LookupResources, or None on
        overflow.  ``run`` None replays the graph on ``cuda`` and runs
        the early-exit loop eagerly on the CPU; "loop" and "rounds" (K
        fixed rounds) run eagerly anywhere; ``plain`` runs the probe
        steps' plain twins (eagerly)."""
        st = self.st
        out = self._dispatch(
            "res", self.resources_inputs(rtid, subj_node, srel_slot,
                                         wc_node, now_us), run, plain)
        if out[1]:
            return None
        blocks: List[np.ndarray] = []
        nt = st.snap.node_type
        if 0 <= subj_node < nt.shape[0] and int(nt[subj_node]) == rtid:
            blocks.append(np.asarray([subj_node], np.int64))
        arr = out[2: 2 + int(out[0])].astype(np.int64)
        if arr.size:
            blocks.append(arr)
        return blocks

    # -- LookupSubjects: the whole forward fixpoint, one dispatch --------
    def subjects_inputs(self, res_node: int, stid: int, srel_slot: int,
                        wc_node: int, now_us: Optional[int]) -> np.ndarray:
        """The program's int32[6] input vector: seed nodes, subject type,
        subject relation slot, wildcard node, clock."""
        inp = np.full(_SEED_NODES + 4, -1, np.int32)
        if 0 <= res_node < self.st.N:
            inp[0] = res_node
        inp[2:] = (stid, srel_slot, wc_node, self.st._now(now_us))
        return inp

    def subjects(
        self, res_node: int, stid: int, srel_slot: int, wc_node: int,
        now_us: Optional[int], *, run: Optional[str] = None,
        plain: bool = False,
    ) -> Optional[List[np.ndarray]]:
        """The candidate blocks of one LookupSubjects, or None on
        overflow (``run`` and ``plain`` as for ``resources``)."""
        if not self.subj_ready:
            return None
        st = self.st
        C = self.kern.C
        out = self._dispatch(
            "subj", self.subjects_inputs(res_node, stid, srel_slot, wc_node,
                                         now_us), run, plain)
        ncand, ngsr, wc, ovf = (int(x) for x in out[:4])
        if ovf:
            return None
        blocks: List[np.ndarray] = []
        emitted: set = set()
        arr = out[4: 4 + ncand].astype(np.int64)
        if arr.size:
            blocks.append(arr)
            emitted.update(int(x) for x in arr)
        # trailing blocks, mirroring the walker/looped tail order
        nt = st.snap.node_type
        if srel_slot >= 0 and ngsr:
            gs = np.unique(out[4 + C: 4 + C + ngsr].astype(np.int64))
            gs = gs[(gs >= 0) & (gs < nt.shape[0])]
            gs = gs[nt[gs] == stid]
            gs = np.asarray([g for g in gs if int(g) not in emitted], np.int64)
            if gs.size:
                blocks.append(gs)
                emitted.update(int(x) for x in gs)
        if (
            0 <= res_node < nt.shape[0]
            and int(nt[res_node]) == stid
            and res_node not in emitted
        ):
            blocks.append(np.asarray([res_node], np.int64))
            emitted.add(res_node)
        if wc and srel_slot < 0:
            subs = st.all_subjects()
            subs = subs[(subs >= 0) & (subs < nt.shape[0])]
            subs = subs[nt[subs] == stid]
            subs = np.asarray(
                [s for s in subs if int(s) not in emitted], np.int64)
            if subs.size:
                blocks.append(subs)
        return blocks


def fused_for(engine, st) -> Optional[FusedLookup]:
    """The FrontierState's fused server, or None when ineligible — the
    single construction gate spmv.py calls."""
    if not fused_ok(engine, st):
        return None
    return FusedLookup(engine, st)


# ---------------------------------------------------------------------------
# /perf visibility
# ---------------------------------------------------------------------------

_SECTION = [False]


def _ensure_report_section() -> None:
    """Ride the /perf payload (utils/perf.py report sections) with the
    fused core's serving counters — dispatches against fallbacks is the
    fused-coverage ratio."""
    if _SECTION[0]:
        return
    _SECTION[0] = True
    from ..utils import perf as _perf

    def stats():
        return {
            "dispatches": _mt.counter("spmm.dispatches"),
            "fallbacks": _mt.counter("spmm.fallbacks"),
            "captures": _mt.counter("spmm.captures"),
            "lookup_dispatches_looped": _mt.counter("lookup.dispatches"),
        }

    _perf.register_report_section("spmm", stats)
