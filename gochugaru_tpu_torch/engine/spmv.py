"""Masked frontier SpMV: LookupResources/LookupSubjects on the device.

The host walker (engine/lookup.py) answers the inverse-of-Check
questions by sorting transposed O(E) views on the host and running a
numpy worklist.  This module serves them from the reverse-CSR tables
built alongside the forward layout (engine/rev.py), the GraphBLAS push
idiom (RedisGraph, arXiv:1905.01294):

- the frontier is a set of packed keys (k2 = (subject, srel1) for
  reverse reachability; k1 = (slot, resource) forward; child nodes for
  arrow traversal);
- one hop = one probe (hash bucket + in-bucket bisect finds each key's
  contiguous run: the ``runs`` mode of the fused probe kernel,
  engine/kernels) + budgeted emission (a fixed-shape chunk of matching
  rows per step, whatever the fan-out — the SpMV "gather" with the
  frontier as the mask);
- caveats/expirations filter the frontier IN the emission via the same
  packed decode layer the Check kernel uses (engine/packed.py
  decode_block): an expired edge, or a caveated edge with no stored
  context, never leaves the device;
- the host only dedups (bitmap seen-sets), applies the schema-level
  worklist rules (membership-chain keys, permission-userset chains,
  wildcard handling — mirroring the walker's superset discipline), and
  streams candidate blocks to the exact filter.

Candidates stream in DETERMINISTIC discovery order (device steps are
deterministic, host dedup is order-stable), which is what makes the
cursor contract exact: a ``LookupCursor`` pins (revision, query
fingerprint, results emitted) and a resume either continues the cached
live stream or deterministically recomputes and skips.

This is the reference's looped per-hop path (``EngineConfig(spmm=
False)`` in gochugaru_tpu/engine/spmv.py), with the device steps in
PyTorch: the hop probes go through ``kernels.fused_probe`` (mode
``runs``; the arrow group probe through mode ``block``, or
``kernels.fused_probe_aligned`` mode ``block`` when ``argx`` is
bucket-aligned), the CUDA kernels on a CUDA device and their plain twins
on the CPU or with ``EngineConfig(kernels=False)``.  The reverse tables
(rvx/rax/fwx) are never aligned.  The fused K-hop SpMM program and the
sharded layouts are later slices.

Eligibility: full prepares with the reverse index (FlatMeta.has_rev)
and no LSM delta level; everything else keeps the host walker.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import faults, metrics
from . import kernels as _K
from .flat import aligned_levels
from .hash import _ceil_pow2
from .packed import decode_block

_mt = metrics.default

#: continuation cache per DeviceSnapshot (live candidate streams keyed
#: by cursor token; LRU — an evicted stream resumes by deterministic
#: recompute-and-skip)
_STREAM_CACHE_MAX = 16

#: per-dispatch row budget of the frontier emission: each hop emits
#: matches in chunks of at most this many rows (the reference's
#: ``EngineConfig.lookup_chunk`` default)
LOOKUP_CHUNK = 65_536
#: frontier-key padding floor, pow2 tiers above it (the reference's
#: ``EngineConfig.lookup_frontier_min`` default)
LOOKUP_FRONTIER_MIN = 1_024


# ---------------------------------------------------------------------------
# cursors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LookupCursor:
    """Revision-pinned resumable position in one lookup's result stream.

    ``pos`` counts RESULTS already emitted (not candidates): the stream
    is deterministic per (snapshot revision, query, evaluation time), so
    skipping ``pos`` results reproduces the exact continuation even with
    no server-side state.  ``now_us`` pins that evaluation time: a
    caller who never passed one gets wall clock resolved ONCE at stream
    creation — a recompute-resume at a later wall clock would otherwise
    re-evaluate expiry gates and silently lose/duplicate IDs."""

    revision: int
    token: str  # query fingerprint — a cursor never resumes a different query
    pos: int
    now_us: Optional[int] = None

    def encode(self) -> str:
        raw = json.dumps(
            {"r": self.revision, "t": self.token, "p": self.pos,
             "n": self.now_us},
            separators=(",", ":"),
        ).encode()
        return base64.urlsafe_b64encode(raw).decode()

    @staticmethod
    def decode(s: str) -> "LookupCursor":
        from ..utils.errors import PreconditionFailedError

        try:
            d = json.loads(base64.urlsafe_b64decode(s.encode()))
            n = d.get("n")
            return LookupCursor(
                int(d["r"]), str(d["t"]), int(d["p"]),
                int(n) if n is not None else None,
            )
        except Exception as e:
            raise PreconditionFailedError(f"malformed lookup cursor: {e}")


def query_token(*parts) -> str:
    """Stable query fingerprint for cursor validation."""
    import hashlib

    h = hashlib.sha1("\x1f".join(str(p) for p in parts).encode()).hexdigest()
    return h[:16]


def resolve_now_us(cursor: Optional["LookupCursor"],
                   now_us: Optional[int]) -> int:
    """The lookup's pinned evaluation time: an explicit ``now_us`` wins,
    a resuming cursor reuses the one its stream was created with, and a
    fresh implicit-time lookup resolves wall clock ONCE — so
    recompute-resumes re-evaluate expiry/caveat gates at the SAME
    instant and the no-dup/no-loss contract holds."""
    import time as _time

    if now_us is not None:
        return int(now_us)
    if cursor is not None and cursor.now_us is not None:
        return int(cursor.now_us)
    return int(_time.time() * 1_000_000)


# ---------------------------------------------------------------------------
# host-side seen-sets (bitmaps; order-stable dedup)
# ---------------------------------------------------------------------------


class _Seen:
    """Bitmap over a dense int domain; ``fresh`` returns the sorted
    unique not-yet-seen subset and marks it."""

    def __init__(self, domain: int) -> None:
        self._bm = np.zeros((max(domain, 1) + 7) >> 3, np.uint8)

    def fresh(self, ids: np.ndarray) -> np.ndarray:
        if ids.size == 0:
            return ids.astype(np.int64)
        ids = np.unique(ids.astype(np.int64))
        byte = ids >> 3
        bit = (1 << (ids & 7)).astype(np.uint8)
        take = (self._bm[byte] & bit) == 0
        ids, byte, bit = ids[take], byte[take], bit[take]
        if ids.size:
            # two fresh ids can share a byte: sorted ids put them in one
            # run — OR-reduce per distinct byte, then one plain scatter
            # (np.bitwise_or.at is ~50x slower than this at volume)
            ub, first = np.unique(byte, return_index=True)
            self._bm[ub] |= np.bitwise_or.reduceat(bit, first)
        return ids


#: bitmap byte budget per seen-set — worlds whose key domain would need
#: more fall back to the host walker
_SEEN_BUDGET_BYTES = 1 << 27


# ---------------------------------------------------------------------------
# device steps (per-FlatMeta, cached on the engine)
# ---------------------------------------------------------------------------


class FrontierKernels:
    """The probe/emit steps of one FlatMeta geometry (cached on the
    engine keyed by meta).  ``kernels`` is the engine's switch: True
    launches the CUDA kernel for every probe, False runs its plain
    twin."""

    def __init__(self, meta, kernels: bool = False) -> None:
        if meta.sharded:
            raise NotImplementedError(
                "lookups over sharded tables are a later slice"
            )
        self.meta = meta
        self.kernels = bool(kernels)
        self.CH = LOOKUP_CHUNK
        self.F_min = LOOKUP_FRONTIER_MIN
        self._pk = dict(meta.packed)
        self._pko = dict(meta.packed_off)
        #: (w, caps) of the aligned argx ladder, None when off+interleave
        self._arg_al = dict((k, (w, c)) for k, w, c in meta.aligned).get("argx")
        #: kind → (rows table, offsets array, bisect cap) of the run probes
        self._run_geom = {
            "rv": ("rvx", "rv_off", meta.rv_cap),
            "ra": ("rax", "ra_off", meta.ra_cap),
        }
        #: kind → (rows table, gate column, hascav, hasexp) of the emits
        self._emit_geom = {
            "rv": ("rvx", 2, meta.e_hascav, meta.e_hasexp),
            "ra": ("rax", 2, meta.ar_hascav, meta.ar_hasexp),
            "arg": ("arx", 1, meta.ar_hascav, meta.ar_hasexp),
        }
        if meta.has_fw:
            self._run_geom["fw"] = ("fwx", "fw_off", meta.fw_cap)
            self._emit_geom["fw"] = ("fwx", 2, meta.e_hascav, meta.e_hasexp)
        # probe + FIRST emission chunk per hop: most hops emit fewer than
        # CH0 rows, so the common case is one probe, one emit and one
        # fetch per hop; the chunk order is the reference's
        self.CH0 = min(4096, self.CH)
        #: (kind, padded frontier) shapes the cost ledger already holds
        self._cost_reg: set = set()

    # -- point-run probe: hash bucket + in-bucket bisect ------------------
    def _runs_fn(self, kind: str, off, off_a, tbl, spec_dev, keys):
        """(lo, ln) int32[F] per padded key: the ``runs`` probe, or for
        ``arg`` the group-table range probe over argx."""
        if kind == "arg":
            return self._runs_group(off, off_a, tbl, spec_dev, keys)
        tbl_key, off_key, cap = self._run_geom[kind]
        shift = self._pko.get(off_key)
        return _K.fused_probe(
            (keys,), off, tbl, cap=cap, spec=self._pk.get(tbl_key),
            spec_dev=spec_dev, off_a=off_a if shift is not None else None,
            ashift=shift, mode="runs", plain=not self.kernels,
        )

    # -- group-table probe (argx range view: hash probe or aligned ladder)
    def _runs_group(self, off, off_a, gx, spec_dev, keys):
        """``gx`` is the argx rows table, or the tuple of its aligned
        levels (``off``/``off_a`` unused then)."""
        spec = self._pk.get("argx")
        if self._arg_al is not None:
            w, caps = self._arg_al
            blk = _K.fused_probe_aligned(
                (keys,), gx, caps, w if spec is None else spec[1], spec=spec,
                spec_dev=spec_dev, mode="block", plain=not self.kernels,
            )
        else:
            shift = self._pko.get("arr_off")
            blk = _K.fused_probe(
                (keys,), off, gx, cap=self.meta.arr_cap, spec=spec,
                spec_dev=spec_dev, off_a=off_a if shift is not None else None,
                ashift=shift, mode="block", plain=not self.kernels,
            )
        hit = (blk[..., 0] == keys[..., None]) & (keys >= 0)[..., None]
        lo = torch.where(hit, blk[..., 1], 0).sum(-1, dtype=torch.int32)
        hi = torch.where(hit, blk[..., 2], 0).sum(-1, dtype=torch.int32)
        return lo, hi - lo

    # -- budgeted emission: one fixed-shape chunk of matching rows --------
    def _emit_fn(self, kind: str, tbl, spec_dev, lo, ln, chunk0: int,
                 now: int, CH: int):
        """(rows int32[CH, w], live bool[CH]): slots ``chunk0 ..
        chunk0 + CH`` of the concatenated runs, decoded and gated."""
        tbl_key, gate_at, hascav, hasexp = self._emit_geom[kind]
        spec = self._pk.get(tbl_key)
        dev = lo.device
        F = int(lo.shape[0])
        ln64 = ln.to(torch.int64)
        cum = torch.cumsum(ln64, 0)
        cumstart = cum - ln64
        total = cum[F - 1] if F else torch.zeros((), dtype=torch.int64,
                                                 device=dev)
        pos = chunk0 + torch.arange(CH, dtype=torch.int64, device=dev)
        valid = pos < total
        # key index per slot: scatter each in-window run start (runs are
        # disjoint, nonzero runs have unique starts) into a CH+1 buffer
        # whose last slot takes the out-of-window ones, then a running
        # max — O(F + CH), no per-slot binary search
        fi = torch.arange(F, dtype=torch.int64, device=dev)
        rel = cumstart - chunk0
        inw = (rel > 0) & (rel < CH) & (ln64 > 0)
        sidx = torch.where(inw, rel, CH)
        marks = torch.full((CH + 1,), -1, dtype=torch.int64, device=dev)
        marks.scatter_reduce_(0, sidx, fi, "amax")
        marks = marks[:CH]
        base = torch.where((ln64 > 0) & (cumstart <= chunk0), fi, -1).amax()
        marks[0] = torch.maximum(marks[0], base)
        ki = torch.cummax(marks, 0).values
        kic = ki.clamp(0, max(F - 1, 0))
        ok = valid & (ki >= 0)
        ridx = lo.to(torch.int64)[kic] + pos - cumstart[kic]
        ridx = torch.where(ok, ridx, 0)
        raw = tbl[ridx]
        rows = raw if spec is None else decode_block(raw, spec)
        live = ok
        if hasexp:
            exp = rows[..., gate_at + (2 if hascav else 0)]
            live = live & ((exp == 0) | (exp > now))
        if hascav:
            # a caveated edge with stored context can still be DEFINITE
            # (the CEL VM resolves it); only the conditional-by-
            # construction case (no stored context — lookups carry no
            # request context) filters here
            cav = rows[..., gate_at]
            ctx = rows[..., gate_at + 1]
            live = live & ((cav == 0) | (ctx >= 0))
        return rows, live

    def _register_cost(self, kind: str, F: int) -> None:
        """Lazy cost-ledger registration of one frontier probe shape
        (realized only on explicit demand); the per-kernels set makes
        the steady-state hop path one local set lookup."""
        if (kind, F) in self._cost_reg:
            return
        self._cost_reg.add((kind, F))
        from ..utils import perf as _perf

        mh = f"{hash(self.meta) & 0xFFFFFFFF:08x}"
        _perf.register_cost_thunk(
            "spmv", f"{kind};F={F};meta={mh}",
            lambda kind=kind, F=F, mh=mh, k=self.kernels: {
                "probe": kind, "F": F, "meta": mh, "kernels": k},
        )

    # -- host-callable wrappers ------------------------------------------
    def pad_keys(self, keys: np.ndarray) -> np.ndarray:
        F = _ceil_pow2(max(keys.shape[0], 1), self.F_min)
        out = np.full(F, -1, np.int32)
        out[: keys.shape[0]] = keys
        return out

    def _keys_on(self, keys: np.ndarray, device) -> torch.Tensor:
        return torch.from_numpy(self.pad_keys(keys)).to(device)

    def runs(self, kind: str, args: Tuple, keys: np.ndarray):
        """(lo, ln, total): device runs + host total for padded keys.
        ``args`` is (off, off_a, tbl, tbl's device spec)."""
        faults.fire("lookup.dispatch")
        _mt.inc("lookup.dispatches")
        off, off_a, tbl, spec_dev = args
        dev = (tbl[0] if isinstance(tbl, tuple) else tbl).device
        kp = self._keys_on(keys, dev)
        self._register_cost(kind, int(kp.shape[0]))
        lo, ln = self._runs_fn(kind, off, off_a, tbl, spec_dev, kp)
        total = int(ln.to(torch.int64).sum())
        return lo, ln, total

    def emit(self, kind: str, tbl, lo, ln, chunk0: int, now,
             ch: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One emission chunk fetched to the host.  ``tbl`` is (rows
        table, its device spec)."""
        _mt.inc("lookup.dispatches")
        rows, live = self._emit_fn(kind, tbl[0], tbl[1], lo, ln, int(chunk0),
                                   int(now), ch or self.CH)
        return rows.cpu().numpy(), live.cpu().numpy()

    def _tier(self, n: int) -> int:
        return min(_ceil_pow2(max(n, 1), 256), self.CH)

    def expand(self, kind: str, args: Tuple, tbl, keys: np.ndarray, now):
        """Full budgeted expansion of ``keys`` over one view: yields
        (rows int32[n, w], already live-filtered) per chunk.  ``args``
        is the probe argument tuple; ``tbl`` the (rows table, spec) the
        emission gathers from."""
        if keys.shape[0] == 0:
            return
        _mt.inc("lookup.hops")
        # the hop: probe + the first CH0-row chunk, then pow2 chunk
        # tiers — the reference's block order
        faults.fire("lookup.dispatch")
        _mt.inc("lookup.dispatches")
        off, off_a, ptbl, spec_dev = args
        kp = self._keys_on(keys, off.device)
        self._register_cost(f"hop:{kind}", int(kp.shape[0]))
        lo, ln = self._runs_fn(kind, off, off_a, ptbl, spec_dev, kp)
        rows, live = self._emit_fn(kind, tbl[0], tbl[1], lo, ln, 0, int(now),
                                   self.CH0)
        total = int(ln.to(torch.int64).sum())
        rows, live = rows.cpu().numpy(), live.cpu().numpy()
        yield rows[live]
        at = self.CH0
        while at < total:
            ch = self._tier(total - at)
            rows, live = self.emit(kind, tbl, lo, ln, at, now, ch)
            yield rows[live]
            at += ch


def kernels_for(engine, meta) -> FrontierKernels:
    cache = engine.__dict__.setdefault("_spmv_kernels", {})
    k = cache.get(meta)
    if k is None:
        k = FrontierKernels(meta, engine.kernels)
        while len(cache) >= 8:
            cache.pop(next(iter(cache)))
        cache[meta] = k
    return k


# ---------------------------------------------------------------------------
# per-snapshot frontier state (dense maps, table arg tuples)
# ---------------------------------------------------------------------------


def frontier_static_ok(meta, snap) -> bool:
    """The STATIC half of frontier eligibility — reverse index present
    and the seen-set bitmap domains fit budget.  Shared with the
    prewarm decision (engine/device.py): a snapshot failing this always
    walker-serves, so it wants the background transposed-index build."""
    if meta is None or not meta.has_rev:
        return False
    NS1 = meta.N * meta.S1
    NSr = meta.N * (max(snap.num_slots, 1) + 1)  # raw pair bitmap domain
    return max(NS1, NSr) <= _SEEN_BUDGET_BYTES * 8


def frontier_ok(engine, dsnap) -> bool:
    """Device frontier eligibility: the static half plus the
    per-revision conditions — no LSM delta level riding, and sharded
    snapshots only when the engine has an owner-routed hop path (the
    port's has none yet, so they keep the walker)."""
    meta = dsnap.flat_meta
    if not frontier_static_ok(meta, dsnap.snapshot):
        return False
    if meta.delta is not None:
        return False
    if meta.sharded and not hasattr(engine, "lookup_hops_for"):
        return False
    return True


class FrontierState:
    """Per-DeviceSnapshot lookup server: dense slot maps, device table
    argument tuples, and the candidate-stream generators (cached on the
    snapshot via ``state_for``)."""

    def __init__(self, engine, dsnap) -> None:
        self.engine = engine
        self.dsnap = dsnap
        self.meta = meta = dsnap.flat_meta
        self.kern = kernels_for(engine, meta)
        self.snap = snap = dsnap.snapshot
        self.N = meta.N
        self.S1 = meta.S1
        self.logN = self.N.bit_length() - 1
        from .flat import _dense_np

        self.k1d = _dense_np(meta.k1_dense)  # raw slot → dense k1 (-1 = none)
        self.k2d = _dense_np(meta.k2_dense)
        n_k1 = int(self.k1d.max()) + 1 if self.k1d.size else 0
        self.k1_raw = np.full(max(n_k1, 1), -1, np.int32)
        for raw, d in enumerate(self.k1d):
            if d >= 0:
                self.k1_raw[d] = raw
        # dense k1 slot → (dense k2 of the same raw slot) + 1; 0 = the
        # relation is never a userset target, so no membership-chain key
        self.k2p1_of_k1d = np.zeros(max(n_k1, 1), np.int64)
        for d in range(n_k1):
            raw = self.k1_raw[d]
            if raw >= 0 and self.k2d[raw] >= 0:
                self.k2p1_of_k1d[d] = int(self.k2d[raw]) + 1
        # -- schema-level type-safety pruning (the big frontier lever) --
        # a userset (t, r) can only ever BE a subject where the schema
        # declares ``t#r`` as an allowed subject form, and a node can
        # only be an arrow CHILD if its type is a declared direct
        # subject of some tupleset relation — so chain keys / reverse-
        # arrow probes for other (type, slot) combinations are
        # structurally dead and never reach the device.  Without this a
        # 100k-candidate hop probes 100k impossible keys (Zanzibar's
        # type safety, applied as frontier pruning)
        compiled = snap.compiled
        interner = snap.interner
        num_slots = max(compiled.num_slots, 1)
        n_types = max(interner.num_types, 1)
        self.chain_ok = np.zeros((n_types + 1, self.S1 + 1), bool)
        self.child_ok = np.zeros(n_types + 1, bool)
        self.slot_of_type = np.zeros((n_types + 1, num_slots), bool)
        tname_of_tid = {tid: t for t, tid in compiled.type_ids.items()}
        for tname, tid in compiled.type_ids.items():
            itid = interner.type_lookup(tname)
            ct = compiled.types[tid]
            if itid >= 0:
                self.slot_of_type[itid, sorted(ct.relations)] = True
            for slot, relation in ct.relations.items():
                is_ts = slot in compiled.tupleset_slots
                for a in relation.allowed:
                    a_itid = interner.type_lookup(tname_of_tid[a.type_id])
                    if a_itid < 0:
                        continue
                    if a.relation_slot >= 0:
                        d = self.k2d[a.relation_slot]
                        if d >= 0:
                            self.chain_ok[a_itid, d + 1] = True
                    elif is_ts:
                        self.child_ok[a_itid] = True
        # permission slots per interner type id, dense-k2 + declared-
        # subject-form filtered (the permission-userset chain)
        self.perm_chains = bool(compiled.has_permission_usersets)
        self.perm_k2p1_of_tid: Dict[int, np.ndarray] = {}
        tbl = np.zeros((n_types, num_slots), bool)
        for tname, d in compiled.schema.definitions.items():
            itid = interner.type_lookup(tname)
            if itid < 0:
                continue
            slots = sorted(compiled.slot_of_name[p] for p in d.permissions)
            if slots:
                tbl[itid, slots] = True
                k2p1 = np.asarray(
                    [self.k2d[s] + 1 for s in slots
                     if self.k2d[s] >= 0
                     and self.chain_ok[itid, self.k2d[s] + 1]],
                    np.int64,
                )
                if k2p1.size:
                    self.perm_k2p1_of_tid[itid] = k2p1
        self.perm_raw_table = tbl
        self.ts_slots = sorted(compiled.tupleset_slots)
        arrs = dsnap.arrays
        dummy = torch.zeros(1, dtype=torch.int32, device=engine.device)

        def args_of(off_key, tbl_key):
            # (off, anchors or a dummy, rows table, its device decode spec)
            return (arrs[off_key], arrs.get(off_key + "_a", dummy),
                    arrs[tbl_key], dsnap.specs.get(tbl_key))

        self.rv_args = args_of("rv_off", "rvx")
        self.ra_args = args_of("ra_off", "rax")
        self.fw_args = args_of("fw_off", "fwx") if meta.has_fw else None
        if self.kern._arg_al is not None:
            # the aligned argx ladder: its level tables stand in the rows
            # table's place, and no offsets are read
            self.arg_args = (
                None, None,
                tuple(aligned_levels(arrs, "argx", self.kern._arg_al[1])),
                dsnap.specs.get("argx"),
            )
        else:
            self.arg_args = args_of("arr_off", "argx")
        self.arx = (arrs["arx"], dsnap.specs.get("arx"))
        #: wildcard-widening cache: sorted unique direct subjects
        self._all_subj: Optional[np.ndarray] = None

    # -- expansion primitives --------------------------------------------
    def _now(self, now_us) -> int:
        return int(self.snap.now_rel32(now_us))

    def expand_rv(self, keys: np.ndarray, now):
        return self.kern.expand("rv", self.rv_args, self.rv_args[2:],
                                keys, now)

    def expand_ra(self, keys: np.ndarray, now):
        return self.kern.expand("ra", self.ra_args, self.ra_args[2:],
                                keys, now)

    def expand_fw(self, keys: np.ndarray, now):
        return self.kern.expand("fw", self.fw_args, self.fw_args[2:],
                                keys, now)

    def expand_arrows_fwd(self, keys: np.ndarray, now):
        """Forward tupleset traversal over the EXISTING argx/arx view."""
        if keys.shape[0] == 0:
            return iter(())
        lo, ln, total = self.kern.runs("arg", self.arg_args, keys)
        _mt.inc("lookup.hops")

        def gen():
            at = 0
            while at < total:
                rows, live = self.kern.emit("arg", self.arx, lo, ln, at, now)
                yield rows[live]
                at += self.kern.CH

        return gen()

    def node_type_of(self, nodes: np.ndarray) -> np.ndarray:
        nt = self.snap.node_type
        out = np.full(nodes.shape[0], -1, np.int64)
        ok = (nodes >= 0) & (nodes < nt.shape[0])
        out[ok] = nt[nodes[ok]]
        return out

    def all_subjects(self) -> np.ndarray:
        if self._all_subj is None:
            self._all_subj = np.unique(self.snap.e_subj).astype(np.int64)
        return self._all_subj

    # -- LookupResources candidate stream --------------------------------
    def resource_candidates(
        self, rtid: int, subj_node: int, srel_slot: int, wc_node: int,
        now_us: Optional[int],
    ) -> Iterator[np.ndarray]:
        """Deterministic stream of candidate resource-node blocks — the
        walker's reverse worklist, each hop one masked SpMV over the
        reverse tables.  Soundness: every DEFINITE grant has a live,
        resolvable positive edge path; the in-kernel gate filter drops
        only edges that can never be part of one."""
        N, S1, logN = self.N, self.S1, self.logN
        now = self._now(now_us)
        seen_keys = _Seen(N * S1)
        seen_nodes = _Seen(N)
        nt_shape = self.snap.node_type.shape[0]

        seeds: List[np.ndarray] = []
        if 0 <= subj_node < N:
            if srel_slot < 0:
                seeds.append(np.asarray([subj_node * S1], np.int64))
            elif self.k2d[srel_slot] >= 0:
                seeds.append(np.asarray(
                    [subj_node * S1 + int(self.k2d[srel_slot]) + 1], np.int64
                ))
        if 0 <= wc_node < N:
            seeds.append(np.asarray([wc_node * S1], np.int64))
        # self-identity: the subject node itself may be the resource
        first_nodes = (
            np.asarray([subj_node], np.int64)
            if 0 <= subj_node < nt_shape else np.empty(0, np.int64)
        )
        first_nodes = seen_nodes.fresh(first_nodes)
        if first_nodes.size:
            cand = first_nodes[self.node_type_of(first_nodes) == rtid]
            if cand.size:
                _mt.inc("lookup.candidates", cand.size)
                yield cand
        frontier = seen_keys.fresh(
            np.concatenate(seeds) if seeds else np.empty(0, np.int64)
        )
        while frontier.size:
            new_keys: List[np.ndarray] = []
            node_parts: List[np.ndarray] = []
            for rows in self.expand_rv(frontier.astype(np.int32), now):
                if rows.shape[0] == 0:
                    continue
                k1 = rows[:, 1].astype(np.int64)
                res = k1 & (N - 1)
                slotd = k1 >> logN
                node_parts.append(res)
                # granted usersets continue the membership chain — only
                # where the schema declares (type(res), rel) a legal
                # subject form (type-safety pruning: everything else is
                # structurally dead and never probes)
                nk = self.k2p1_of_k1d[slotd]
                chain = (nk > 0) & self.chain_ok[
                    self.node_type_of(res), np.maximum(nk, 0)
                ]
                if chain.any():
                    new_keys.append(res[chain] * S1 + nk[chain])
            nodes = seen_nodes.fresh(
                np.concatenate(node_parts)
                if node_parts else np.empty(0, np.int64)
            )
            # close candidates under reverse arrows (parents granting
            # through tupleset traversal) — device hops over rax
            while nodes.size:
                cand = nodes[self.node_type_of(nodes) == rtid]
                if cand.size:
                    _mt.inc("lookup.candidates", cand.size)
                    yield cand
                if self.perm_chains:
                    tids = self.node_type_of(nodes)
                    for t in np.unique(tids):
                        k2p1 = self.perm_k2p1_of_tid.get(int(t))
                        if k2p1 is None:
                            continue
                        nn = nodes[tids == t]
                        new_keys.append(
                            (nn[:, None] * S1 + k2p1[None, :]).ravel()
                        )
                # only declared arrow-child types can have parents
                ch = nodes[self.child_ok[self.node_type_of(nodes)]]
                parent_parts = [
                    rows[:, 1].astype(np.int64) & (N - 1)
                    for rows in self.expand_ra(ch.astype(np.int32), now)
                    if rows.shape[0]
                ]
                nodes = seen_nodes.fresh(
                    np.concatenate(parent_parts)
                    if parent_parts else np.empty(0, np.int64)
                )
            frontier = seen_keys.fresh(
                np.concatenate(new_keys)
                if new_keys else np.empty(0, np.int64)
            )

    # -- LookupSubjects candidate stream ---------------------------------
    def subject_candidates(
        self, res_node: int, stid: int, srel_slot: int, wc_node: int,
        now_us: Optional[int],
    ) -> Iterator[np.ndarray]:
        """Forward frontier expansion from the resource over the fw/argx
        views — the walker's node/pair worklist as device hops."""
        N, S1, logN = self.N, self.S1, self.logN
        snap = self.snap
        num_slots = max(snap.num_slots, 1)
        now = self._now(now_us)
        seen_nodes = _Seen(N)
        seen_pairs = _Seen(N * (num_slots + 1))
        seen_cand = _Seen(N)
        pair_list: List[np.ndarray] = []  # raw (g·NS + r) pairs, for srel
        wildcard_found = [False]
        # dense k2 value+1 → raw slot (decoding emitted userset subjects)
        k2p1_raw = np.full(S1 + 1, -1, np.int64)
        for raw, d in enumerate(self.k2d):
            if d >= 0:
                k2p1_raw[d + 1] = raw
        e_slot_raw = np.asarray(
            [s for s in self.meta.e_slots if self.k1d[s] >= 0], np.int64
        )
        e_slot_k1d = self.k1d[e_slot_raw].astype(np.int64)
        ts_raw = np.asarray(
            [s for s in self.ts_slots if self.k1d[s] >= 0], np.int64
        )
        ts_k1d = self.k1d[ts_raw].astype(np.int64)

        def absorb(k2vals: np.ndarray):
            """Emitted subject keys → (direct candidate block or None,
            new raw pairs)."""
            direct = k2vals % S1 == 0
            dn = k2vals[direct] // S1
            cand = None
            if srel_slot < 0 and dn.size:
                fresh = seen_cand.fresh(dn[self.node_type_of(dn) == stid])
                cand = fresh if fresh.size else None
            if (
                wc_node >= 0 and not wildcard_found[0]
                and dn.size and bool(np.any(dn == wc_node))
            ):
                wildcard_found[0] = True
            um = ~direct
            g = k2vals[um] // S1
            r = k2p1_raw[k2vals[um] % S1]
            pairs = g * (num_slots + 1) + r  # r ≥ 0: emitted userset rows
            return cand, pairs

        def fw_keys_of_nodes(nodes: np.ndarray) -> np.ndarray:
            if nodes.size == 0 or e_slot_k1d.size == 0:
                return np.empty(0, np.int64)
            # type-safety pruning: only (slot, node) pairs where the
            # node's type declares the relation can have edges
            ok = self.slot_of_type[
                self.node_type_of(nodes)[:, None], e_slot_raw[None, :]
            ]
            kk = nodes[:, None] + (e_slot_k1d[None, :] * N)
            return kk[ok].ravel()

        node_frontier = seen_nodes.fresh(
            np.asarray([res_node], np.int64)
            if 0 <= res_node < N else np.empty(0, np.int64)
        )
        pair_frontier = np.empty(0, np.int64)
        pending_nodes: List[np.ndarray] = []
        while node_frontier.size or pair_frontier.size:
            new_pairs: List[np.ndarray] = []
            if node_frontier.size:
                # arrow closure of the frontier, then every edge off it
                fresh_all: List[np.ndarray] = [node_frontier]
                cur = node_frontier
                while cur.size and ts_k1d.size:
                    tok = self.slot_of_type[
                        self.node_type_of(cur)[:, None], ts_raw[None, :]
                    ]
                    keys = (cur[:, None] + ts_k1d[None, :] * N)[tok].ravel()
                    child_parts = [
                        rows[:, 0].astype(np.int64)
                        for rows in self.expand_arrows_fwd(
                            keys.astype(np.int32), now
                        )
                        if rows.shape[0]
                    ]
                    cur = seen_nodes.fresh(
                        np.concatenate(child_parts)
                        if child_parts else np.empty(0, np.int64)
                    )
                    if cur.size:
                        fresh_all.append(cur)
                nodes = np.concatenate(fresh_all)
                for rows in self.expand_fw(
                    fw_keys_of_nodes(nodes).astype(np.int32), now
                ):
                    if rows.shape[0] == 0:
                        continue
                    cand, pairs = absorb(rows[:, 1].astype(np.int64))
                    if cand is not None:
                        _mt.inc("lookup.candidates", cand.size)
                        yield cand
                    if pairs.size:
                        new_pairs.append(pairs)
            if pair_frontier.size:
                g = pair_frontier // (num_slots + 1)
                r = pair_frontier % (num_slots + 1)
                tids = self.node_type_of(g)
                ok_t = (tids >= 0) & (r < num_slots)
                is_perm = np.zeros(g.shape[0], bool)
                if self.perm_raw_table is not None:
                    is_perm[ok_t] = self.perm_raw_table[
                        tids[ok_t], r[ok_t]
                    ]
                # permission pairs: holders of g#p ⊆ expansion of g
                pending_nodes.append(g[is_perm])
                rel_g, rel_r = g[~is_perm], r[~is_perm]
                kd = self.k1d[np.clip(rel_r, 0, self.k1d.shape[0] - 1)]
                okk = (kd >= 0) & (rel_r < self.k1d.shape[0])
                keys = kd[okk] * N + rel_g[okk]
                for rows in self.expand_fw(keys.astype(np.int32), now):
                    if rows.shape[0] == 0:
                        continue
                    cand, pairs = absorb(rows[:, 1].astype(np.int64))
                    if cand is not None:
                        _mt.inc("lookup.candidates", cand.size)
                        yield cand
                    if pairs.size:
                        new_pairs.append(pairs)
            pair_frontier = seen_pairs.fresh(
                np.concatenate(new_pairs)
                if new_pairs else np.empty(0, np.int64)
            )
            if pair_frontier.size:
                pair_list.append(pair_frontier)
            node_frontier = seen_nodes.fresh(
                np.concatenate(pending_nodes)
                if pending_nodes else np.empty(0, np.int64)
            )
            pending_nodes = []

        # trailing blocks, same order as the walker's tail
        if srel_slot >= 0 and pair_list:
            allp = np.concatenate(pair_list)
            gs = allp[allp % (num_slots + 1) == srel_slot] // (num_slots + 1)
            cand = seen_cand.fresh(gs[self.node_type_of(gs) == stid])
            if cand.size:
                _mt.inc("lookup.candidates", cand.size)
                yield cand
        if 0 <= res_node and self.node_type_of(
            np.asarray([res_node], np.int64)
        )[0] == stid:
            cand = seen_cand.fresh(np.asarray([res_node], np.int64))
            if cand.size:
                yield cand
        if wildcard_found[0] and srel_slot < 0:
            subs = self.all_subjects()
            cand = seen_cand.fresh(subs[self.node_type_of(subs) == stid])
            if cand.size:
                _mt.inc("lookup.candidates", cand.size)
                yield cand


def state_for(engine, dsnap) -> FrontierState:
    st = dsnap.__dict__.get("_frontier_state")
    if st is None or st.engine is not engine:
        st = FrontierState(engine, dsnap)
        dsnap.__dict__["_frontier_state"] = st
    return st


# ---------------------------------------------------------------------------
# cursor-paginated result streaming (shared by frontier + walker paths)
# ---------------------------------------------------------------------------


class _ResultStream:
    """A lookup's granted-result stream: candidate blocks → exact filter
    → result ids, with the emitted-count bookkeeping cursors resume on."""

    def __init__(self, cand_iter: Iterator[np.ndarray],
                 filter_fn: Callable[[np.ndarray], List[int]],
                 id_of: Callable[[int], str],
                 cost_bytes: int = 1 << 20) -> None:
        self._cands = cand_iter
        self._filter = filter_fn
        self._id_of = id_of
        self._pending: List[str] = []
        self.emitted = 0
        self.exhausted = False
        #: estimated held host bytes (frontier seen-set bitmaps dominate)
        #: — paginate's cache evicts by this, not just count
        self.cost_bytes = int(cost_bytes)

    def take(self, n: int) -> List[str]:
        out: List[str] = []
        while len(out) < n:
            if self._pending:
                k = min(n - len(out), len(self._pending))
                out.extend(self._pending[:k])
                del self._pending[:k]
                continue
            block = next(self._cands, None)
            if block is None:
                self.exhausted = True
                break
            if block.size == 0:
                continue
            granted = self._filter(block)
            self._pending.extend(self._id_of(int(g)) for g in granted)
        self.emitted += len(out)
        return out

    def skip(self, n: int) -> None:
        while n > 0:
            got = self.take(min(n, 4096))
            n -= len(got)
            if self.exhausted and not self._pending and not got:
                break


#: byte budget for cached live continuations per DeviceSnapshot: a big
#: world's stream holds seen-set bitmaps (up to _SEEN_BUDGET_BYTES
#: each), so eviction is by ESTIMATED bytes, with the count cap as the
#: small-stream backstop
_STREAM_CACHE_BYTES = 256 << 20


def paginate(
    dsnap,
    token: str,
    make_stream: Callable[[], _ResultStream],
    page_size: int,
    cursor: Optional[LookupCursor],
    now_us: Optional[int] = None,
) -> Tuple[List[str], Optional[LookupCursor]]:
    """One page of results with exact resume semantics.  The live stream
    is cached on the DeviceSnapshot keyed by ``token``; an evicted or
    cross-process resume deterministically recomputes and skips
    ``cursor.pos`` results.  ``now_us`` (already resolved via
    resolve_now_us) rides the returned cursor so the recompute is
    evaluated at the same instant."""
    from ..utils.errors import PreconditionFailedError

    cache: Dict[str, _ResultStream] = dsnap.__dict__.setdefault(
        "_lookup_streams", {}
    )
    pos = 0
    if cursor is not None:
        if cursor.token != token:
            raise PreconditionFailedError(
                "lookup cursor does not match this query"
            )
        if cursor.revision != dsnap.revision:
            raise PreconditionFailedError(
                f"lookup cursor pinned to revision {cursor.revision}, "
                f"snapshot is at {dsnap.revision}"
            )
        pos = cursor.pos
    stream = cache.pop(token, None)
    if stream is None or stream.emitted != pos:
        stream = make_stream()
        _mt.inc("lookup.stream_recomputes" if pos else "lookup.streams")
        stream.skip(pos)
    ids = stream.take(page_size)
    done = stream.exhausted and not stream._pending
    nxt = None
    if not done:
        nxt = LookupCursor(dsnap.revision, token, stream.emitted, now_us)
        cache[token] = stream
        while len(cache) > _STREAM_CACHE_MAX or (
            len(cache) > 1
            and sum(s.cost_bytes for s in cache.values())
            > _STREAM_CACHE_BYTES
        ):
            cache.pop(next(iter(cache)))
    return ids, nxt
