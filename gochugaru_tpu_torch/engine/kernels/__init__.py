"""The engine's hand-written Hopper kernels and the seam that picks them.

``fused_probe`` is the port of gochugaru_tpu/engine/pallas.py's
``fused_probe``: modes block/any/until2/gate on the check path, and
``runs`` (the point-run bisect) on the lookup path.
``fused_probe_aligned`` is the port of its ``fused_probe_aligned``: the
same four check modes over the bucket-aligned layout.  A call on CPU
tensors, or with ``plain=True``, runs the plain PyTorch twin
(``plain.py``); a call on CUDA tensors launches ``csrc/fused_probe.cu``
/ ``csrc/fused_probe_aligned.cu`` or raises ``KernelError`` (a build,
load or launch that failed) — there is no silent fallback.
``LAUNCHES`` counts kernel launches per mode (never plain calls) —
``MODES`` for fused_probe, ``aligned.<mode>`` for each of
``ALIGNED_MODES`` — so a run can show that its main path went through
the kernels, and ``LANES`` the query lanes (keys for ``runs``) those
launches processed.  A gate with the caveat lanes (``cav_lane``, and
``ctx_lane`` beside it) counts under its own key, ``gate.cav`` /
``aligned.gate.cav``.  Every check mode of both kernels runs one
slot-tile routine (``csrc/probe_common.cuh``), one thread a slot:
``block`` and ``gate`` on the tile whose geometry ``block_tile`` and
``gate_tile`` pick here; the reduced modes ``any`` and ``until2`` on the
warp path for lanes of at most ``WARP_REDUCE_CAP`` slots (``warp_tile``:
whole lanes a warp, folded by ballots, no shared memory) and on the
shared-flag tile for longer ones (``reduce_tile``), as ``reduce_path``
picks.  Only ``runs`` has a kernel of its own (one thread a key).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..consts import device_const
from .build import KernelError
from .plain import (
    blk_hit, check_planes, field0_spec, fused_probe_aligned_plain,
    fused_probe_plain,
)

__all__ = [
    "ALIGNED_MODES", "GATE_CAV", "KernelError", "LANES", "LAUNCHES", "MODES",
    "available", "blk_hit", "block_tile", "fused_probe", "fused_probe_aligned",
    "fused_probe_aligned_plain", "fused_probe_plain", "gate_tile",
    "reduce_path", "reduce_tile", "reset_launches", "spec_tensors",
    "warp_tile",
]

MODES = ("block", "any", "until2", "gate", "runs")
ALIGNED_MODES = ("block", "any", "until2", "gate")
#: the launch-count key of a gate that returns the caveat planes
GATE_CAV = "gate.cav"
_MODE_ID = {m: i for i, m in enumerate(MODES)}
MAXW = 16
MAXL = 8
DICT = 256
#: shared-memory budget of one block-mode tile, bytes a CTA (chip_smoke.py
#: times 8-64 KB: 16 KB was the best or level with it, PERF.md)
TILE_BYTES = 16 * 1024
#: shared memory one CTA may use on sm_90 (227 KB)
SMEM_MAX = 232_448
#: slots a CTA of the gate's slot tile (256 threads, one slot a thread a
#: round; chip_smoke.py times 1024-4096, PERF.md)
GATE_SLOTS = 2048
#: the most slots a CTA of the reduced modes' tile holds in whole lanes:
#: fewer than the gate's, since a reduced call has few lanes and each
#: thread's slots are round trips one after another (chip_smoke.py times
#: 256-2048, PERF.md)
REDUCE_SLOTS = 512
#: the longest lane (capT) the reduced modes fold on the warp path: one
#: warp holds whole lanes and one ballot of its 32 threads folds them
#: (csrc GOCHUGARU_WARP_CAP); longer lanes take the shared-flag tile.
#: Read at call time, so a caller can send short lanes to the tile too
WARP_REDUCE_CAP = 32
#: threads a CTA of the slot tile and of the warp path
#: (csrc GOCHUGARU_TILE_THREADS)
TILE_THREADS = 256
#: the modes that fold a lane's slots into flags a lane
REDUCED = ("any", "until2")
#: kernel launches per mode since the last reset_launches(): fused_probe
#: under its mode, fused_probe_aligned under ``aligned.<mode>``, a gate
#: with the caveat planes under ``GATE_CAV`` (``aligned.`` + GATE_CAV)
LAUNCHES: Dict[str, int] = {
    **{m: 0 for m in MODES + (GATE_CAV,)},
    **{f"aligned.{m}": 0 for m in ALIGNED_MODES + (GATE_CAV,)},
}
#: query lanes (keys for ``runs``) those launches processed, by the same keys
LANES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0


def _count(key: str, lanes: int) -> None:
    LAUNCHES[key] += 1
    LANES[key] += lanes


class _Args(ctypes.Structure):
    # field order and types mirror struct ProbeArgs in csrc/fused_probe.cu
    _fields_ = [
        ("q0", ctypes.c_void_p), ("q1", ctypes.c_void_p),
        ("B", ctypes.c_longlong),
        ("off", ctypes.c_void_p), ("off_a", ctypes.c_void_p),
        ("size", ctypes.c_longlong),
        ("tbl", ctypes.c_void_p), ("rows", ctypes.c_longlong),
        ("fields", ctypes.c_void_p), ("dicts", ctypes.c_void_p),
        ("out0", ctypes.c_void_p), ("out1", ctypes.c_void_p),
        ("out2", ctypes.c_void_p), ("out3", ctypes.c_void_p),
        ("now_ptr", ctypes.c_void_p),
        ("nq", ctypes.c_int), ("ashift", ctypes.c_int),
        ("packed", ctypes.c_int), ("w_raw", ctypes.c_int),
        ("cap", ctypes.c_int), ("W", ctypes.c_int),
        ("now", ctypes.c_int), ("lay_exp", ctypes.c_int),
        ("lay_cav", ctypes.c_int), ("lay_ctx", ctypes.c_int),
        ("tile_slots", ctypes.c_int), ("warp", ctypes.c_int),
    ]


class _Level(ctypes.Structure):
    # mirrors struct AlignedLevel in csrc/fused_probe_aligned.cu
    _fields_ = [
        ("tbl", ctypes.c_void_p), ("size", ctypes.c_longlong),
        ("stride", ctypes.c_longlong), ("cap", ctypes.c_int),
        ("salt", ctypes.c_int),
    ]


class _AlignedArgs(ctypes.Structure):
    # mirrors struct AlignedArgs in csrc/fused_probe_aligned.cu
    _fields_ = [
        ("q0", ctypes.c_void_p), ("q1", ctypes.c_void_p),
        ("B", ctypes.c_longlong),
        ("fields", ctypes.c_void_p), ("dicts", ctypes.c_void_p),
        ("out0", ctypes.c_void_p), ("out1", ctypes.c_void_p),
        ("out2", ctypes.c_void_p), ("out3", ctypes.c_void_p),
        ("now_ptr", ctypes.c_void_p),
        ("nq", ctypes.c_int), ("L", ctypes.c_int),
        ("packed", ctypes.c_int), ("sw", ctypes.c_int),
        ("capT", ctypes.c_int), ("W", ctypes.c_int),
        ("now", ctypes.c_int), ("lay_exp", ctypes.c_int),
        ("lay_cav", ctypes.c_int), ("lay_ctx", ctypes.c_int),
        ("tile_slots", ctypes.c_int),
        ("lv", _Level * MAXL), ("warp", ctypes.c_int),
    ]


def block_tile(capT: int, W: int, nseg: int) -> Tuple[int, int, int]:
    """Launch geometry of mode ``block``'s tile kernel for lanes of
    ``capT`` slots of ``W`` int32 columns in ``nseg`` segments (1 for
    fused_probe, the level count for fused_probe_aligned): ``(tile_slots,
    tile_lanes, smem_bytes)``.

    A CTA owns ``tile_slots`` consecutive output slots: whole lanes, as
    many as ``TILE_BYTES`` (read at call time) holds with each lane's
    segment starts (8 bytes each); or, when the fewest whole lanes that
    keep alignment pass the budget, a chunk of slots, so one lane's block
    is walked by several CTAs.  ``tile_slots * W`` is always a multiple of
    4, so every tile's span of the output starts 16-byte aligned.  The
    shared bytes are the tile plus the segment starts of ``tile_lanes``
    lanes, the most one tile touches (as gochugaru_tile_lanes counts
    them); they pass the budget by at most 192 bytes, when a chunk
    crosses lanes."""
    lane = capT * W * 4 + nseg * 8
    step = 4 // math.gcd(capT * W, 4)
    lanes = TILE_BYTES // lane // step * step
    if lanes:
        slots = lanes * capT
    else:
        g = 4 // math.gcd(W, 4)
        slots = max(g, (TILE_BYTES - 16 * nseg) // (4 * W) // g * g)
    tl = _tile_lanes(slots, capT)
    return slots, tl, slots * W * 4 + tl * nseg * 8


def gate_tile(capT: int, nseg: int) -> Tuple[int, int, int]:
    """Launch geometry of mode ``gate``'s slot tile (both kernels) for
    lanes of ``capT`` slots in ``nseg`` segments (1 for fused_probe, the
    level count for fused_probe_aligned): ``(tile_slots, tile_lanes,
    smem_bytes)``.

    A CTA owns ``GATE_SLOTS`` (read at call time) consecutive slots,
    whatever ``capT``: its flags need no output tile and no alignment, so
    a lane longer than a tile is walked by several CTAs and short lanes
    pack many to one.  The shared bytes are the segment starts (8 bytes a
    segment) and the two keys (8 bytes) of every lane the tile touches, as
    gochugaru_tile_smem counts them."""
    slots = int(GATE_SLOTS)
    tl = _tile_lanes(slots, capT)
    return slots, tl, tl * (nseg * 8 + 8)


def reduce_tile(capT: int, nseg: int) -> Tuple[int, int, int]:
    """Launch geometry of the reduced modes' shared-flag tile (``any`` and
    ``until2`` of both kernels, lanes longer than ``WARP_REDUCE_CAP``)
    for lanes of ``capT`` slots in ``nseg`` segments: ``(tile_slots,
    tile_lanes, smem_bytes)``.

    A CTA owns whole lanes, ``max(1, REDUCE_SLOTS // capT)`` of them
    (read at call time), so every tile starts at a lane boundary and no
    lane's flags are folded by two CTAs; a lane longer than
    ``REDUCE_SLOTS`` gets a CTA of its own.  The shared bytes are, per
    lane, the segment starts (8 bytes a segment), the two keys (8 bytes)
    and the flag word (4 bytes), as gochugaru_tile_smem counts them."""
    lanes = max(1, int(REDUCE_SLOTS) // capT)
    return lanes * capT, lanes, lanes * (nseg * 8 + 12)


def warp_tile(capT: int) -> Tuple[int, int, int]:
    """Launch geometry of the reduced modes' warp path for lanes of
    ``capT`` <= 32 slots: ``(tile_slots, lanes_a_warp, idle_threads)``.

    A warp owns ``32 // capT`` whole lanes, thread t slot ``t % capT`` of
    lane ``t // capT``; the ``32 - lanes * capT`` threads past them idle.
    A CTA is ``TILE_THREADS // 32`` such warps, so its ``tile_slots`` are
    its warps' slots and the grid is ``ceil(B * capT / tile_slots)`` CTAs,
    as gochugaru_warp_lanes / gochugaru_warp_slots count them (the launch
    refuses any other)."""
    if not 1 <= capT <= 32:
        raise ValueError(f"the warp path takes lanes of 1..32 slots, not {capT}")
    lanes = 32 // capT
    return TILE_THREADS // 32 * lanes * capT, lanes, 32 - lanes * capT


def reduce_path(capT: int) -> str:
    """Which kernel a reduced mode (``any``, ``until2``) launches for lanes
    of ``capT`` slots: ``"warp"`` up to ``WARP_REDUCE_CAP`` (read at call
    time), else ``"tile"`` (the shared-flag tile)."""
    return "warp" if capT <= int(WARP_REDUCE_CAP) else "tile"


def _tile_slots(mode: str, capT: int, W: int, nseg: int) -> int:
    """Slots a CTA of a slot-tile mode's launch (0 for ``runs``)."""
    if mode == "block":
        return block_tile(capT, W, nseg)[0]
    if mode == "gate":
        return gate_tile(capT, nseg)[0]
    if mode in REDUCED:
        if reduce_path(capT) == "warp":
            return warp_tile(capT)[0]
        return reduce_tile(capT, nseg)[0]
    return 0


def _warp(mode: str, capT: int) -> int:
    """The args' ``warp`` field: 1 when a reduced mode takes the warp path."""
    return int(mode in REDUCED and reduce_path(capT) == "warp")


def _tile_lanes(slots: int, capT: int) -> int:
    """The most lanes one tile of ``slots`` touches (tiles start at
    multiples of ``slots``), as gochugaru_tile_lanes counts them."""
    return slots // capT if slots % capT == 0 else (slots + capT - 2) // capT + 1


_FNS: Dict[str, object] = {}


def _bind(name: str, args_type):
    """The C entry ``gochugaru_<name>`` of ``csrc/<name>.cu``, built and
    bound on first use."""
    fn = _FNS.get(name)
    if fn is None:
        from .build import library

        fn = getattr(library(name), "gochugaru_" + name)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(args_type), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launcher():
    return _bind("fused_probe", _Args)


def _aligned_launcher():
    return _bind("fused_probe_aligned", _AlignedArgs)


def available() -> bool:
    """Whether the kernels can launch in this process: a CUDA device and
    both kernel libraries built from ``csrc/`` (built here when they are
    not yet).  A probe for the tuner's ``kernels`` rule; the engine never
    reads it to pick a path."""
    if not torch.cuda.is_available():
        return False
    try:
        _launcher()
        _aligned_launcher()
    except KernelError:
        return False
    return True


def spec_tensors(spec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A packed table's decode spec as the kernel reads it: int32[W, 5]
    fields and int32[ndict, 256] dictionaries (each padded with its last
    value, so an index clamps the way the plain gather does).  Each delta
    column must name an earlier column, as the decode reads them in
    order."""
    w, _lanes, fields, dicts = spec
    for c, field in enumerate(fields):
        if field[2] >= c:
            raise ValueError(f"column {c} is a delta of a later column")
    f = torch.tensor(fields, dtype=torch.int32).reshape(w, 5)
    d = torch.zeros((max(len(dicts), 1), DICT), dtype=torch.int32)
    for k, dv in enumerate(dicts):
        if len(dv) > DICT:
            raise ValueError("dictionary wider than 256 entries")
        d[k, : len(dv)] = torch.tensor(dv, dtype=torch.int32)
        d[k, len(dv):] = dv[-1]
    return f.to(device), d.to(device)


def _spec_on(spec, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """``spec_tensors`` built once per (spec, device) and cached
    (engine/consts.py): a caller without the snapshot's uploaded spec
    pays no host copy per launch, so its launches can be captured."""
    return device_const(("spec", repr(spec)), dev,
                        lambda d: spec_tensors(spec, d))


def fused_probe(
    q_cols: Sequence,
    off,
    tbl,
    *,
    cap: int,
    spec=None,
    spec_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    off_a=None,
    ashift: Optional[int] = None,
    mode: str = "block",
    now: Optional[Union[int, torch.Tensor]] = None,
    exp_lane: Optional[int] = None,
    cav_lane: Optional[int] = None,
    ctx_lane: Optional[int] = None,
    plain: bool = False,
):
    """One fused bucket probe over the off+interleave layout.

    ``q_cols`` are 1 or 2 int32 query key columns (any broadcastable
    shapes); ``off`` the bucket offsets (int32, or uint16 residuals stored
    as int16 with int32 anchors ``off_a`` and shift ``ashift``); ``tbl``
    the interleaved table (int32 rows, or packed uint16 lanes stored as
    int16 and decoded through ``spec``).  Modes:

    - ``block``  int32[..., cap, W] decoded candidate block
    - ``any``    bool[...] any exact-key hit
    - ``until2`` (bool[...], bool[...]): hit with column 2 / 3 > ``now``
      (an int, or a 0-dim int32 tensor on the tables' device, which the
      kernel reads by pointer when it runs)
    - ``gate``   (hit, live) bool[..., cap]: live = hit whose expiry
      column ``exp_lane`` is 0 or > ``now`` (no gate when None); with
      ``cav_lane`` also int32[..., cap] the caveat-id column on a hit (0
      on a miss), and with ``ctx_lane`` beside it the stored-context
      column on a hit (-1 on a miss)
    - ``runs``   (lo, ln) int32[...]: one key column; the key's run of
      rows in its bucket, found by two bisects over column 0 (rows sorted
      by column 0 within each bucket, ``cap`` the max bucket occupancy);
      keys < 0 give (0, 0)
    """
    if plain or tbl.device.type == "cpu":
        return fused_probe_plain(
            q_cols, off, tbl, cap=cap, spec=spec, off_a=off_a, ashift=ashift,
            mode=mode, now=now, exp_lane=exp_lane, cav_lane=cav_lane,
            ctx_lane=ctx_lane,
        )
    if tbl.device.type != "cuda":
        raise ValueError(f"fused_probe: unsupported device {tbl.device}")
    nq = len(q_cols)
    if mode == "runs" and nq != 1:
        raise ValueError("the runs probe takes one key column")
    shape, qf = _flat_queries(q_cols)
    B = int(qf[0].shape[0])
    rows, w_raw = int(tbl.shape[0]), int(tbl.shape[1])
    packed = spec is not None
    W = int(spec[0]) if packed else w_raw
    _check_row("fused_probe", W, nq, mode, exp_lane, cav_lane, ctx_lane)
    if mode != "runs" and rows < cap:
        raise ValueError("table has fewer rows than the probe cap")
    if mode == "runs" and packed:
        field0_spec(spec)  # raises unless column 0 is a plain range
    want_tbl = torch.int16 if packed else torch.int32
    want_off = torch.int16 if off_a is not None else torch.int32
    if tbl.dtype != want_tbl or off.dtype != want_off:
        raise TypeError(
            f"fused_probe: tbl {tbl.dtype}/off {off.dtype}, want"
            f" {want_tbl}/{want_off}"
        )
    dev = tbl.device
    tensors = [tbl, off] + qf + ([off_a] if off_a is not None else [])
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("fused_probe: tensors must be contiguous on one device")
    if off_a is not None and off_a.dtype != torch.int32:
        raise TypeError("offset anchors must be int32")
    if packed:
        fields, dicts = spec_dev if spec_dev is not None else _spec_on(spec, dev)
    else:
        fields = dicts = None
    outs = _outputs(mode, B, cap, W, dev, cav_lane, ctx_lane)
    if B == 0 or (cap == 0 and mode != "runs"):
        for o in outs:
            o.zero_()  # no slots: no hit
        return _shaped(mode, outs, shape, cap, W)
    a = _Args(
        q0=qf[0].data_ptr(), q1=qf[1].data_ptr() if nq > 1 else None,
        B=B, off=off.data_ptr(),
        off_a=off_a.data_ptr() if off_a is not None else None,
        size=int(off.shape[0]) - 1, tbl=tbl.data_ptr(), rows=rows,
        fields=fields.data_ptr() if packed else None,
        dicts=dicts.data_ptr() if packed else None,
        nq=nq, ashift=int(ashift or 0), packed=int(packed), w_raw=w_raw,
        cap=int(cap), W=W, **_now_fields(now, dev),
        tile_slots=_tile_slots(mode, int(cap), W, 1),
        warp=_warp(mode, int(cap)),
        **_out_fields(outs, exp_lane, cav_lane, ctx_lane),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(_MODE_ID[mode], ctypes.byref(a), stream)
    if err != 0:
        raise KernelError(f"fused_probe kernel launch failed (cudaError {err})")
    _count(GATE_CAV if cav_lane is not None else mode, B)
    return _shaped(mode, outs, shape, cap, W)


def _flat_queries(q_cols):
    """(lattice shape, the key columns broadcast to it and flattened to
    contiguous int32 lanes)."""
    if len(q_cols) not in (1, 2):
        raise ValueError("the probe kernels take one or two key columns")
    shape = torch.broadcast_shapes(*[tuple(c.shape) for c in q_cols])
    return shape, [c.expand(shape).reshape(-1).to(torch.int32).contiguous()
                   for c in q_cols]


def _check_row(name: str, W: int, nq: int, mode: str, exp_lane,
               cav_lane=None, ctx_lane=None) -> None:
    """Raise on a logical row the kernels cannot read for ``mode``."""
    if W > MAXW or W < nq:
        raise ValueError(f"{name}: {W} columns (kernel takes {nq}..{MAXW})")
    if mode == "until2" and W < 4:
        raise ValueError("until2 needs columns 2 and 3")
    for what, lane in (("expiry", exp_lane), ("caveat", cav_lane),
                       ("context", ctx_lane)):
        if lane is not None and not 0 <= lane < W:
            raise ValueError(f"{what} lane outside the row")
    check_planes(mode, cav_lane, ctx_lane)


def _now_fields(now, dev) -> Dict[str, object]:
    """The args' clock: an int goes by value; a 0-dim int32 tensor on the
    launch's device goes by pointer, so the kernel reads it when it runs
    (a CUDA graph replays with whatever its caller filled in)."""
    if isinstance(now, torch.Tensor):
        if now.dim() != 0 or now.dtype != torch.int32 or now.device != dev:
            raise ValueError("now: want a 0-dim int32 tensor on the launch's"
                             f" device, not {now.dtype}{list(now.shape)} on"
                             f" {now.device}")
        return dict(now=0, now_ptr=now.data_ptr())
    return dict(now=int(now or 0), now_ptr=None)


def _out_fields(outs, exp_lane, cav_lane, ctx_lane) -> Dict[str, object]:
    """The output pointers and gate lanes of a launch's args struct."""
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    return dict(
        out0=ptrs[0], out1=ptrs[1], out2=ptrs[2], out3=ptrs[3],
        lay_exp=-1 if exp_lane is None else int(exp_lane),
        lay_cav=-1 if cav_lane is None else int(cav_lane),
        lay_ctx=-1 if ctx_lane is None else int(ctx_lane),
    )


def _outputs(mode, B, cap, W, dev, cav_lane=None, ctx_lane=None):
    """The kernel's flat output tensors of one mode (bools as uint8; the
    gate's caveat planes int32)."""
    if mode == "block":
        return [torch.empty((B, cap, W), dtype=torch.int32, device=dev)]
    if mode == "any":
        return [torch.empty(B, dtype=torch.uint8, device=dev)]
    if mode == "until2":
        return [torch.empty(B, dtype=torch.uint8, device=dev) for _ in range(2)]
    if mode == "gate":
        planes = (cav_lane is not None) + (ctx_lane is not None)
        return ([torch.empty((B, cap), dtype=torch.uint8, device=dev)
                 for _ in range(2)]
                + [torch.empty((B, cap), dtype=torch.int32, device=dev)
                   for _ in range(planes)])
    if mode == "runs":
        return [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2)]
    raise ValueError(f"unknown probe mode {mode!r}")


def fused_probe_aligned(
    q_cols: Sequence,
    tbls: Sequence,
    caps: Sequence[int],
    sw: int,
    *,
    spec=None,
    spec_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mode: str = "block",
    now: Optional[Union[int, torch.Tensor]] = None,
    exp_lane: Optional[int] = None,
    cav_lane: Optional[int] = None,
    ctx_lane: Optional[int] = None,
    plain: bool = False,
):
    """One fused probe over the bucket-aligned ladder.

    ``tbls`` are the width-stratum level tables (level l: ``caps[l]``
    slots of ``sw`` elements per row — int32 columns, or packed uint16
    lanes stored as int16 and decoded through ``spec``); level l >= 1
    hashes ``q0 ^ _level_salt(l)``.  The candidate block is the levels'
    rows concatenated in level order, ``capT = sum(caps)`` slots.  Modes
    and outputs are ``fused_probe``'s with ``cap = capT`` (no ``runs``).
    """
    from ..hash import _level_salt

    if plain or tbls[0].device.type == "cpu":
        return fused_probe_aligned_plain(
            q_cols, tbls, caps, sw, spec=spec, mode=mode, now=now,
            exp_lane=exp_lane, cav_lane=cav_lane, ctx_lane=ctx_lane,
        )
    dev = tbls[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused_probe_aligned: unsupported device {dev}")
    if mode not in ALIGNED_MODES:
        raise ValueError(f"fused_probe_aligned: unknown mode {mode!r}")
    L = len(tbls)
    if not 1 <= L <= MAXL or len(caps) != L:
        raise ValueError(f"fused_probe_aligned: {L} levels for {len(caps)}"
                         f" caps (kernel takes 1..{MAXL})")
    shape, qf = _flat_queries(q_cols)
    nq = len(qf)
    packed = spec is not None
    W = int(spec[0]) if packed else int(sw)
    if packed and int(spec[1]) != int(sw):
        raise ValueError("fused_probe_aligned: slot width is not the spec's lanes")
    _check_row("fused_probe_aligned", W, nq, mode, exp_lane, cav_lane,
               ctx_lane)
    want = torch.int16 if packed else torch.int32
    for t, c in zip(tbls, caps):
        rows = int(t.shape[0])
        if t.dtype != want:
            raise TypeError(f"fused_probe_aligned: level {t.dtype}, want {want}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("fused_probe_aligned: levels must be contiguous"
                             " on one device")
        if t.dim() != 2 or int(t.shape[1]) != int(c) * int(sw):
            raise ValueError("fused_probe_aligned: level row is not cap * sw")
        if rows < 1 or rows & (rows - 1):
            raise ValueError("fused_probe_aligned: level rows must be a pow2")
    for q in qf:
        if q.device != dev:
            raise ValueError("fused_probe_aligned: queries on another device")
    B = int(qf[0].shape[0])
    capT = int(sum(int(c) for c in caps))
    outs = _outputs(mode, B, capT, W, dev, cav_lane, ctx_lane)
    if B == 0 or capT == 0:
        for o in outs:
            o.zero_()  # no slots: no hit
        return _shaped(mode, outs, shape, capT, W)
    if packed:
        fields, dicts = spec_dev if spec_dev is not None else _spec_on(spec, dev)
    lv = (_Level * MAXL)()
    for l, (t, c) in enumerate(zip(tbls, caps)):
        lv[l] = _Level(tbl=t.data_ptr(), size=int(t.shape[0]),
                       stride=int(t.shape[1]), cap=int(c),
                       salt=int(_level_salt(l)))
    a = _AlignedArgs(
        q0=qf[0].data_ptr(), q1=qf[1].data_ptr() if nq > 1 else None, B=B,
        fields=fields.data_ptr() if packed else None,
        dicts=dicts.data_ptr() if packed else None,
        nq=nq, L=L, packed=int(packed), sw=int(sw), capT=capT, W=W,
        **_now_fields(now, dev), tile_slots=_tile_slots(mode, capT, W, L),
        warp=_warp(mode, capT), lv=lv,
        **_out_fields(outs, exp_lane, cav_lane, ctx_lane),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _aligned_launcher()(_MODE_ID[mode], ctypes.byref(a), stream)
    if err != 0:
        raise KernelError(
            f"fused_probe_aligned kernel launch failed (cudaError {err})")
    _count("aligned." + (GATE_CAV if cav_lane is not None else mode), B)
    return _shaped(mode, outs, shape, capT, W)


def _shaped(mode, outs, shape, cap, W):
    """The kernel's flat outputs in the caller's query-lattice shape."""
    if mode == "block":
        return outs[0].reshape(tuple(shape) + (cap, W))
    if mode == "gate":
        return tuple((o.view(torch.bool) if o.dtype == torch.uint8 else o)
                     .reshape(tuple(shape) + (cap,)) for o in outs)
    if mode == "runs":
        return tuple(o.reshape(tuple(shape)) for o in outs)
    done = [o.view(torch.bool).reshape(tuple(shape)) for o in outs]
    return done[0] if mode == "any" else tuple(done)
