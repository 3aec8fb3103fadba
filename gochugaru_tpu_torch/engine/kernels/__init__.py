"""The engine's hand-written Hopper kernels and the seam that picks them.

``fused_probe`` is the port of gochugaru_tpu/engine/pallas.py's
``fused_probe``: modes block/any/until2/gate on the check path, and
``runs`` (the point-run bisect) on the lookup path.  A call on
CPU tensors, or with ``plain=True``, runs the plain PyTorch twin
(``plain.py``); a call on CUDA tensors launches ``csrc/fused_probe.cu``
or raises — there is no silent fallback.  ``LAUNCHES`` counts kernel
launches per mode (never plain calls), so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from .plain import blk_hit, field0_spec, fused_probe_plain

__all__ = [
    "LAUNCHES", "MODES", "blk_hit", "fused_probe", "fused_probe_plain",
    "reset_launches", "spec_tensors",
]

MODES = ("block", "any", "until2", "gate", "runs")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
MAXW = 16
DICT = 256

#: kernel launches per mode since the last reset_launches()
LAUNCHES: Dict[str, int] = {m: 0 for m in MODES}


def reset_launches() -> None:
    for m in MODES:
        LAUNCHES[m] = 0


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
        ("nq", ctypes.c_int), ("ashift", ctypes.c_int),
        ("packed", ctypes.c_int), ("w_raw", ctypes.c_int),
        ("cap", ctypes.c_int), ("W", ctypes.c_int),
        ("now", ctypes.c_int), ("lay_exp", ctypes.c_int),
    ]


_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from .build import library

        fn = library("fused_probe").gochugaru_fused_probe
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def spec_tensors(spec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A packed table's decode spec as the kernel reads it: int32[W, 5]
    fields and int32[ndict, 256] dictionaries (each padded with its last
    value, so an index clamps the way the plain gather does)."""
    w, _lanes, fields, dicts = spec
    f = torch.tensor(fields, dtype=torch.int32).reshape(w, 5)
    d = torch.zeros((max(len(dicts), 1), DICT), dtype=torch.int32)
    for k, dv in enumerate(dicts):
        if len(dv) > DICT:
            raise ValueError("dictionary wider than 256 entries")
        d[k, : len(dv)] = torch.tensor(dv, dtype=torch.int32)
        d[k, len(dv):] = dv[-1]
    return f.to(device), d.to(device)


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
    now: Optional[int] = None,
    exp_lane: Optional[int] = None,
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
    - ``gate``   (hit, live) bool[..., cap]: live = hit whose expiry
      column ``exp_lane`` is 0 or > ``now`` (no gate when None)
    - ``runs``   (lo, ln) int32[...]: one key column; the key's run of
      rows in its bucket, found by two bisects over column 0 (rows sorted
      by column 0 within each bucket, ``cap`` the max bucket occupancy);
      keys < 0 give (0, 0)
    """
    if plain or tbl.device.type == "cpu":
        return fused_probe_plain(
            q_cols, off, tbl, cap=cap, spec=spec, off_a=off_a, ashift=ashift,
            mode=mode, now=now, exp_lane=exp_lane,
        )
    if tbl.device.type != "cuda":
        raise ValueError(f"fused_probe: unsupported device {tbl.device}")
    shape = torch.broadcast_shapes(*[tuple(c.shape) for c in q_cols])
    nq = len(q_cols)
    if nq not in (1, 2):
        raise ValueError("fused_probe takes one or two key columns")
    if mode == "runs" and nq != 1:
        raise ValueError("the runs probe takes one key column")
    qf = [c.expand(shape).reshape(-1).to(torch.int32).contiguous()
          for c in q_cols]
    B = int(qf[0].shape[0])
    rows, w_raw = int(tbl.shape[0]), int(tbl.shape[1])
    packed = spec is not None
    W = int(spec[0]) if packed else w_raw
    if W > MAXW or W < nq:
        raise ValueError(f"fused_probe: {W} columns (kernel takes {nq}..{MAXW})")
    if mode == "until2" and W < 4:
        raise ValueError("until2 needs columns 2 and 3")
    if exp_lane is not None and not 0 <= exp_lane < W:
        raise ValueError("expiry lane outside the row")
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
        fields, dicts = spec_dev if spec_dev is not None else spec_tensors(spec, dev)
    else:
        fields = dicts = None
    if mode == "block":
        outs = [torch.empty((B, cap, W), dtype=torch.int32, device=dev)]
    elif mode == "any":
        outs = [torch.empty(B, dtype=torch.uint8, device=dev)]
    elif mode == "until2":
        outs = [torch.empty(B, dtype=torch.uint8, device=dev) for _ in range(2)]
    elif mode == "gate":
        outs = [torch.empty((B, cap), dtype=torch.uint8, device=dev)
                for _ in range(2)]
    elif mode == "runs":
        outs = [torch.empty(B, dtype=torch.int32, device=dev)
                for _ in range(2)]
    else:
        raise ValueError(f"unknown probe mode {mode!r}")
    if B == 0:
        return _shaped(mode, outs, shape, cap, W)
    a = _Args(
        q0=qf[0].data_ptr(), q1=qf[1].data_ptr() if nq > 1 else None,
        B=B, off=off.data_ptr(),
        off_a=off_a.data_ptr() if off_a is not None else None,
        size=int(off.shape[0]) - 1, tbl=tbl.data_ptr(), rows=rows,
        fields=fields.data_ptr() if packed else None,
        dicts=dicts.data_ptr() if packed else None,
        out0=outs[0].data_ptr(),
        out1=outs[1].data_ptr() if len(outs) > 1 else None,
        nq=nq, ashift=int(ashift or 0), packed=int(packed), w_raw=w_raw,
        cap=int(cap), W=W, now=int(now or 0),
        lay_exp=-1 if exp_lane is None else int(exp_lane),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(_MODE_ID[mode], ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(f"fused_probe kernel launch failed (cudaError {err})")
    LAUNCHES[mode] += 1
    return _shaped(mode, outs, shape, cap, W)


def _shaped(mode, outs, shape, cap, W):
    """The kernel's flat outputs in the caller's query-lattice shape."""
    if mode == "block":
        return outs[0].reshape(tuple(shape) + (cap, W))
    if mode == "gate":
        return tuple(o.view(torch.bool).reshape(tuple(shape) + (cap,))
                     for o in outs)
    if mode == "runs":
        return tuple(o.reshape(tuple(shape)) for o in outs)
    done = [o.view(torch.bool).reshape(tuple(shape)) for o in outs]
    return done[0] if mode == "any" else tuple(done)
