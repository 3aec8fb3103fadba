"""Plain PyTorch twins of the fused probe kernels.

The same functions as ``csrc/fused_probe.cu`` and
``csrc/fused_probe_aligned.cu``, written as the reference's gather chain
(gochugaru_tpu/engine/flat.py with ``pallas=False``): ``probe_block``
(off+interleave) or ``probe_aligned`` (the bucket-aligned ladder) +
``decode_block`` + the probe site's own compare and gate folds, shared by
both twins (``_tail``); and for the ``runs`` mode the point-run bisect of
gochugaru_tpu/engine/spmv.py ``_make_runs``.  On the CPU they are what
the engine runs; on the card only the parity harness and
``EngineConfig(kernels=False)`` use them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..hash import bucket_of, probe_aligned, probe_block
from ..packed import _i32, decode_block


def blk_hit(blk, q_cols: Sequence):
    """Exact-key hit mask over a probe block's candidates, with ≥0
    validity guards on every query column (padded/overshoot rows hold -1
    keys or other buckets' keys and never match)."""
    h = torch.ones(blk.shape[:-1], dtype=torch.bool, device=blk.device)
    g = None
    for j, qc in enumerate(q_cols):
        h = h & (blk[..., j] == qc.unsqueeze(-1))
        g = (qc >= 0) if g is None else (g & (qc >= 0))
    return h & g.unsqueeze(-1)


def fused_probe_plain(
    q_cols: Sequence,
    off,
    tbl,
    *,
    cap: int,
    spec=None,
    off_a=None,
    ashift: Optional[int] = None,
    mode: str = "block",
    now: Optional[Union[int, torch.Tensor]] = None,
    exp_lane: Optional[int] = None,
    cav_lane: Optional[int] = None,
    ctx_lane: Optional[int] = None,
):
    """One bucket probe over the off+interleave layout; see
    ``kernels.fused_probe`` for the modes and outputs."""
    if mode == "runs":
        if len(q_cols) != 1:
            raise ValueError("the runs probe takes one key column")
        return runs_plain(q_cols[0], off, tbl, cap=cap, spec=spec,
                          off_a=off_a, ashift=ashift)
    qs = _lattice(q_cols)
    raw = probe_block(off, tbl, cap, qs, off_a=off_a, ashift=ashift)
    return _tail(raw, qs, spec, mode, now, exp_lane, cav_lane, ctx_lane)


def fused_probe_aligned_plain(
    q_cols: Sequence,
    tbls: Sequence,
    caps: Sequence[int],
    sw: int,
    *,
    spec=None,
    mode: str = "block",
    now: Optional[Union[int, torch.Tensor]] = None,
    exp_lane: Optional[int] = None,
    cav_lane: Optional[int] = None,
    ctx_lane: Optional[int] = None,
):
    """One probe over the bucket-aligned ladder (one row per level,
    levels concatenated to ``sum(caps)`` slots); see
    ``kernels.fused_probe_aligned`` for the modes and outputs."""
    if mode == "runs":
        raise ValueError("the aligned probe has no runs mode")
    qs = _lattice(q_cols)
    return _tail(probe_aligned(tbls, caps, sw, qs), qs, spec, mode, now,
                 exp_lane, cav_lane, ctx_lane)


def broadcast_shape(*shapes) -> Tuple[int, ...]:
    """The shape ``shapes`` broadcast to, as ``torch.broadcast_shapes``
    gives it, but numpy's: torch's imports sympy on its first call, which
    costs seconds of a process's first check."""
    return np.broadcast_shapes(*(tuple(s) for s in shapes))


def _lattice(q_cols: Sequence):
    """The query columns broadcast to one lattice shape."""
    shape = broadcast_shape(*(c.shape for c in q_cols))
    return [c.expand(shape) for c in q_cols]


def check_planes(mode: str, cav_lane, ctx_lane) -> None:
    """The caveat planes are the gate's, and the context plane comes only
    beside the caveat plane (the reference's gate triple)."""
    if (cav_lane is not None or ctx_lane is not None) and mode != "gate":
        raise ValueError("only mode gate returns the caveat planes")
    if ctx_lane is not None and cav_lane is None:
        raise ValueError("a context lane needs the caveat lane")


def _tail(raw, qs, spec, mode: str, now, exp_lane, cav_lane=None,
          ctx_lane=None):
    """Decode a raw candidate block, then the mode's compare and folds —
    the part both probe layouts share.  The gate's caveat planes are the
    reference's gate triple (pallas.py:355-359): the caveat-id column
    where the slot hit (else 0), and the stored-context column where it
    hit (else -1)."""
    check_planes(mode, cav_lane, ctx_lane)
    blk = raw.to(torch.int32) if spec is None else decode_block(raw, spec)
    if mode == "block":
        return blk
    hit = blk_hit(blk, qs)
    if mode == "any":
        return hit.any(dim=-1)
    if mode == "until2":
        return (
            (hit & (blk[..., 2] > now)).any(dim=-1),
            (hit & (blk[..., 3] > now)).any(dim=-1),
        )
    if mode == "gate":
        live = hit
        if exp_lane is not None:
            exp = torch.where(hit, blk[..., exp_lane], 0)
            live = hit & ((exp == 0) | (exp > now))
        if cav_lane is None:
            return hit, live
        cav = torch.where(hit, blk[..., cav_lane], 0)
        if ctx_lane is None:
            return hit, live, cav
        return hit, live, cav, torch.where(hit, blk[..., ctx_lane], -1)
    raise ValueError(f"unknown probe mode {mode!r}")


def field0_spec(spec):
    """(bits, base) of a packed table's column 0, which the run bisect
    reads alone: reverse-index key columns are plain ranges at bit 0."""
    bits, base, delta_of, dict_id, off_bit = spec[2][0]
    if off_bit != 0 or delta_of >= 0 or dict_id >= 0:
        raise ValueError("runs: column 0 must be a plain range at bit 0")
    return int(bits), int(base)


def col0_reader(tbl, spec=None):
    """``idx -> column 0 of rows idx`` (int32) of an int32 table, or of a
    packed one whose column 0 is a plain range at bit 0 (lane 0, and lane
    1 when it has more than 16 bits)."""
    if spec is None:
        return lambda idx: tbl[idx, 0]
    bits, base = field0_spec(spec)

    def col0(idx):
        v = tbl[idx, 0].to(torch.int32) & 0xFFFF
        if bits > 16:
            v = v | ((tbl[idx, 1].to(torch.int32) & 0xFFFF) << 16)
        if bits < 32:
            v = v & ((1 << bits) - 1)
        return v + _i32(base) if base else v

    return col0


def runs_plain(keys, off, tbl, *, cap: int, spec=None, off_a=None,
               ashift: Optional[int] = None, rows_read: Optional[list] = None):
    """The point-run probe: per key, its bucket ``[start, end)`` from
    ``off[h]``/``off[h + 1]`` (anchor + residual when packed), then two
    bisects over column 0 inside the bucket — ``steps =
    max(cap.bit_length(), 1)`` iterations, each frozen once its range is
    empty, reading ``clip(mid, 0, rows - 1)`` — giving the key's run
    ``(lo, ln)`` as int32.  Keys < 0 give ``(0, 0)``.  Restates
    gochugaru_tpu/engine/spmv.py ``_make_runs`` and its field-0 reader.

    When ``rows_read`` is a list, each bisect step appends the table rows
    it reads for keys >= 0 whose range is not yet empty (the rows a bytes
    bound must count)."""
    size = int(off.shape[0]) - 1
    h = bucket_of([keys], size)

    def off_at(i):
        if off_a is None:
            return off[i].to(torch.int64)
        return off_a[i >> ashift].to(torch.int64) + (off[i].to(torch.int64) & 0xFFFF)

    col0 = col0_reader(tbl, spec)
    start, end = off_at(h), off_at(h + 1)
    last = int(tbl.shape[0]) - 1
    steps = max(int(cap).bit_length(), 1)
    k = keys.to(torch.int32)

    def bisect(left: bool):
        lo = start
        n = end - start
        for _ in range(steps):
            # n == 0 must freeze: an unguarded step would read past the
            # bucket end and walk lo out of the run
            alive = n > 0
            half = n >> 1
            mid = lo + half
            if rows_read is not None:
                rows_read.append(mid[alive & (k >= 0)])
            v = col0(mid.clamp(0, last))
            go = alive & ((v < k) if left else (v <= k))
            lo = torch.where(go, mid + 1, lo)
            n = torch.where(go, n - half - 1, torch.where(alive, half, 0))
        return lo

    lo = bisect(True)
    ln = bisect(False) - lo
    dead = k < 0
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    return (torch.where(dead, zero, lo).to(torch.int32),
            torch.where(dead, zero, ln).to(torch.int32))
