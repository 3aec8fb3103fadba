"""Plain PyTorch twin of the fused probe kernel.

The same function as ``csrc/fused_probe.cu``, written as the reference's
gather chain (gochugaru_tpu/engine/flat.py with ``pallas=False``):
``probe_block`` + ``decode_block`` + the probe site's own compare and gate
folds.  On the CPU it is what the engine runs; on the card only the
parity harness and ``EngineConfig(kernels=False)`` use it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..hash import probe_block
from ..packed import decode_block


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
    now: Optional[int] = None,
    exp_lane: Optional[int] = None,
):
    """One bucket probe over the off+interleave layout; see
    ``kernels.fused_probe`` for the modes and outputs."""
    shape = torch.broadcast_shapes(*[tuple(c.shape) for c in q_cols])
    qs = [c.expand(shape) for c in q_cols]
    raw = probe_block(off, tbl, cap, qs, off_a=off_a, ashift=ashift)
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
        return hit, live
    raise ValueError(f"unknown probe mode {mode!r}")
