"""The probe kernels' byte rule: a frozen copy of ``chip_smoke.py``'s
``probe_bound`` and of the bucket hash it needs, so that the yardstick does
not move with the program.

One ``fused_probe`` call needs, at the least: every distinct table row its
queries' buckets reach read once, every distinct bucket offset (and anchor)
read once, the queries read once and the outputs written once.  Over the
published HBM3 bandwidth of an H100 SXM, that is the least time the call
can take; against its integer operations over the 32-bit rate, the larger
of the two is its bound.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT_OPS_PER_S = 67e12  # non-tensor 32-bit rate, H100 SXM data sheet

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_M32 = 0xFFFFFFFF


def _mul32(h, m: int):
    lo = (h * (m & 0xFFFF)) & _M32
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def bucket_of(cols, size: int):
    """FNV-1a over int32 words, murmur3's finalizer, masked to ``size``
    (a power of two) buckets."""
    import torch

    h = torch.full((), _FNV_OFFSET, dtype=torch.int64)
    for c in cols:
        h = _mul32(h ^ (c.to(torch.int64) & _M32), _FNV_PRIME)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & (size - 1)


def _gate_out_bytes(kw) -> int:
    return 2 + 4 * ((kw.get("cav_lane") is not None) + (kw.get("ctx_lane") is not None))


def probe_bound_ms(q_cols, off, tbl, kw) -> float:
    """The least milliseconds of one ``fused_probe`` call (the bytes its
    data needs, or its operations, whichever bounds it)."""
    import torch

    cap, mode = kw["cap"], kw.get("mode", "block")
    shape = torch.broadcast_shapes(*[tuple(c.shape) for c in q_cols])
    qs = [c.expand(shape).reshape(-1) for c in q_cols]
    B = qs[0].shape[0]
    h = bucket_of(qs, int(off.shape[0]) - 1)
    if kw.get("off_a") is not None:
        start = kw["off_a"][h >> kw["ashift"]].long() + (off[h].long() & 0xFFFF)
        n_anchor = int(torch.unique(h >> kw["ashift"]).numel())
    else:
        start = off[h].long()
        n_anchor = 0
    s = start.clamp(0, int(tbl.shape[0]) - cap)
    rows = torch.unique((s.unsqueeze(-1) + torch.arange(cap, device=s.device)).reshape(-1))
    row_bytes = int(tbl.shape[1]) * tbl.element_size()
    spec = kw.get("spec")
    W = int(spec[0]) if spec is not None else int(tbl.shape[1])
    out_bytes = {"block": B * cap * W * 4, "any": B, "until2": 2 * B,
                 "gate": _gate_out_bytes(kw) * B * cap}[mode]
    nbytes = (int(rows.numel()) * row_bytes
              + int(torch.unique(h).numel()) * off.element_size()
              + n_anchor * 4 + B * len(qs) * 4 + out_bytes)
    # per lane: ~12 hash ops, 4 offset ops, per row ~6 decode ops a column
    # plus 4 compare/fold ops
    ops = B * (16 + cap * (6 * W + 4))
    return max(nbytes / H100_BYTES_PER_S, ops / H100_INT_OPS_PER_S) * 1e3


#: probe calls of the traced window whose bounds are worked out
RECORDED_CALLS = 16


class ProbeRecorder:
    """Wraps the program's ``fused_probe`` seam while armed and keeps the
    arguments of the first ``limit`` calls, whose bounds are worked out
    after the window."""

    def __init__(self, limit: int = RECORDED_CALLS) -> None:
        self.limit = limit
        self.calls = []
        self.armed = False
        self._mod = self._orig = None

    def install(self) -> None:
        from gochugaru_tpu_torch.engine import kernels

        self._mod, self._orig = kernels, kernels.fused_probe
        orig = self._orig

        def fused_probe(q_cols, off, tbl, **kw):
            if self.armed and len(self.calls) < self.limit:
                self.calls.append((list(q_cols), off, tbl, dict(kw)))
            return orig(q_cols, off, tbl, **kw)

        kernels.fused_probe = fused_probe

    def uninstall(self) -> None:
        if self._mod is not None:
            self._mod.fused_probe = self._orig
            self._mod = None

    def mean_bound_ms(self):
        """The mean bound of the recorded calls (None when none ran)."""
        if not self.calls:
            return None
        n = len(self.calls)
        total = sum(probe_bound_ms(q, off, tbl, kw) for q, off, tbl, kw in self.calls)
        self.calls = []
        return total / n
