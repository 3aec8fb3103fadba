"""Time variants of the probe kernels on the card, at main-path-like shapes.

Run from the repository root on a machine with an NVIDIA card and nvcc:

    python3 -m gochugaru_tpu_torch.tools.probe_variants [--other NAME=DIR ...]

Each variant is a kernel source of ``csrc/`` with one change (a text
patch below), built with nvcc into its own library, bound through the
same ctypes seam, held to the plain twin bit for bit on every input (the
breakdown variants, which drop work, are timed only), and timed by the
profiler (device time per launch, mean of 30).  A patch whose anchor is no
longer in the source is reported as skipped.  ``--other NAME=DIR`` adds
the ``csrc/`` of another checkout (e.g. the previous version) as the
variant ``NAME``.  Prints the card line, then one JSON object per
measurement.

Inputs are synthetic, made from seed 1:

- runs: two reverse-index tables built by engine/rev.py, packed as the
  arrow index is (22-bit keys, anchored offsets) and as int32: ``folders``
  (50,000 keys of Poisson(21) rows, the main path's arrow index: a
  folder's documents) and ``small`` (1,000,000 keys of Poisson(2) rows);
  65,536 keys, 30% negative, as a frontier hop sends them;
- gate: a two-level aligned ladder (131,072 and 32,768 rows, caps 6 and
  4, three columns, packed and int32) and 131,072 two-key lanes, the
  shape of the permission fold's probe pair;
- probe (``fused_probe`` mode gate over off+interleave tables built by
  engine/hash.py, packed): an ``ehx``-like edge table (1,000,000 rows of
  (k1, k2, expiry), and of (k1, k2, caveat, context, expiry) as config
  4's, caveat 2 bits and context 13) probed by 131,072 two-key lanes at
  cap 8, half on stored edges, with and without the caveat planes.  The
  gate breakdown variants (stores only, walk only) and the word reads
  patch the gate body both kernels share;
- reduced (modes any and until2 of both kernels, at the main path's
  three shapes and fused_probe's until2): ``any`` over an off+interleave
  int32 table of one key column (200,000 keys, cap 4) and over one
  aligned int32 level (65,536 rows, capT 4), 32,768 one-key lanes; a
  ``clx``-like closure table (200,000 rows of (source, group, until_a,
  until_b), packed) probed by 32,768 two-key lanes under ``until2`` at
  cap 4, and one aligned packed level of such rows (65,536 rows, capT
  3); half the lanes on stored keys.  Each is timed on the warp path,
  on the shared-flag tile (``WARP_REDUCE_CAP`` 0) under each
  ``REDUCE_SLOTS`` of the sweep, as the ``floor`` breakdown (both kernel
  bodies return at once: the same grid and block, no work) on both
  paths, and as each ``--other`` checkout has it (``WARP_REDUCE_CAP`` 0,
  so an older checkout's until2 gets the tile it had), in two rounds in
  turns; each also timed with CUDA events over 30 calls back to back
  (``event_ms``: the kernel and the gap to the next launch, as
  chip_smoke.py times its kernel table).

The engine does not import this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..engine.kernels import build as KB

# ---------------------------------------------------------------------------
# source patches (anchor -> replacement); a missing anchor skips the variant
# ---------------------------------------------------------------------------

_BISECTS = """    const long long lo = bisect(a, start, end, key, steps, true);
    const long long hi = bisect(a, start, end, key, steps, false);
"""

_INTERLEAVED = """    const long long last = a.rows - 1;
    long long lo = start, nl = end - start, hi = start, nh = end - start;
    for (int s = 0; s < steps && (nl > 0 || nh > 0); ++s) {
      const long long hl = nl >> 1, hh = nh >> 1, ml = lo + hl, mh = hi + hh;
      const int32_t vl =
          nl > 0 ? col0_read(a, ml < 0 ? 0 : (ml > last ? last : ml)) : 0;
      const int32_t vh =
          nh > 0 ? col0_read(a, mh < 0 ? 0 : (mh > last ? last : mh)) : 0;
      if (nl > 0) {
        if (vl < key) { lo = ml + 1; nl = nl - hl - 1; } else { nl = hl; }
      }
      if (nh > 0) {
        if (vh <= key) { hi = mh + 1; nh = nh - hh - 1; } else { nh = hh; }
      }
    }
"""

_COUNT = """    {  // count a sorted bucket of <= RUNS_COUNT rows in one round
      const long long n = end - start, last = a.rows - 1;
      if (n <= RUNS_COUNT && n < (1LL << steps)) {
        int32_t v[RUNS_COUNT];
#pragma unroll
        for (int j = 0; j < RUNS_COUNT; ++j) {
          const long long r = start + j;
          v[j] = j < n ? col0_read(a, r < 0 ? 0 : (r > last ? last : r)) : 0;
        }
        int lt = 0, eq = 0;
        bool sorted = true;
#pragma unroll
        for (int j = 0; j < RUNS_COUNT; ++j) {
          if (j < n) {
            lt += v[j] < key;
            eq += v[j] == key;
            if (j > 0) sorted &= v[j - 1] <= v[j];
          }
        }
        if (sorted) {
          ((int32_t*)a.out0)[i] = (int32_t)(start + lt);
          ((int32_t*)a.out1)[i] = eq;
          return;
        }
      }
    }
"""

_SPEC = """    {  // if the bucket is all key, the lower bisect always goes left and
       // the upper always right: both paths' reads are known up front, so
       // issue them at once and check the guess
      const long long last = a.rows - 1;
      long long nl = end - start, nh = end - start, ph = start;
      bool ok = true;
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        if (s < steps && nl > 0) {
          const long long m = start + (nl >> 1);
          ok &= col0_read(a, m < 0 ? 0 : (m > last ? last : m)) >= key;
          nl >>= 1;
        }
        if (s < steps && nh > 0) {
          const long long h2 = nh >> 1, m = ph + h2;
          ok &= col0_read(a, m < 0 ? 0 : (m > last ? last : m)) <= key;
          ph = m + 1;
          nh = nh - h2 - 1;
        }
      }
      if (ok && (steps <= 16 || (nl == 0 && nh == 0))) {
        ((int32_t*)a.out0)[i] = (int32_t)start;
        ((int32_t*)a.out1)[i] = (int32_t)(ph - start);
        return;
      }
    }
"""

_WARM = """    {  // prefetch every 128-byte line of the bucket's rows toward L1
      const long long rb = (long long)a.w_raw * (a.packed ? 2 : 4);
      const uintptr_t t0 = (uintptr_t)a.tbl;
      if (end > start && start >= 0 && end <= a.rows) {
        const uintptr_t l0 = (t0 + start * rb) & ~(uintptr_t)127;
        const uintptr_t l1 = (t0 + end * rb - 1) & ~(uintptr_t)127;
        if (l1 - l0 < 4 * 128)
          for (uintptr_t l = l0; l <= l1; l += 128)
            asm volatile("prefetch.global.L1 [%0];" ::"l"(l));
      }
    }
"""

_GATE_B0 = "    const int2 q = ((const int2*)keys)[c.k];\n"
_GATE_B1 = "    t.live[g0 + p] = live;\n"

_STORES_ONLY = """    t.hit[g0 + p] = 0;
    t.live[g0 + p] = 1;
"""

_WALK_ONLY = """    const void* tbl;
    const long long at = gochugaru_slot_at(t, seg_off, c.k, c.j, tbl);
    t.hit[g0 + p] = (uint8_t)(at + keys[2 * c.k]);
    t.live[g0 + p] = (uint8_t)((uintptr_t)tbl);
"""

_FIELD_READS = """        const uint32_t w0 = gochugaru_field_window(r, f0);
        const uint32_t w1 = gochugaru_field_window(r, f1);
        const uint32_t we = gochugaru_field_window(r, fe);
"""

# the slot's packed lanes as aligned 32-bit words (two for a 3-lane row)
# instead of one 16-bit load a field lane; the synthetic ladders' levels
# are 4-byte aligned with an even element count, so no word passes a
# table's end there
_WORD_READS = """        uint32_t w0, w1, we;
        int lo = 64, hi = 0;
        gv_lanes(f0, lo, hi);
        gv_lanes(f1, lo, hi);
        gv_lanes(fe, lo, hi);
        if (lo <= hi && hi - lo <= 6 && ((uintptr_t)tbl & 3) == 0) {
          const long long wi = (at + lo) >> 1;
          const int nw = (int)(((at + hi) >> 1) - wi) + 1;
          const uint32_t* wp = (const uint32_t*)tbl + wi;
          uint32_t wd[5] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m < nw) wd[m] = wp[m];
          const int u = (int)((at + lo) & 1) - lo;
          w0 = gv_window(wd, f0, (f0[4] >> 4) + u);
          w1 = gv_window(wd, f1, (f1[4] >> 4) + u);
          we = gv_window(wd, fe, (fe[4] >> 4) + u);
        } else {
          w0 = gochugaru_field_window(r, f0);
          w1 = gochugaru_field_window(r, f1);
          we = gochugaru_field_window(r, fe);
        }
"""

_GATE_FN = "template <int PLANES>\n__device__ __forceinline__ void gochugaru_gate_slots("

_WORD_HELPERS = """__device__ __forceinline__ void gv_lanes(const int32_t* f, int& lo, int& hi) {
  if (f[0] == 0) return;
  const int lane = f[4] >> 4;
  lo = min(lo, lane);
  hi = max(hi, lane + ((f[4] & 15) + f[0] > 16 ? 1 : 0));
}

__device__ __forceinline__ uint32_t gv_window(const uint32_t (&wd)[5],
                                              const int32_t* f, int u) {
  if (f[0] == 0) return 0u;
  const int k = u >> 1;
  uint32_t x = wd[0], y = wd[1];
#pragma unroll
  for (int m = 1; m < 4; ++m) {
    if (k == m) {
      x = wd[m];
      y = wd[m + 1];
    }
  }
  return __funnelshift_r(x, y, (u & 1) * 16);
}

"""


# the reduced modes' floor: both kernel bodies return at once (the same
# grid and block, no work)
_WARP_BODY = "gochugaru_warp_reduce_kernel(const GochugaruTile t, const Lanes lanes) {\n"
_TILE_BODY = "gochugaru_slot_tile_kernel(const GochugaruTile t, const Lanes lanes) {\n"


def _replace(text, anchor, new):
    """``text`` with ``anchor`` replaced, or None when it has no anchor."""
    return text.replace(anchor, new) if anchor in text else None


def _gate_body(common, body):
    """probe_common.cuh with the gate's per-slot body replaced by
    ``body``, or None when the anchors are gone."""
    if _GATE_B0 not in common or _GATE_B1 not in common:
        return None
    i = common.index(_GATE_B0)
    j = common.index(_GATE_B1, i) + len(_GATE_B1)
    return common[:i] + body + common[j:]


def runs_variants(fp):
    """{name: fused_probe.cu source or None}."""
    return {
        "bisect": fp,
        "interleaved": _replace(fp, _BISECTS, _INTERLEAVED),
        "count8": _replace(fp, _BISECTS, "#define RUNS_COUNT 8\n" + _COUNT + _BISECTS),
        "count32": _replace(fp, _BISECTS, "#define RUNS_COUNT 32\n" + _COUNT + _BISECTS),
        "speculate": _replace(fp, _BISECTS, _SPEC + _BISECTS),
        "warm": _replace(fp, _BISECTS, _WARM + _BISECTS),
    }


def gate_variants(common):
    """{name: (probe_common.cuh source or None, exact)}."""
    return {
        "kept": (common, True),
        "words": (_replace(_replace(common, _GATE_FN, _WORD_HELPERS + _GATE_FN) or "",
                           _FIELD_READS, _WORD_READS), True),
        "stores_only": (_gate_body(common, _STORES_ONLY), False),
        "walk_no_loads": (_gate_body(common, _WALK_ONLY), False),
    }


def reduced_variants(common):
    """{name: (probe_common.cuh source or None, exact)}."""
    floor = _replace(common or "", _WARP_BODY, _WARP_BODY + "  return;\n")
    return {
        "kept": (common, True),
        "floor": (_replace(floor or "", _TILE_BODY, _TILE_BODY + "  return;\n"), False),
    }


# ---------------------------------------------------------------------------
# build, bind, time
# ---------------------------------------------------------------------------


def _build(tag, name, common, src, workdir):
    d = os.path.join(workdir, tag)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "probe_common.cuh"), "w") as f:
        f.write(common)
    with open(os.path.join(d, name + ".cu"), "w") as f:
        f.write(src)
    out = os.path.join(d, name + ".so")
    cmd = [KB.nvcc(), *KB.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-o", out, os.path.join(d, name + ".cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _bind(path, name, args_type):
    fn = getattr(ctypes.CDLL(path), "gochugaru_" + name)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(args_type), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_ms(fn, kernels, reps: int = 30) -> float:
    """Mean device milliseconds of the kernel whose name holds one of
    ``kernels`` over ``reps`` calls of ``fn`` (torch.profiler, CUDA
    activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if any(k in e.key for k in kernels):
            return e.device_time_total / e.count / 1e3
    raise RuntimeError(f"no kernel named like {kernels!r} ran")


def event_ms(fn, reps: int = 30) -> float:
    """Mean milliseconds a call of ``fn`` over ``reps`` calls back to back
    (CUDA events behind a device sleep that keeps the card busy while the
    host enqueues them, as chip_smoke.py times its kernel table): the
    kernel and the gap to the next launch."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def runs_inputs(dev, rng):
    from ..engine import packed as PK
    from ..engine import rev as RV
    from ..engine.device import to_device_tensor
    from ..engine.partition import _hash_cols
    from ..engine.kernels import spec_tensors

    out = {}
    for name, mean, nk, kmax in (("folders", 21, 50_000, 1_160_000),
                                 ("small", 2, 1_000_000, 3_000_000)):
        k0 = np.repeat(rng.choice(kmax, nk, replace=False).astype(np.int32),
                       rng.poisson(mean, nk))
        k1 = rng.integers(0, kmax, k0.shape[0]).astype(np.int32)
        k2 = rng.integers(0, 8, k0.shape[0]).astype(np.int32)
        h = _hash_cols([k0])
        geom = RV.rev_geom(h, 1)
        off, tbl = RV.build_rev_full(h, [k0, k1, k2], geom, 3)
        cap = RV.rev_meta_kw(geom, geom, None)["rv_cap"]
        spec = PK.make_spec([PK.col_range(-1, kmax), PK.col_range(-1, kmax),
                             PK.col_range(-1, 8)])
        res, anchor = PK.pack_off(off)
        keys = np.where(rng.random(65_536) < 0.7, rng.choice(k0, 65_536),
                        -1).astype(np.int32)
        q = torch.from_numpy(keys).to(dev)
        out[f"{name} packed"] = ((q,), to_device_tensor(res, dev),
                                 to_device_tensor(PK.pack_rows(tbl, spec), dev),
                                 dict(cap=cap, spec=spec, mode="runs",
                                      spec_dev=spec_tensors(spec, dev),
                                      off_a=to_device_tensor(anchor, dev),
                                      ashift=PK.OFF_ANCHOR_SHIFT))
        out[f"{name} int32"] = ((q,), to_device_tensor(off, dev),
                                to_device_tensor(tbl, dev),
                                dict(cap=cap, mode="runs"))
    return out


def gate_inputs(dev, rng):
    from ..engine import packed as PK
    from ..engine.device import to_device_tensor
    from ..engine.kernels import spec_tensors

    sizes, caps, W = (131_072, 32_768), (6, 4), 3
    raws = []
    for s, c in zip(sizes, caps):
        r = np.empty((s * c, W), np.int32)
        r[:, 0] = rng.integers(-1, 400_000, s * c)
        r[:, 1] = rng.integers(-1, 12_000, s * c)
        r[:, 2] = np.where(rng.random(s * c) < 0.9, 0, rng.integers(1, 10_000, s * c))
        raws.append(r)
    spec = PK.make_spec([PK.col_range(-1, 400_000), PK.col_range(-1, 12_000),
                         PK.col_range(-1, 10_000)])
    qs = (torch.from_numpy(rng.integers(0, 400_000, 131_072).astype(np.int32)).to(dev),
          torch.from_numpy(rng.integers(0, 12_000, 131_072).astype(np.int32)).to(dev))
    kw = dict(mode="gate", now=5_000, exp_lane=2)
    return {
        "packed": (qs, [to_device_tensor(PK.pack_rows(r, spec).reshape(s, -1), dev)
                        for r, s in zip(raws, sizes)], caps, spec[1],
                   dict(kw, spec=spec, spec_dev=spec_tensors(spec, dev))),
        "int32": (qs, [to_device_tensor(r.reshape(s, -1), dev)
                       for r, s in zip(raws, sizes)], caps, W, dict(kw)),
    }


def _off_table(dev, rng, cols, descs, cap, lanes, mode, **kw):
    """(q_cols, off, tbl, kw) of one fused_probe call over an off+interleave
    table of ``cols`` built by engine/hash.py (the first min(2, len)
    columns the keys; packed through ``descs``, or int32 when None),
    probed by ``lanes`` lanes, half on stored keys.  The probe reads cap
    rows from each bucket start, whatever the build's own cap."""
    from ..engine import hash as H
    from ..engine import packed as PK
    from ..engine.device import to_device_tensor
    from ..engine.kernels import spec_tensors

    nq = min(2, len(cols))
    hi = H.build_hash(cols[:nq], target_cap=cap)
    raw = H.interleave_buckets(hi, cols)
    qs = _lanes_of(dev, rng, cols[:nq], lanes)
    if descs is None:
        return (qs, to_device_tensor(hi.off, dev), to_device_tensor(raw, dev),
                dict(cap=cap, mode=mode, **kw))
    spec = PK.make_spec(descs)
    res, anchor = PK.pack_off(hi.off)
    return (qs, to_device_tensor(res, dev),
            to_device_tensor(PK.pack_rows(raw, spec), dev),
            dict(cap=cap, spec=spec, spec_dev=spec_tensors(spec, dev),
                 off_a=to_device_tensor(anchor, dev),
                 ashift=PK.OFF_ANCHOR_SHIFT, mode=mode, **kw))


def _lanes_of(dev, rng, keys, lanes):
    """``lanes`` query lanes over key columns ``keys``: half a stored key,
    half a random one in its range."""
    pick = rng.integers(0, keys[0].shape[0], lanes)
    hit = rng.random(lanes) < 0.5
    return tuple(torch.from_numpy(np.where(hit, c[pick],
                                           rng.integers(0, int(c.max()) + 1, lanes))
                                  .astype(np.int32)).to(dev) for c in keys)


def _aligned_level(dev, rng, cols, descs, cap, rows, lanes, mode, **kw):
    """(q_cols, [level], caps, sw, kw) of one fused_probe_aligned call over
    ONE level of ``rows`` rows: each key in its bucket's row (the unsalted
    level-0 hash), the first ``cap`` of a bucket kept, other slots -1;
    packed through ``descs`` or int32 when None; ``lanes`` lanes, half on
    kept keys."""
    from ..engine import packed as PK
    from ..engine.device import to_device_tensor
    from ..engine.kernels import spec_tensors
    from ..engine.partition import _hash_cols

    nq, W = min(2, len(cols)), len(cols)
    h = (_hash_cols(cols[:nq]) & np.uint32(rows - 1)).astype(np.int64)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    rank = np.arange(hs.shape[0]) - np.searchsorted(hs, hs, side="left")
    keep = rank < cap
    slots = np.full((rows * cap, W), -1, np.int32)
    slots[hs[keep] * cap + rank[keep]] = np.stack(cols, 1)[order[keep]]
    qs = _lanes_of(dev, rng, [c[order[keep]] for c in cols[:nq]], lanes)
    if descs is None:
        return (qs, [to_device_tensor(slots.reshape(rows, cap * W), dev)], (cap,), W,
                dict(mode=mode, **kw))
    spec = PK.make_spec(descs)
    return (qs, [to_device_tensor(PK.pack_rows(slots, spec).reshape(rows, -1), dev)],
            (cap,), spec[1], dict(spec=spec, spec_dev=spec_tensors(spec, dev),
                                  mode=mode, **kw))


def probe_inputs(dev, rng):
    """{name: (q_cols, off, tbl, kw)}: fused_probe gate calls shaped as the
    main path's (see the module docstring)."""
    from ..engine import packed as PK

    n = 1_000_000
    k1 = rng.integers(0, 400_000, n).astype(np.int32)
    k2 = rng.integers(0, 12_000, n).astype(np.int32)
    exp = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 10_000, n)).astype(np.int32)
    cav = rng.integers(-1, 3, n).astype(np.int32)
    ctx = np.where(cav > 0, rng.integers(0, 4_096, n), -1).astype(np.int32)
    keys = [PK.col_range(-1, 400_000), PK.col_range(-1, 12_000)]
    gate = dict(now=5_000)
    return {
        "gate ehx": _off_table(dev, rng, [k1, k2, exp],
                               keys + [PK.col_range(-1, 10_000)], 8, 131_072,
                               "gate", exp_lane=2, **gate),
        "gate.cav ehx": _off_table(dev, rng, [k1, k2, cav, ctx, exp],
                                   keys + [PK.col_range(-1, 2), PK.col_range(-1, 4_095),
                                           PK.col_range(-1, 10_000)], 8, 131_072,
                                   "gate", exp_lane=4, cav_lane=2, ctx_lane=3, **gate),
    }


def reduced_inputs(dev, rng):
    """{name: (kernel, args, kw)}: the reduced modes' calls shaped as the
    main path's (see the module docstring); ``args`` are fused_probe's
    (q_cols, off, tbl) or fused_probe_aligned's (q_cols, tbls, caps, sw)."""
    from ..engine import packed as PK
    from ..store.closure import NEVER, NO_EXP

    lanes = 32_768
    key = rng.choice(2_000_000, 200_000, replace=False).astype(np.int32)
    # closure rows: (source, group) keys and two until values from the
    # closure semiring's 2-bit dictionary {NEVER, -1, 0, NO_EXP}
    m = 200_000
    src = rng.integers(0, 100_000, m).astype(np.int32)
    grp = rng.integers(0, 50_000, m).astype(np.int32)
    udict = (int(NEVER), -1, 0, int(NO_EXP))
    until = [rng.choice(np.array(udict, np.int32), m, p=(0.2, 0.0, 0.1, 0.7))
             for _ in range(2)]
    clx = ([src, grp] + until, [PK.col_range(-1, 100_000), PK.col_range(-1, 50_000)]
           + [PK.col_dict(udict)] * 2)

    def off(*a, **kw):
        q, o, t, k = _off_table(dev, rng, *a, **kw)
        return "fused_probe", (q, o, t), k

    def al(*a, **kw):
        q, t, c, sw, k = _aligned_level(dev, rng, *a, **kw)
        return "fused_probe_aligned", (q, t, c, sw), k

    return {
        "any int32": off([key], None, 4, lanes, "any"),
        "until2 clx": off(*clx, 4, lanes, "until2", now=5_000),
        "aligned any int32": al([key], None, 4, 65_536, lanes, "any"),
        "aligned until2 clx": al(*clx, 3, 65_536, lanes, "until2", now=5_000),
    }


RUNS_KERNELS = ("fused_runs",)
GATE_KERNELS = ("slot_tile_kernel<3", "fused_probe_aligned_kernel<3")
#: fused_probe's gate: the slot tile, or the per-lane kernel of an older
#: checkout
PROBE_KERNELS = {"gate": ("slot_tile_kernel<3", "fused_probe_kernel<3")}
#: the reduced modes: the warp path, the shared-flag tile, or an older
#: checkout's per-lane kernels
REDUCED_KERNELS = {m: tuple(k + "<%d" % i for k in (
    "warp_reduce_kernel", "slot_tile_kernel", "fused_probe_kernel",
    "fused_probe_aligned_kernel")) for m, i in (("any", 1), ("until2", 2))}
#: each mode's slots-a-CTA knob and the values it is timed under
SLOTS = {"gate": ("GATE_SLOTS", (512, 1024, 2048, 4096)),
         "reduced": ("REDUCE_SLOTS", (256, 512, 1024))}


def time_reduced(K, libs, others, table, kernel, a, kw):
    """One reduced-mode call on every path, in two rounds in turns: the
    warp path, the shared-flag tile under each REDUCE_SLOTS of SLOTS, the
    floor of both, and each other checkout's kernel under WARP_REDUCE_CAP
    0 and REDUCE_SLOTS 512 (what a checkout without the warp path was
    passed) and again under WARP_REDUCE_CAP 32 (its warp path, if it has
    one; a checkout without it ignores the flag and gets the warp path's
    tile_slots); every exact one held to the plain twin."""
    mode = kw["mode"]
    group = "reduced" if kernel == "fused_probe" else "reduced_al"
    fn = getattr(K, kernel)
    want = fn(*a, plain=True, **kw)
    want = list(want) if isinstance(want, tuple) else [want]
    runs = [("warp", "kept", 32, 512)]
    runs += [("tile", "kept", 0, v) for v in SLOTS["reduced"][1]]
    runs += [("floor warp", "floor", 32, 512), ("floor tile", "floor", 0, 512)]
    runs += [(tag, tag, 0, 512) for tag in others]
    runs += [(tag + " warp", tag, 32, 512) for tag in others]
    for rnd, order in enumerate((runs, runs[::-1])):
        for path, variant, cap, slots in order:
            lib, exact = libs[(group, variant)]
            K._FNS[kernel] = lib
            K.WARP_REDUCE_CAP, K.REDUCE_SLOTS = cap, slots
            call = lambda: fn(*a, **kw)  # noqa: E731
            got = call()
            got = list(got) if isinstance(got, tuple) else [got]
            if exact and not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{kernel}.{mode} {path} != plain on {table}")
            ms = device_ms(call, REDUCED_KERNELS[mode])
            print(json.dumps({"kernel": f"{kernel}.{mode}", "variant": variant,
                              "path": path, "table": table, "round": rnd,
                              "lanes": int(a[0][0].numel()),
                              "capT": int(kw["cap"]) if "cap" in kw else int(sum(a[2])),
                              "tile_slots": slots, "exact": exact, "ms": ms,
                              "event_ms": event_ms(call)}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="root of another checkout whose csrc/ is timed as"
                    " the variant NAME")
    ap.add_argument("--workdir", default=os.path.join(KB.BUILD_DIR, "variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 2
    from ..engine import kernels as K

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")

    def read(root, name):
        with open(os.path.join(root, name)) as f:
            return f.read()

    common = read(KB.CSRC, "probe_common.cuh")
    fp = read(KB.CSRC, "fused_probe.cu")
    fa = read(KB.CSRC, "fused_probe_aligned.cu")
    todo = [("runs", k, "fused_probe", common, src, True)
            for k, src in runs_variants(fp).items()]
    for group, name, src in (("gate", "fused_probe_aligned", fa),
                             ("probe", "fused_probe", fp)):
        todo += [(group, k, name, c, src, exact)
                 for k, (c, exact) in gate_variants(common).items()]
    for group, name, src in (("reduced", "fused_probe", fp),
                             ("reduced_al", "fused_probe_aligned", fa)):
        todo += [(group, k, name, c, src, exact)
                 for k, (c, exact) in reduced_variants(common).items()]
    others = []
    for spec in args.other:
        tag, root = spec.split("=", 1)
        others.append(tag)
        oc = os.path.join(root, "gochugaru_tpu_torch", "csrc")
        for group, name in (("runs", "fused_probe"), ("gate", "fused_probe_aligned"),
                            ("probe", "fused_probe"), ("reduced", "fused_probe"),
                            ("reduced_al", "fused_probe_aligned")):
            todo.append((group, tag, name, read(oc, "probe_common.cuh"),
                         read(oc, name + ".cu"), True))
    built = {}
    for group, k, name, c, src, exact in todo:
        if c is None or src is None:
            print(json.dumps({"group": group, "variant": k,
                              "skipped": "patch anchor not in the source"}))
            continue
        built[(group, k)] = (name, exact) + _build(f"{group}.{k}", name, c, src,
                                                   args.workdir)
    libs = {}
    for key, (name, exact, path, proc) in built.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = (_bind(path, name, K._Args if name == "fused_probe"
                           else K._AlignedArgs), exact)
    K._launcher()
    K._aligned_launcher()
    rng = np.random.default_rng(1)
    saved = dict(K._FNS)
    knobs = {k: getattr(K, k) for k in ("GATE_SLOTS", "REDUCE_SLOTS", "WARP_REDUCE_CAP")}
    try:
        for table, (q, off, tbl, kw) in runs_inputs(dev, rng).items():
            want = K.fused_probe(q, off, tbl, plain=True, **kw)
            for (group, k), (fn, _exact) in libs.items():
                if group != "runs":
                    continue
                K._FNS["fused_probe"] = fn
                got = K.fused_probe(q, off, tbl, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"runs {k} != plain on {table}")
                ms = device_ms(lambda: K.fused_probe(q, off, tbl, **kw), RUNS_KERNELS)
                print(json.dumps({"kernel": "fused_probe.runs", "variant": k,
                                  "table": table, "keys": int(q[0].numel()),
                                  "cap": kw["cap"], "ms": ms}), flush=True)
        for table, (qs, tbls, caps, sw, kw) in gate_inputs(dev, rng).items():
            want = K.fused_probe_aligned(qs, tbls, caps, sw, plain=True, **kw)
            for (group, k), (fn, exact) in libs.items():
                if group != "gate":
                    continue
                K._FNS["fused_probe_aligned"] = fn
                for slots in SLOTS["gate"][1]:
                    K.GATE_SLOTS = slots
                    call = lambda: K.fused_probe_aligned(qs, tbls, caps, sw, **kw)  # noqa: E731
                    if exact and not all(torch.equal(a, b) for a, b in zip(call(), want)):
                        raise AssertionError(f"gate {k} != plain on {table}")
                    ms = device_ms(call, GATE_KERNELS)
                    print(json.dumps({"kernel": "fused_probe_aligned.gate", "variant": k,
                                      "table": table, "lanes": int(qs[0].numel()),
                                      "caps": list(caps), "tile_slots": slots,
                                      "exact": exact, "ms": ms}), flush=True)
        # fused_probe gate: each variant in turns (kept, the others, then
        # again in reverse order), so a drift of the card shows as a
        # spread rather than as a difference
        for table, (qs, off, tbl, kw) in probe_inputs(dev, rng).items():
            mode = kw["mode"]
            knob, values = SLOTS[mode]
            want = K.fused_probe(qs, off, tbl, plain=True, **kw)
            keys = [key for key in libs if key[0] == "probe"]
            for rnd, order in enumerate((keys, keys[::-1])):
                for key in order:
                    fn, exact = libs[key]
                    K._FNS["fused_probe"] = fn
                    for slots in values:
                        setattr(K, knob, slots)
                        call = lambda: K.fused_probe(qs, off, tbl, **kw)  # noqa: E731
                        if exact and not all(torch.equal(a, b)
                                             for a, b in zip(call(), want)):
                            raise AssertionError(f"{mode} {key[1]} != plain on {table}")
                        ms = device_ms(call, PROBE_KERNELS[mode])
                        print(json.dumps({"kernel": f"fused_probe.{mode}",
                                          "variant": key[1], "table": table,
                                          "round": rnd, "lanes": int(qs[0].numel()),
                                          "cap": kw["cap"], "tile_slots": slots,
                                          "exact": exact, "ms": ms}), flush=True)
        for table, (kernel, a, kw) in reduced_inputs(dev, rng).items():
            time_reduced(K, libs, others, table, kernel, a, kw)
    finally:
        K._FNS.update(saved)
        for k, v in knobs.items():
            setattr(K, k, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
