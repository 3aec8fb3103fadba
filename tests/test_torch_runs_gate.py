"""The runs probe and the aligned gate's slot tile: what the CPU can check
of them.

On a card ``fused_probe`` mode ``runs`` runs the reference's two bisects,
one thread a key, and ``fused_probe_aligned`` mode ``gate`` runs the slot
tile of ``csrc/probe_common.cuh`` with ``kernels.gate_tile``'s geometry.
Here:

- on the port's reverse-index tables (engine/rev.py, int32 and packed,
  several seeds): every bucket sorted by signed column 0, and
  ``runs_plain`` equal to ``(start + #(col0 < key), #(col0 == key))`` for
  every key whose bucket has fewer than ``2^steps`` rows (what a count of
  the bucket's rows would give), but not always under a cap below a
  bucket;
- chip_smoke.py's runs edge tables (buckets of 0, 1, 7, 8, 9 rows, 16-
  and 22-bit packed keys, anchor-straddling offsets, shuffled buckets),
  and the plain twin on them against a numpy restatement of the two
  frozen bisects, truncated ones included;
- ``gate_tile``'s geometry for 1-8 levels, capT 1-64 and past one tile;
- the plain aligned gate against the reference's XLA chain at the slot
  tile's edge shapes (B 1 and 255, an 8-level ladder, a lane longer than
  a tile, ``exp_lane`` None);
- the ctypes mirrors of the kernels' argument structs against the C
  sources, field by field.

Every output is int or bool: exact equality, here and in the
``cuda``-marked tests, which hold the kernels to the plain twins on a
card (chip_smoke.py's phases 3 and 3c run the same comparisons there).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as CS
import test_torch_block_tile as TB
from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine import packed as JPK
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine import packed as PK
from gochugaru_tpu_torch.engine import rev as RV
from gochugaru_tpu_torch.engine.device import to_device_tensor
from gochugaru_tpu_torch.engine.kernels.plain import col0_reader, runs_plain
from gochugaru_tpu_torch.engine.partition import _hash_cols

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, os.pardir, "csrc")


# ---------------------------------------------------------------------------
# runs: the counting branch's premise and the two-branch model
# ---------------------------------------------------------------------------


def _rev_table(seed, packed, heavy=1_500):
    """A reverse-index table from engine/rev.py: one ``heavy``-row key,
    random keys of 22 bits, a payload column; keys mixing present,
    absent and negative."""
    rng = np.random.default_rng(seed)
    k0 = np.concatenate([np.full(heavy, 9, np.int32),
                         rng.integers(0, 3_000_000, 4_000).astype(np.int32)])
    k1 = rng.integers(0, 70_000, k0.shape[0]).astype(np.int32)
    h = _hash_cols([k0])
    geom = RV.rev_geom(h, 1)
    off, tbl = RV.build_rev_full(h, [k0, k1], geom, 2)
    cap = RV.rev_meta_kw(geom, geom, None)["rv_cap"]
    keys = np.concatenate([rng.choice(k0, 3_000),
                           rng.integers(-3, 3_000_100, 3_000)]).astype(np.int32)
    t = dict(off=off, tbl=tbl, col0=tbl[:, 0], cap=cap, keys=keys, spec=None,
             off_a=None, ashift=None, off_full=off)
    if packed:
        spec = PK.make_spec([PK.col_range(-1, 3_000_000), PK.col_range(-1, 70_000)])
        res, anchor = PK.pack_off(off)
        t.update(tbl=PK.pack_rows(tbl, spec), spec=spec, off=res, off_a=anchor,
                 ashift=PK.OFF_ANCHOR_SHIFT)
    return t


def _plain_runs(t, cap=None):
    lo, ln = runs_plain(
        torch.from_numpy(t["keys"]), to_device_tensor(t["off"], "cpu"),
        to_device_tensor(t["tbl"], "cpu"), cap=t["cap"] if cap is None else cap,
        spec=t["spec"],
        off_a=None if t["off_a"] is None else to_device_tensor(t["off_a"], "cpu"),
        ashift=t["ashift"])
    return lo.numpy(), ln.numpy()


def _buckets(t):
    keys = t["keys"]
    size = t["off_full"].shape[0] - 1
    h = (_hash_cols([keys]) & np.uint32(size - 1)).astype(np.int64)
    return t["off_full"][h].astype(np.int64), t["off_full"][h + 1].astype(np.int64)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_rev_buckets_are_sorted_and_counting_equals_the_bisect(packed, seed):
    t = _rev_table(seed, packed)
    off, col0 = t["off_full"], t["col0"]
    # the packed column 0, as the kernel decodes it, is the int32 one
    read = col0_reader(to_device_tensor(t["tbl"], "cpu"), t["spec"])
    assert np.array_equal(read(torch.arange(col0.shape[0])).numpy(), col0)
    for b in range(off.shape[0] - 1):
        run = col0[off[b]:off[b + 1]]
        assert (run[1:] >= run[:-1]).all(), b
    lo, ln = _plain_runs(t)
    start, end = _buckets(t)
    steps = max(int(t["cap"]).bit_length(), 1)
    keys = t["keys"]
    short = (keys >= 0) & (end - start < (1 << steps))
    assert short.sum() == (keys >= 0).sum() > 0  # cap bounds every bucket
    for i in np.flatnonzero(short):
        run = col0[start[i]:end[i]]
        assert lo[i] == start[i] + (run < keys[i]).sum(), i
        assert ln[i] == (run == keys[i]).sum(), i
    assert (lo[keys < 0] == 0).all() and (ln[keys < 0] == 0).all()
    assert ln.max() >= 1_500  # the heavy key's run


def test_counting_differs_from_a_bisect_capped_below_a_bucket():
    t = _rev_table(4, False, heavy=3_000)
    lo, ln = _plain_runs(t, cap=2)  # 2 steps: buckets of >= 4 rows truncate
    start, end = _buckets(t)
    keys = t["keys"]
    wrong = 0
    for i in np.flatnonzero(keys >= 0):
        run = t["col0"][start[i]:end[i]]
        wrong += ln[i] != (run == keys[i]).sum()
    assert wrong > 0


def test_runs_edge_tables_plant_every_bucket_size():
    """chip_smoke.py's runs edge tables: buckets of 0, 1, 7, 8 and 9 rows,
    queried; the wide key range decodes from two lanes, the narrow from
    one; some queried bucket pair straddles two offset anchors; caps 4
    and 2 truncate some bisects, the tables' own cap none."""
    for name, (keys, cap, sizes, layouts) in CS.runs_edge_tables("cpu").items():
        assert sizes == sorted(CS.RUNS_EDGE_SIZES)
        off = layouts["int32"]["off_full"]
        start, end = _buckets(dict(keys=keys, off_full=off))
        assert set(sizes) <= set((end - start)[keys >= 0].tolist()), name
        bits = layouts["packed"]["spec"][2][0][0]
        assert (bits > 16) == (name == "wide"), bits
        size = off.shape[0] - 1
        h = (_hash_cols([keys]) & np.uint32(size - 1)).astype(np.int64)
        assert ((h + 1) % (1 << PK.OFF_ANCHOR_SHIFT) == 0).any(), name
        assert CS.runs_truncated(keys, off, cap) == 0
        assert CS.runs_truncated(keys, off, 4) > 0


@pytest.mark.parametrize("layout", ["int32", "packed", "unsorted"])
def test_plain_runs_at_the_edges_matches_its_bisect(layout):
    """The plain twin on the edge tables against a numpy restatement of
    the reference's two frozen bisects, under the tables' cap and under
    caps 4 and 2 (truncated), shuffled buckets included."""
    keys, cap, _sizes, layouts = CS.runs_edge_tables("cpu")["narrow"]
    lay = layouts[layout]
    col0 = col0_reader(lay["tbl"], lay["spec"])(torch.arange(lay["tbl"].shape[0])).numpy()
    t = dict(keys=keys, off=lay["off"].numpy(), tbl=lay["tbl"].numpy(), spec=lay["spec"],
             off_a=None if lay["off_a"] is None else lay["off_a"].numpy(),
             ashift=lay["ashift"], cap=cap, off_full=lay["off_full"])
    start, end = _buckets(t)
    last = col0.shape[0] - 1
    for cp in (cap, 4, 2):
        steps = max(int(cp).bit_length(), 1)
        lo, ln = _plain_runs(t, cap=cp)
        for i in range(0, keys.shape[0], 7):
            if keys[i] < 0:
                assert lo[i] == 0 and ln[i] == 0
                continue
            bounds = []
            for left in (True, False):
                b, n = int(start[i]), int(end[i] - start[i])
                for _ in range(steps):
                    if n <= 0:
                        break
                    half = n >> 1
                    v = col0[min(max(b + half, 0), last)]
                    if (v < keys[i]) if left else (v <= keys[i]):
                        b, n = b + half + 1, n - half - 1
                    else:
                        n = half
                bounds.append(b)
            assert (lo[i], ln[i]) == (bounds[0], bounds[1] - bounds[0]), (i, cp)


# ---------------------------------------------------------------------------
# the aligned gate's slot tile: geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", CS.GATE_SWEEP)
@pytest.mark.parametrize("nseg", range(1, K.MAXL + 1))
def test_gate_tile_geometry(nseg, slots, monkeypatch):
    monkeypatch.setattr(K, "GATE_SLOTS", slots)
    for capT in sorted(set(range(nseg, 65)) | {slots - 1, slots, slots + 1,
                                                2 * slots + 3}):
        S, lanes, smem = K.gate_tile(capT, nseg)
        case = (capT, nseg, S, lanes, smem)
        assert S == slots and smem == lanes * (nseg * 8 + 8) <= K.SMEM_MAX, case
        B = 2 * capT // np.gcd(S, capT) + 3
        g0, n, touched = TB._tiles(S, capT, B)
        assert int(n.sum()) == B * capT and (g0[1:] == g0[:-1] + n[:-1]).all(), case
        assert int(touched.max()) <= lanes, case
        if len(g0) > 2 * capT:  # every start residue occurs
            assert int(touched.max()) == lanes, case
        if capT > S:  # a lane longer than a tile: walked in chunks
            assert lanes == 2, case


def test_gate_tile_reads_its_budget_at_call_time(monkeypatch):
    assert K.gate_tile(10, 2)[0] == K.GATE_SLOTS
    monkeypatch.setattr(K, "GATE_SLOTS", 256)
    assert K.gate_tile(10, 2) == (256, 27, 27 * 24)


# ---------------------------------------------------------------------------
# the plain aligned gate vs the reference's XLA chain at the tile's edges
# ---------------------------------------------------------------------------


def _gate_ladder(W, caps, packed, seed, nq, B):
    """Synthetic levels (chip_smoke.py phase 3c's recipe: edge_spec rows,
    every other lane's keys planted past level 0, a third of those with
    expiry 0 in column 7 when W is 16) and ``nq`` key columns of ``B``
    lanes."""
    rng = np.random.default_rng(seed)
    sizes = [max(256 >> (2 * l), 8) for l in range(len(caps))]
    spec, _ = TB._spec_rows(W, rng, 1)
    raws = [TB._spec_rows(W, rng, s * c)[1] for s, c in zip(sizes, caps)]
    qs = CS._gate_queries(rng, B, nq)
    CS.plant_hits(raws, caps, qs, rng, spec, CS.GATE_EXP[W][0] if W == 16 else None)
    if packed:
        return ([JPK.pack_rows(r, spec).reshape(s, -1) for r, s in zip(raws, sizes)],
                spec[1], spec, qs)
    return [r.reshape(s, c * W) for r, s, c in zip(raws, sizes, caps)], W, None, qs


def _ref_gate(tbls, caps, sw, spec, qs, exp_lane, now):
    blk = JH.probe_aligned([jnp.asarray(x) for x in tbls], caps, sw,
                           tuple(jnp.asarray(q) for q in qs))
    blk = np.asarray(blk if spec is None else JPK.decode_block(blk, spec))
    hit = np.ones(blk.shape[:-1], bool)
    for j, q in enumerate(qs):
        hit &= (blk[..., j] == q[:, None]) & (q >= 0)[:, None]
    live = hit
    if exp_lane is not None:
        e = np.where(hit, blk[..., exp_lane], 0)
        live = hit & ((e == 0) | (e > now))
    return hit, live


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("W", TB.EDGE_W)
def test_plain_aligned_gate_matches_reference_at_edges(W, packed):
    exp_col, now = CS.GATE_EXP[W]
    ladders = [(8, 3, 1), TB.LADDER_8, (2 * K.GATE_SLOTS + 3, 1)]
    hits = expired = 0
    for i, caps in enumerate(ladders):
        for nq in (1, 2)[:W]:
            tbls, sw, spec, qs = _gate_ladder(W, caps, packed, 40 * W + i, nq, 255)
            for B in (1, 255):
                for e in (exp_col, None):
                    got = K.fused_probe_aligned(
                        tuple(torch.from_numpy(q[:B]) for q in qs),
                        [to_device_tensor(x, "cpu") for x in tbls], caps, sw,
                        spec=spec, mode="gate", now=now, exp_lane=e)
                    want = _ref_gate(tbls, caps, sw, spec, [q[:B] for q in qs], e, now)
                    for a, b in zip(got, want):
                        assert a.dtype == torch.bool and a.shape == (B, sum(caps))
                        assert np.array_equal(a.numpy(), b), (caps, nq, B, e)
                    if e is not None:
                        hits += int(want[0].sum())
                        expired += int((want[0] & ~want[1]).sum())
    assert hits and (expired or W == 1)


# ---------------------------------------------------------------------------
# the ctypes mirrors against the C structs
# ---------------------------------------------------------------------------

_C_TYPES = {"long long": ctypes.c_longlong, "int": ctypes.c_int}


def _c_struct(source, name):
    """[(field, ctypes type)] of ``struct name`` in ``csrc/<source>``:
    every pointer is a c_void_p, ``T x[N]`` an array."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.fullmatch(r"(?:const )?([A-Za-z_][\w ]*?)\s*(\*?)\s*(\w+)(?:\[(\w+)\])?",
                         decl)
        assert m, decl
        ctype, ptr, field, n = m.groups()
        if ptr:
            t = ctypes.c_void_p
        elif ctype in _C_TYPES:
            t = _C_TYPES[ctype]
        else:
            t = ctype  # a nested struct, compared by name
        if n:
            t = (t, n)
        fields.append((field, t))
    return fields


def _py_fields(cls):
    out = []
    for field, t in cls._fields_:
        if isinstance(t, type) and issubclass(t, ctypes.Array):
            inner = t._type_
            name = {K._Level: "AlignedLevel"}.get(inner, inner)
            out.append((field, (name, t._length_)))
        else:
            out.append((field, t))
    return out


@pytest.mark.parametrize("source,name,cls", [
    ("fused_probe.cu", "ProbeArgs", K._Args),
    ("fused_probe_aligned.cu", "AlignedArgs", K._AlignedArgs),
    ("fused_probe_aligned.cu", "AlignedLevel", K._Level),
])
def test_ctypes_mirrors_match_the_c_structs(source, name, cls):
    consts = {"GOCHUGARU_MAXL": K.MAXL}
    want = [(f, (t[0], consts.get(t[1], t[1])) if isinstance(t, tuple) else t)
            for f, t in _c_struct(source, name)]
    assert _py_fields(cls) == want


def test_ctypes_mirrors_carry_the_gate_planes():
    """Both args structs carry the gate's caveat and context planes and
    their lanes (out2/out3, lay_cav/lay_ctx), on the C side and in the
    mirror, in the same places."""
    for source, name, cls in (("fused_probe.cu", "ProbeArgs", K._Args),
                              ("fused_probe_aligned.cu", "AlignedArgs",
                               K._AlignedArgs)):
        c = [f for f, _t in _c_struct(source, name)]
        py = [f for f, _t in cls._fields_]
        for f in ("out2", "out3", "lay_cav", "lay_ctx"):
            assert f in c and c.index(f) == py.index(f), (name, f)
        assert c.index("out3") == c.index("out2") + 1 == c.index("out1") + 2
        assert c.index("lay_ctx") == c.index("lay_cav") + 1 == c.index("lay_exp") + 2


def test_ctypes_mirrors_carry_the_clock_pointer():
    """Both args structs carry the device clock pointer (``now_ptr``, read
    by the kernels when non-null, so a CUDA graph answers at the clock
    filled in before each replay) right after the gate's planes, and keep
    the by-value ``now`` for eager calls, on the C side and in the mirror;
    the wrappers fill one or the other."""
    for source, name, cls in (("fused_probe.cu", "ProbeArgs", K._Args),
                              ("fused_probe_aligned.cu", "AlignedArgs",
                               K._AlignedArgs)):
        c = dict(_c_struct(source, name))
        names = [f for f, _t in _c_struct(source, name)]
        assert c["now_ptr"] is ctypes.c_void_p and c["now"] is ctypes.c_int
        assert names.index("now_ptr") == names.index("out3") + 1
        assert [f for f, _t in cls._fields_] == names
    assert K._now_fields(7, torch.device("cpu")) == dict(now=7, now_ptr=None)
    t = torch.tensor(7, dtype=torch.int32)
    assert K._now_fields(t, torch.device("cpu")) == dict(now=0, now_ptr=t.data_ptr())
    for bad in (torch.tensor([7], dtype=torch.int32), torch.tensor(7)):
        with pytest.raises(ValueError):
            K._now_fields(bad, torch.device("cpu"))


def test_kernel_constants_match_the_c_sources():
    with open(os.path.join(CSRC, "probe_common.cuh")) as f:
        common = f.read()
    with open(os.path.join(CSRC, "fused_probe.cu")) as f:
        probe = f.read()

    def define(text, name):
        return int(re.search(r"#define %s (\d+)" % name, text).group(1))

    assert define(common, "GOCHUGARU_MAXW") == K.MAXW
    assert define(common, "GOCHUGARU_MAXL") == K.MAXL
    assert define(common, "GOCHUGARU_DICT") == K.DICT
    assert define(common, "GOCHUGARU_SMEM_MAX") == K.SMEM_MAX
    # the gate tile, and the reduced tile at its most: one slot a thread,
    # whole rounds of the CTA's threads
    threads = define(common, "GOCHUGARU_TILE_THREADS")
    assert K.GATE_SLOTS % threads == 0 and K.REDUCE_SLOTS % threads == 0
    # the warp path: its CTAs and its longest lane (one ballot of a warp)
    assert threads == K.TILE_THREADS and threads % 32 == 0
    assert define(common, "GOCHUGARU_WARP_CAP") == K.WARP_REDUCE_CAP == 32
    # the mode ids the wrapper passes are the C enum's
    enum = re.search(r"enum \{([^}]*)\}", common).group(1)
    ids = {m.lower(): int(v) for m, v in re.findall(r"MODE_(\w+) = (\d+)", enum)}
    assert ids == K._MODE_ID
    assert set(K.ALIGNED_MODES) <= set(ids)


def test_probe_variants_skip_a_patch_whose_anchor_is_gone():
    """tools/probe_variants.py patches the kernel sources at text anchors;
    a source without them gives skipped variants (None), never a raise,
    so rewording a kernel needs no change there."""
    from gochugaru_tpu_torch.tools import probe_variants as V

    with open(os.path.join(CSRC, "fused_probe.cu")) as f:
        fp = f.read()
    runs = V.runs_variants("// no anchors\n")
    gate = V.gate_variants("// no anchors\n")
    assert runs["bisect"] is not None and gate["kept"][0] is not None
    assert all(v is None for k, v in runs.items() if k != "bisect")
    assert all(v[0] is None for k, v in gate.items() if k != "kept")
    assert V.runs_variants(fp)["bisect"] == fp


def test_spec_tensors_refuse_a_delta_of_a_later_column():
    spec = PK.make_spec([PK.col_range(-1, 9), PK.col_delta(-1, 1, 0)])
    K.spec_tensors(spec, "cpu")
    w, lanes, fields, dicts = spec
    bad = (w, lanes, [fields[0][:2] + (1,) + fields[0][3:], fields[1]], dicts)
    with pytest.raises(ValueError):
        K.spec_tensors(bad, "cpu")


def test_cpu_calls_count_no_lanes():
    t = _rev_table(5, True)
    K.reset_launches()
    _plain_runs(t)
    K.fused_probe((torch.from_numpy(t["keys"]),), to_device_tensor(t["off"], "cpu"),
                  to_device_tensor(t["tbl"], "cpu"), cap=t["cap"], spec=t["spec"],
                  off_a=to_device_tensor(t["off_a"], "cpu"), ashift=t["ashift"],
                  mode="runs")
    assert set(K.LANES) == set(K.LAUNCHES)
    assert all(n == 0 for n in K.LANES.values())


# ---------------------------------------------------------------------------
# on the card: the kernels against the plain twins (exact equality)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernel has no"
                    " CPU mode); chip_smoke.py phases 3 and 3c run this on the card")
    return "cuda"


@pytest.mark.cuda
def test_runs_kernel_equals_plain_at_its_edges_on_card(cuda_device):
    dev = torch.device(cuda_device)
    for name, (keys, cap, _s, layouts) in CS.runs_edge_tables(dev).items():
        q = torch.from_numpy(keys).to(dev)
        for layout, c in layouts.items():
            for cp in (cap, 4, 2):
                kw = dict(cap=cp, spec=c["spec"], off_a=c["off_a"],
                          ashift=c["ashift"], mode="runs")
                got = K.fused_probe((q,), c["off"], c["tbl"], **kw)
                want = K.fused_probe((q,), c["off"], c["tbl"], plain=True, **kw)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (name, layout, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_aligned_gate_kernel_equals_plain_on_card(cuda_device, packed):
    dev = torch.device(cuda_device)
    for W in TB.EDGE_W:
        exp_col, now = CS.GATE_EXP[W]
        for caps in ((8, 3, 1), TB.LADDER_8, (2 * K.GATE_SLOTS + 3, 1)):
            tbls, sw, spec, qs = _gate_ladder(W, caps, packed, W, min(2, W), 257)
            qt = tuple(torch.from_numpy(q).to(dev) for q in qs)
            tb = [to_device_tensor(x, dev) for x in tbls]
            for e in (exp_col, None):
                kw = dict(spec=spec, mode="gate", now=now, exp_lane=e)
                got = K.fused_probe_aligned(qt, tb, caps, sw, **kw)
                want = K.fused_probe_aligned(qt, tb, caps, sw, plain=True, **kw)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (W, caps, e)
