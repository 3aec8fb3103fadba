"""Mode ``block`` of both probe kernels and ``fused_probe``'s mode
``gate``: the tile geometry, and the plain twins at the tile's edge
shapes against the reference's XLA chain.

On a card mode ``block`` of ``fused_probe`` and ``fused_probe_aligned``
runs one cooperative tile kernel (``csrc/probe_common.cuh``): a CTA owns
``tile_slots`` consecutive output slots, as ``kernels.block_tile``
chooses; mode ``gate`` of both runs the same slot tile, one thread a slot
(``kernels.gate_tile``).  Here on the CPU:

- ``block_tile`` for every W in 1..16 and every capT phase 3c of
  chip_smoke.py uses: the shared bytes fit 227 KB, every tile's span of
  the output starts 16-byte aligned, tiles cover every slot exactly once
  and no tile touches more lanes than its segment-start area holds;
- the plain ``block`` of both kernels on those edge shapes (ragged lane
  counts, bucket starts clamped at ``rows - cap``, W = 16, multi-level
  and 8-level ladders, negative and absent keys, int32 and packed rows)
  against the reference package's ``probe_block`` / ``probe_aligned`` +
  ``decode_block``, exact equality;
- the plain ``gate`` of ``fused_probe`` on the off+interleave edge tables
  of chip_smoke.py's phase 3c (caps 1 to past one tile, clamped bucket
  starts, keys planted in the lanes' windows, every expiry codec of
  ``edge_spec`` and every caveat/context codec of ``cav_rows``) against
  the same chain and the reference's gate tail (pallas.py:348-359), with
  and without the caveat and context planes, exact equality.

The kernels are held to those twins by the ``cuda``-marked tests below
and by chip_smoke.py's phase 3c on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as CS
from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine import packed as JPK
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import to_device_tensor

EDGE_W = (1, 3, 5, 16)
EDGE_CAPS = (1, 3, 8, 64)
#: the most levels a ladder has (kernels.MAXL)
LADDER_8 = (5, 4, 3, 2, 2, 1, 1, 1)


def _big_cap(W):
    """chip_smoke.py phase 3c's cap whose single lane passes the budget."""
    return K.TILE_BYTES // (4 * W) * 2 + 3


def _capTs(W):
    return sorted(set(range(1, 70)) | {127, 128, 129, 256, 257, 513, 1_000,
                                       sum(LADDER_8), _big_cap(W), _big_cap(W) + 1})


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------


def _tiles(slots, capT, B):
    """(first slot, slot count, lanes touched) of every tile over B lanes."""
    total = B * capT
    g0 = np.arange(0, total, slots, dtype=np.int64)
    n = np.minimum(slots, total - g0)
    touched = (g0 + n - 1) // capT - g0 // capT + 1
    return g0, n, touched


@pytest.mark.parametrize("W", range(1, K.MAXW + 1))
def test_block_tile_geometry(W):
    for capT in _capTs(W):
        for nseg in (1, 2, K.MAXL):
            if nseg > capT:
                continue
            slots, lanes, smem = K.block_tile(capT, W, nseg)
            case = (capT, W, nseg, slots, lanes, smem)
            assert slots >= 1 and (slots * W) % 4 == 0, case
            assert smem == slots * W * 4 + lanes * nseg * 8 <= K.SMEM_MAX, case
            assert smem <= K.TILE_BYTES + 192, case
            # enough lanes for the pattern of tile starts to repeat
            B = 2 * capT // np.gcd(slots, capT) + 3
            g0, n, touched = _tiles(slots, capT, B)
            assert int(n.sum()) == B * capT and (g0[1:] == g0[:-1] + n[:-1]).all(), case
            assert int(touched.max()) <= lanes, case
            if len(g0) > 2 * capT:  # every start residue occurs
                assert int(touched.max()) == lanes, case
            if slots % capT == 0:
                # whole lanes: as many as the budget holds, in steps that
                # keep the alignment
                step = 4 // np.gcd(capT * W, 4)
                per_lane = capT * W * 4 + nseg * 8
                assert (slots // capT + step) * per_lane > K.TILE_BYTES, case


def test_block_tile_chunks_a_lane_past_the_budget(monkeypatch):
    """A lane whose block passes the budget is walked in chunks: tiles of
    fewer slots than one lane, several a lane; under a budget that holds
    it, tiles are whole lanes again."""
    caps = {W: _big_cap(W) for W in EDGE_W}
    for W, cap in caps.items():
        slots, lanes, _ = K.block_tile(cap, W, 1)
        assert slots < cap and lanes == 2
    monkeypatch.setattr(K, "TILE_BYTES", 1 << 20)
    for W, cap in caps.items():
        assert K.block_tile(cap, W, 1)[0] % cap == 0


# ---------------------------------------------------------------------------
# plain block vs the reference's XLA chain at the tile's edge shapes
# ---------------------------------------------------------------------------


def _spec_rows(W, rng, n):
    """A pack spec of W columns mixing every field kind (16-bit range,
    delta of column 0, dictionary, a 21-bit range crossing a lane,
    constant) and n int32 rows inside it (chip_smoke.py's edge_spec)."""
    dict_vals = (-1, 3, 8, 2**31 - 1)
    raw = np.empty((n, W), np.int32)
    raw[:, 0] = rng.integers(-1, 50_001, n)
    descs = [JPK.col_range(-1, 50_000)]
    for c in range(1, W):
        kind = c % 4
        if kind == 1:
            descs.append(JPK.col_delta(-100, 100, 0))
            raw[:, c] = raw[:, 0] + rng.integers(-100, 101, n)
        elif kind == 2:
            descs.append(JPK.col_dict(dict_vals))
            raw[:, c] = rng.choice(dict_vals, n)
        elif kind == 3:
            descs.append(JPK.col_range(-1, (1 << 20) - 1))
            raw[:, c] = rng.integers(-1, 1 << 20, n)
        else:
            descs.append(JPK.col_const(7))
            raw[:, c] = 7
    spec = JPK.make_spec(descs)
    assert spec is not None
    return spec, raw


def _queries(rng, B, nq):
    return tuple(np.where(rng.random(B) < 0.1, -rng.integers(1, 9, B),
                          rng.integers(0, 60_000, B)).astype(np.int32)
                 for _ in range(nq))


def _off_table(raw, off, spec, cap, packed, rng=None):
    """An off+interleave table as the probes take it: int32 rows and
    offsets, or packed rows and anchored offsets (``off_full`` keeps the
    int32 offsets)."""
    t = dict(cap=cap, rows=raw.shape[0], size=off.shape[0] - 1, raw=raw, off=off,
             spec=None, tbl=raw, off_a=None, ashift=None, rng=rng, off_full=off)
    if packed:
        res, anchor = JPK.pack_off(off)
        t.update(spec=spec, tbl=JPK.pack_rows(raw, spec), off=res, off_a=anchor,
                 ashift=JPK.OFF_ANCHOR_SHIFT)
    return t


def _edge_table(W, cap, packed, seed):
    """An off+interleave table whose last quarter of bucket starts lies
    within cap of the end (those lanes clamp to rows - cap)."""
    rng = np.random.default_rng(seed)
    rows = max(4 * cap, 512)
    spec, raw = _spec_rows(W, rng, rows)
    return _off_table(raw, CS.edge_offsets(rng, rows, cap, 256), spec, cap, packed, rng)


def _ref_probe(t, qs):
    """probe_block (int32) or the anchored gather + slice_blocks +
    decode_block (packed), as tests/test_torch_probe.py builds it."""
    jq = tuple(jnp.asarray(q) for q in qs)
    if t["spec"] is None:
        return np.asarray(JH.probe_block(jnp.asarray(t["off"]), jnp.asarray(t["tbl"]),
                                         t["cap"], jq))
    hh = (JH.mix32(list(jq), jnp) & jnp.uint32(t["size"] - 1)).astype(jnp.int32)
    start = (JH.take_in_bounds(jnp.asarray(t["off_a"]), hh >> t["ashift"])
             + JH.take_in_bounds(jnp.asarray(t["off"]), hh).astype(jnp.int32))
    return np.asarray(JPK.decode_block(
        JH.slice_blocks(jnp.asarray(t["tbl"]), start, t["cap"]), t["spec"]))


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("W", EDGE_W)
def test_plain_block_matches_reference_at_edges(W, packed):
    clamped = 0
    for i, cap in enumerate(EDGE_CAPS):
        t = _edge_table(W, cap, packed, seed=10 * W + i)
        for nq, B in ((1, 1), (2, 255), (1, 257)):
            qs = _queries(t["rng"], B, min(nq, W))
            got = K.fused_probe(
                tuple(torch.from_numpy(q) for q in qs),
                to_device_tensor(t["off"], "cpu"), to_device_tensor(t["tbl"], "cpu"),
                cap=cap, spec=t["spec"],
                off_a=None if t["off_a"] is None else to_device_tensor(t["off_a"], "cpu"),
                ashift=t["ashift"], mode="block")
            want = _ref_probe(t, qs)
            assert got.dtype == torch.int32 and got.shape == (B, cap, W)
            assert np.array_equal(got.numpy(), want), (cap, nq, B)
            h = np.asarray(JH.mix32(list(qs), np)) & (t["size"] - 1)
            clamped += int((t["off_full"][h] > t["rows"] - cap).sum())
    assert clamped  # some lanes start past rows - cap


def _ladder(W, caps, packed, seed):
    """Synthetic levels (pow2 rows of caps[l] random slots each)."""
    rng = np.random.default_rng(seed)
    sizes = [max(256 >> (2 * l), 8) for l in range(len(caps))]
    spec, _ = _spec_rows(W, rng, 1)
    raws = [_spec_rows(W, rng, s * c)[1] for s, c in zip(sizes, caps)]
    if packed:
        return ([JPK.pack_rows(r, spec).reshape(s, -1) for r, s in zip(raws, sizes)],
                spec[1], spec, rng)
    return [r.reshape(s, c * W) for r, s, c in zip(raws, sizes, caps)], W, None, rng


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("W", EDGE_W)
def test_plain_aligned_block_matches_reference_at_edges(W, packed):
    ladders = [(c, 3, 1) for c in EDGE_CAPS[:3]] + [(64,), LADDER_8]
    for i, caps in enumerate(ladders):
        tbls, sw, spec, rng = _ladder(W, caps, packed, seed=20 * W + i)
        for nq, B in ((2, 1), (1, 255), (2, 257)):
            qs = _queries(rng, B, min(nq, W))
            got = K.fused_probe_aligned(
                tuple(torch.from_numpy(q) for q in qs),
                [to_device_tensor(x, "cpu") for x in tbls], caps, sw, spec=spec,
                mode="block")
            blk = JH.probe_aligned([jnp.asarray(x) for x in tbls], caps, sw,
                                   tuple(jnp.asarray(q) for q in qs))
            want = np.asarray(blk if spec is None else JPK.decode_block(blk, spec))
            assert got.dtype == torch.int32 and got.shape == (B, sum(caps), W)
            assert np.array_equal(got.numpy(), want), (caps, nq, B)


# ---------------------------------------------------------------------------
# fused_probe's plain gate vs the reference's chain at the tile's edges
# ---------------------------------------------------------------------------


def _long_lane():
    """chip_smoke.py phase 3c's lane longer than one gate tile."""
    return 2 * K.GATE_SLOTS + 3


def _gate_table(cap, packed, seed, nq, B, W=None, codec=None):
    """chip_smoke.py phase 3c's off+interleave gate recipe: ``edge_spec``
    rows of ``W`` columns (or ``cav_rows`` under caveat ``codec``), the
    last quarter of bucket starts clamped, every other live lane's keys
    planted in its window (a third of them with expiry 0 when W is 16);
    the table and ``nq`` key columns of ``B`` lanes."""
    rng = np.random.default_rng(seed)
    rows = max(4 * cap, 512)
    if codec is None:
        spec, raw = _spec_rows(W, rng, rows)
    else:
        spec, raw = CS.cav_rows(rng, rows, codec)
    off = CS.edge_offsets(rng, rows, cap, 256)
    qs = CS._gate_queries(rng, B, nq)
    CS.plant_rows(raw, off, cap, qs, rng, spec,
                  CS.GATE_EXP[W][0] if W == 16 else None)
    return _off_table(raw, off, spec, cap, packed, rng), qs


def _probe(t, qs, **kw):
    """The port's fused_probe on table ``t`` (CPU tensors)."""
    return K.fused_probe(
        tuple(torch.from_numpy(q) for q in qs), to_device_tensor(t["off"], "cpu"),
        to_device_tensor(t["tbl"], "cpu"), cap=t["cap"], spec=t["spec"],
        off_a=None if t["off_a"] is None else to_device_tensor(t["off_a"], "cpu"),
        ashift=t["ashift"], **kw)


def _gate_tail(blk, qs, now, exp_lane=None, cav_lane=None, ctx_lane=None):
    """The reference's gate tail (pallas.py:348-359) over a decoded block:
    hit, live, and on request the caveat plane (0 on a miss) and the
    context plane (-1 on a miss)."""
    hit = np.ones(blk.shape[:-1], bool)
    for j, q in enumerate(qs):
        hit &= (blk[..., j] == q[:, None]) & (q >= 0)[:, None]
    live = hit
    if exp_lane is not None:
        e = np.where(hit, blk[..., exp_lane], 0)
        live = hit & ((e == 0) | (e > now))
    out = [hit, live]
    if cav_lane is not None:
        out.append(np.where(hit, blk[..., cav_lane], 0))
    if ctx_lane is not None:
        out.append(np.where(hit, blk[..., ctx_lane], -1))
    return out


def _clamped(t, qs):
    h = np.asarray(JH.mix32(list(qs), np)) & (t["size"] - 1)
    return t["off_full"][h] > t["rows"] - t["cap"]


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("W", EDGE_W)
def test_plain_gate_matches_reference_at_tile_edges(W, packed):
    exp_col, now = CS.GATE_EXP[W]
    hits = expired = clamped_hits = 0
    for i, cap in enumerate(EDGE_CAPS + (_long_lane(),)):
        for nq in (1, 2)[:W]:
            n = 255 if cap < _long_lane() else 9
            t, qs = _gate_table(cap, packed, 50 * W + 2 * i + nq, nq, n, W=W)
            blk = _ref_probe(t, qs)  # lanes are independent: B lanes are its first B
            for B in (1, n):
                qb = [q[:B] for q in qs]
                for e in (exp_col, None):
                    got = _probe(t, qb, mode="gate", now=now, exp_lane=e)
                    want = _gate_tail(blk[:B], qb, now, e)
                    for a, b in zip(got, want):
                        assert a.dtype == torch.bool and a.shape == (B, cap)
                        assert np.array_equal(a.numpy(), b), (cap, nq, B, e)
                    if e is not None:
                        hits += int(want[0].sum())
                        expired += int((want[0] & ~want[1]).sum())
                        clamped_hits += int(want[0][_clamped(t, qb)].sum())
    assert hits and expired and clamped_hits


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("codec", CS.CAV_CODECS)
def test_plain_gate_planes_match_reference_at_tile_edges(codec, packed):
    """The gate with its caveat-id and context planes: ranges with a -1
    sentinel, a dictionary, a context stored as a delta of the caveat."""
    caveated = no_ctx = 0
    for i, cap in enumerate(EDGE_CAPS + (_long_lane(),)):
        n = 255 if cap < _long_lane() else 9
        t, qs = _gate_table(cap, packed, 70 + i, 2, n, codec=codec)
        ref = _ref_probe(t, qs)  # lanes are independent: B lanes are its first B
        for B in (1, n):
            qb, blk = [q[:B] for q in qs], ref[:B]
            for exp_lane in (CS.CAV_EXP, None):
                for ctx_lane in (CS.CAV_LANES["ctx_lane"], None):
                    kw = dict(now=CS.CAV_NOW, exp_lane=exp_lane,
                              cav_lane=CS.CAV_LANES["cav_lane"], ctx_lane=ctx_lane)
                    got = _probe(t, qb, mode="gate", **kw)
                    want = _gate_tail(blk, qb, **kw)
                    assert len(got) == len(want) == 3 + (ctx_lane is not None)
                    for k, (a, b) in enumerate(zip(got, want)):
                        assert a.dtype == (torch.bool if k < 2 else torch.int32)
                        assert a.shape == (B, cap)
                        assert np.array_equal(a.numpy(), b), (cap, B, exp_lane, k)
            hit = want[0]
            caveated += int((hit & (want[2] != 0)).sum())
            no_ctx += int((hit & (blk[..., 3] == -1)).sum())
    assert caveated and no_ctx


# ---------------------------------------------------------------------------
# on the card: the tile kernel against the plain twin
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernel has no"
                    " CPU mode); chip_smoke.py phase 3c runs this on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_block_tile_kernel_equals_plain_on_card(cuda_device, packed):
    dev = torch.device(cuda_device)
    for W in (3, 16):
        for cap in (8, _big_cap(W)):
            t = _edge_table(W, cap, packed, seed=W + cap)
            qs = tuple(torch.from_numpy(q).to(dev) for q in _queries(t["rng"], 257, 2))
            args = (qs, to_device_tensor(t["off"], dev), to_device_tensor(t["tbl"], dev))
            kw = dict(cap=cap, spec=t["spec"], ashift=t["ashift"], mode="block",
                      off_a=None if t["off_a"] is None else to_device_tensor(t["off_a"], dev))
            assert torch.equal(K.fused_probe(*args, **kw),
                               K.fused_probe(*args, plain=True, **kw)), (W, cap)
        for caps in ((13,), (8, 3, 1), LADDER_8):
            tbls, sw, spec, rng = _ladder(W, caps, packed, seed=W)
            qs = tuple(torch.from_numpy(q).to(dev) for q in _queries(rng, 257, 1))
            tb = [to_device_tensor(x, dev) for x in tbls]
            assert torch.equal(K.fused_probe_aligned(qs, tb, caps, sw, spec=spec),
                               K.fused_probe_aligned(qs, tb, caps, sw, spec=spec,
                                                     plain=True)), (W, caps)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_gate_tile_kernel_equals_plain_off_interleave_on_card(cuda_device, packed):
    """fused_probe mode gate (the slot tile) against its plain twin, with
    and without the caveat planes, at the tile's edges."""
    dev = torch.device(cuda_device)

    def on_card(t, qs, **kw):
        args = (tuple(torch.from_numpy(q).to(dev) for q in qs),
                to_device_tensor(t["off"], dev), to_device_tensor(t["tbl"], dev))
        kw.update(cap=t["cap"], spec=t["spec"], ashift=t["ashift"], mode="gate",
                  off_a=None if t["off_a"] is None else to_device_tensor(t["off_a"], dev))
        return K.fused_probe(*args, **kw), K.fused_probe(*args, plain=True, **kw)

    for cap in (1, 8, _long_lane()):
        for W in (3, 16):
            t, qs = _gate_table(cap, packed, W + cap, 2, 257, W=W)
            for e in (CS.GATE_EXP[W][0], None):
                got, want = on_card(t, qs, now=CS.GATE_EXP[W][1], exp_lane=e)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (W, cap, e)
        for codec in CS.CAV_CODECS:
            t, qs = _gate_table(cap, packed, cap, 2, 257, codec=codec)
            for ctx_lane in (CS.CAV_LANES["ctx_lane"], None):
                got, want = on_card(t, qs, now=CS.CAV_NOW, exp_lane=CS.CAV_EXP,
                                    cav_lane=CS.CAV_LANES["cav_lane"], ctx_lane=ctx_lane)
                assert len(got) == len(want)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (codec, cap)
