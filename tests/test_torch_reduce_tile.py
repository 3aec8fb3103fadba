"""``fused_probe`` mode ``until2`` on the slot tile's reduced mode: what the
CPU can check of it.

On a card ``fused_probe`` mode ``until2`` runs the slot tile of
``csrc/probe_common.cuh`` as a per-lane reduction: a CTA owns whole lanes
(``kernels.reduce_tile``), one thread a slot ORs its hit's two compares
into its lane's shared flag word, one thread a lane stores the flags.
Here:

- ``reduce_tile``'s geometry for every capT of the block tests and 1-8
  segments under each ``REDUCE_SLOTS`` value chip_smoke.py times: tiles
  start at lane boundaries and cover every slot once, and the shared
  bytes fit;
- the C side's ``gochugaru_tile_lanes`` / ``gochugaru_tile_smem``,
  translated from ``csrc/probe_common.cuh``, against ``block_tile``,
  ``gate_tile`` and ``reduce_tile``;
- the plain ``until2`` on chip_smoke.py phase 3c's until2 edge tables
  (caps 1 to past one tile, clamped bucket starts, columns 2 and 3 as
  ranges, dictionaries and delta chains, ``now`` equal to a row value and
  one below it) against the reference's ``probe_block`` /
  ``decode_block`` chain and its until tail
  (gochugaru_tpu/engine/flat.py:3605-3616), exact equality.

The kernel is held to that twin by the ``cuda``-marked test below and by
chip_smoke.py's phase 3c on the card.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke as CS
import test_torch_block_tile as TB
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import to_device_tensor

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, os.pardir, "csrc")


# ---------------------------------------------------------------------------
# the C geometry, translated
# ---------------------------------------------------------------------------


def _c_source():
    with open(os.path.join(CSRC, "probe_common.cuh")) as f:
        return f.read()


def _c_expr(expr):
    """A C integer expression as Python: casts dropped, integer division."""
    expr = re.sub(r"\((?:size_t|int|long long)\)", "", expr)
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if m:
        return "(%s) if (%s) else (%s)" % tuple(_c_expr(x) for x in m.group(2, 1, 3))
    return expr.replace("/", "//")


def _c_function(source, name):
    """The Python translation of one small ``__host__ __device__`` C
    function of ``source``: each statement a declaration, an ``if (...)
    return ...`` or a ``return``; template parameters become leading
    arguments."""
    m = re.search(r"(?:template <([^>]*)>\s*)?__host__ __device__[^\n]*?"
                  r"\b%s\(([^)]*)\)\s*\{(.*?)\n\}" % name, source, re.S)
    assert m, name
    tparams, params, body = m.groups()
    args = [p.split()[-1] for p in ((tparams + ",") if tparams else "").split(",")
            + params.split(",") if p.strip()]
    lines = []
    for stmt in re.sub(r"//[^\n]*", "", body).split(";"):
        stmt = " ".join(stmt.split())
        if not stmt:
            continue
        decl = re.fullmatch(r"const \w+ (\w+) = (.+)", stmt)
        cond = re.fullmatch(r"if \((.+?)\) return (.+)", stmt)
        ret = re.fullmatch(r"return (.+)", stmt)
        if decl:
            lines.append("%s = %s" % (decl.group(1), _c_expr(decl.group(2))))
        elif cond:
            lines.append("if %s: return %s" % (_c_expr(cond.group(1)),
                                               _c_expr(cond.group(2))))
        else:
            assert ret, stmt
            lines.append("return " + _c_expr(ret.group(1)))
    return "def %s(%s):\n%s\n" % (name, ", ".join(args),
                                  "".join("    %s\n" % x for x in lines))


@pytest.fixture(scope="module")
def c_geometry():
    """(gochugaru_tile_lanes, gochugaru_tile_smem, the C mode ids)."""
    src = _c_source()
    modes = dict((k, int(v)) for k, v in re.findall(r"\b(MODE_\w+) = (\d+)", src))
    ns = dict(modes)
    for name in ("gochugaru_tile_lanes", "gochugaru_tile_smem"):
        exec(_c_function(src, name), ns)  # noqa: S102 - our own C source
    return ns["gochugaru_tile_lanes"], ns["gochugaru_tile_smem"], modes


def test_c_translation_reads_every_statement():
    text = _c_function(_c_source(), "gochugaru_tile_smem")
    assert text.count("return") == 3 and "lanes = gochugaru_tile_lanes" in text


# ---------------------------------------------------------------------------
# reduce_tile geometry, and every tile's shared bytes against the C side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", CS.REDUCE_SWEEP)
@pytest.mark.parametrize("nseg", range(1, K.MAXL + 1))
@pytest.mark.parametrize("W", TB.EDGE_W)
def test_reduce_tile_geometry(W, nseg, slots, monkeypatch, c_geometry):
    tile_lanes, tile_smem, modes = c_geometry
    monkeypatch.setattr(K, "REDUCE_SLOTS", slots)
    for capT in TB._capTs(W):
        if nseg > capT:
            continue
        S, lanes, smem = K.reduce_tile(capT, nseg)
        case = (capT, W, nseg, S, lanes, smem)
        # whole lanes, as many as REDUCE_SLOTS holds (at least one)
        assert S % capT == 0 and lanes == S // capT == max(1, slots // capT), case
        assert S <= max(slots, capT), case
        assert lanes == tile_lanes(S, capT) == K._tile_lanes(S, capT), case
        assert smem == tile_smem(modes["MODE_UNTIL2"], S, capT, W, nseg), case
        assert smem <= K.SMEM_MAX, case
        B = 3 * lanes + 2
        g0, n, touched = TB._tiles(S, capT, B)
        assert (g0 % capT == 0).all(), case  # every tile starts a lane
        assert int(n.sum()) == B * capT and (g0[1:] == g0[:-1] + n[:-1]).all(), case
        assert (n % capT == 0).all() and int(touched.max()) <= lanes, case


@pytest.mark.parametrize("nseg", [1, 2, K.MAXL])
def test_block_and_gate_tiles_match_the_c_shared_bytes(nseg, c_geometry):
    tile_lanes, tile_smem, modes = c_geometry
    for W in TB.EDGE_W:
        for capT in TB._capTs(W):
            if nseg > capT:
                continue
            S, lanes, smem = K.block_tile(capT, W, nseg)
            assert lanes == tile_lanes(S, capT)
            assert smem == tile_smem(modes["MODE_BLOCK"], S, capT, W, nseg)
            S, lanes, smem = K.gate_tile(capT, nseg)
            assert lanes == tile_lanes(S, capT)
            assert smem == tile_smem(modes["MODE_GATE"], S, capT, W, nseg)


def test_reduce_tile_reads_its_budget_at_call_time(monkeypatch):
    assert K.reduce_tile(4, 1)[0] == K.REDUCE_SLOTS
    monkeypatch.setattr(K, "GATE_SLOTS", 64)  # the gate's knob is not read
    monkeypatch.setattr(K, "REDUCE_SLOTS", 256)
    assert K.reduce_tile(10, 1) == (250, 25, 25 * 20)
    assert K.reduce_tile(300, 2) == (300, 1, 28)  # a lane past the slots: its own CTA


def test_launches_pass_each_mode_its_tile(monkeypatch):
    assert K._tile_slots("block", 8, 3, 1) == K.block_tile(8, 3, 1)[0]
    assert K._tile_slots("gate", 8, 3, 1) == K.gate_tile(8, 1)[0]
    assert K._warp("block", 4) == K._warp("gate", 4) == 0
    # the reduced modes: the warp path up to WARP_REDUCE_CAP slots a lane,
    # the shared-flag tile beyond
    for mode in ("any", "until2"):
        assert K._tile_slots(mode, 4, 4, 1) == K.warp_tile(4)[0]
        assert K._tile_slots(mode, 33, 4, 2) == K.reduce_tile(33, 2)[0]
        assert K._warp(mode, 4) == 1 and K._warp(mode, 33) == 0
    monkeypatch.setattr(K, "WARP_REDUCE_CAP", 0)
    assert K._tile_slots("until2", 4, 4, 1) == K.reduce_tile(4, 1)[0]
    assert K._warp("any", 4) == 0
    assert K._tile_slots("runs", 4, 4, 1) == 0


# ---------------------------------------------------------------------------
# the plain until2 vs the reference's chain at the tile's edges
# ---------------------------------------------------------------------------


def _until_table(codec, cap, packed, seed, nq, B, W=4):
    """chip_smoke.py phase 3c's until2 recipe: ``until_rows`` under
    ``codec``, clamped bucket starts, every other live lane's keys planted
    in its window (absent keys never); the table and the key columns."""
    rng = np.random.default_rng(seed)
    rows = max(4 * cap, 512)
    spec, raw = CS.until_rows(rng, rows, codec, W)
    off = CS.edge_offsets(rng, rows, cap, 256)
    qs, absent = CS._until_queries(rng, B, nq)
    CS.plant_rows(raw, off, cap, qs, rng, spec, absent=absent)
    return TB._off_table(raw, off, spec, cap, packed, rng), qs


def _until_tail(blk, qs, now):
    """The reference's until tail (flat.py:3605-3616): any hit whose
    column 2, and any whose column 3, lies past ``now``."""
    hit = TB._gate_tail(blk, qs, now)[0]
    return (hit & (blk[..., 2] > now)).any(-1), (hit & (blk[..., 3] > now)).any(-1)


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("codec,W", [(c, 4) for c in CS.UNTIL_CODECS] + [("range", 16)])
def test_plain_until2_matches_reference_at_tile_edges(codec, W, packed):
    tally = dict.fromkeys(("a", "b", "failing both", "clamped hit"), 0)
    for i, cap in enumerate(TB.EDGE_CAPS + (TB._long_lane(),)):
        for nq in (1, 2):
            n = 255 if cap < TB._long_lane() else 9
            t, qs = _until_table(codec, cap, packed, 90 + 2 * i + nq, nq, n, W)
            blk = TB._ref_probe(t, qs)  # lanes are independent: B lanes are its first B
            hit = TB._gate_tail(blk, qs, 0)[0].any(-1)
            for B in (1, n):
                qb = [q[:B] for q in qs]
                for now in (CS.UNTIL_NOW, CS.UNTIL_NOW - 1):
                    got = TB._probe(t, qb, mode="until2", now=now)
                    want = _until_tail(blk[:B], qb, now)
                    for a, b in zip(got, want):
                        assert a.dtype == torch.bool and a.shape == (B,)
                        assert np.array_equal(a.numpy(), b), (cap, nq, B, now)
                    if B == n:
                        tally["a"] += int(want[0].sum())
                        tally["b"] += int(want[1].sum())
                        tally["failing both"] += int((hit & ~want[0] & ~want[1]).sum())
                        tally["clamped hit"] += int(hit[TB._clamped(t, qs)].sum())
    assert all(tally.values()), tally


def test_plain_until2_of_no_slots_is_all_false():
    t, qs = _until_table("range", 1, False, 3, 2, 5)
    t["cap"] = 0
    a, b = TB._probe(t, qs, mode="until2", now=0)
    assert a.shape == b.shape == (5,) and not a.any() and not b.any()


# ---------------------------------------------------------------------------
# on the card: the reduced tile against the plain twin
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernel has no"
                    " CPU mode); chip_smoke.py phase 3c runs this on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_until2_tile_kernel_equals_plain_on_card(cuda_device, packed):
    dev = torch.device(cuda_device)
    for codec in CS.UNTIL_CODECS:
        for cap in (1, 4, 64, TB._long_lane()):
            for nq in (1, 2):
                t, qs = _until_table(codec, cap, packed, cap + nq, nq, 257)
                args = (tuple(torch.from_numpy(q).to(dev) for q in qs),
                        to_device_tensor(t["off"], dev), to_device_tensor(t["tbl"], dev))
                kw = dict(cap=cap, spec=t["spec"], ashift=t["ashift"], mode="until2",
                          now=CS.UNTIL_NOW,
                          off_a=None if t["off_a"] is None
                          else to_device_tensor(t["off_a"], dev))
                got = K.fused_probe(*args, **kw)
                want = K.fused_probe(*args, plain=True, **kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (codec, cap, nq)
