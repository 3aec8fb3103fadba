"""The reduced modes of both probe kernels (``any`` and ``until2``) on the
slot tile's warp path: what the CPU can check of them.

On a card ``fused_probe`` and ``fused_probe_aligned`` run modes ``any``
and ``until2`` through ``csrc/probe_common.cuh``: lanes of at most
``kernels.WARP_REDUCE_CAP`` (32) slots on the warp path (a warp owns
``32 // capT`` whole lanes, one thread a slot, one ballot a flag; no
shared memory, no barrier), longer lanes on the shared-flag tile
(``kernels.reduce_tile``).  Here:

- the warp path's geometry for capT 1-32 and 1-8 segments, simulated
  thread by thread from the C side's ``gochugaru_warp_lanes`` /
  ``gochugaru_warp_slots`` (translated from the header as
  test_torch_reduce_tile.py translates the tile's): every slot of every
  lane is taken by one thread, no lane is split between warps, the idle
  threads are the ones ``warp_tile`` counts, and the kernel's division by
  capT (a multiply and a shift) is exact; capT past 32 routes to
  ``reduce_tile``;
- the launch geometry the wrappers pass for the reduced modes;
- the plain ``any`` of ``fused_probe`` at the reduced edges (caps 1, 3,
  4, 8, 31, 32, 33, 64 and past one tile, clamped bucket starts, B 1
  and ragged, one and two keys, negative and absent keys) against the
  reference's ``probe_block`` / ``decode_block`` chain and its any tail
  (gochugaru_tpu/engine/pallas.py:343-344);
- the plain aligned ``any`` and ``until2`` on multi-level ladders ((c, 3,
  1) for c in 1, 3, 8, 64, an 8-level ladder, a level of cap 0, and
  ``build_aligned``'s ladders) with keys planted past level 0, against
  the reference's ``probe_aligned`` / ``decode_block`` chain and its
  tails (pallas.py:539-543);
- an aligned call of no slots (capT 0) answers all-false.

Every output is bool: exact equality.  The ``cuda``-marked tests hold
both paths to the plain twins on a card, as chip_smoke.py's phase 3c
does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as CS
import test_torch_block_tile as TB
import test_torch_reduce_tile as RT
from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine import packed as JPK
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import to_device_tensor

#: ladders of the aligned edges: one level a lane on each side of the
#: warp path's edges, levels past level 0, the most levels, a level of cap 0
LADDERS = [(c, 3, 1) for c in TB.EDGE_CAPS] + [(28, 3, 1), (30, 3), (4, 0, 2),
                                               TB.LADDER_8]


# ---------------------------------------------------------------------------
# the warp path's geometry against the C side, thread by thread
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def c_warp():
    """(gochugaru_warp_lanes, gochugaru_warp_slots) translated from the C
    header."""
    src = RT._c_source()
    ns = {"GOCHUGARU_TILE_THREADS": K.TILE_THREADS}
    for name in ("gochugaru_warp_lanes", "gochugaru_warp_slots"):
        exec(RT._c_function(src, name), ns)  # noqa: S102 - our own C source
    return ns["gochugaru_warp_lanes"], ns["gochugaru_warp_slots"]


def _seg_of(firsts, nseg, j):
    """gochugaru_seg_of: the segment holding slot j (its first slot)."""
    s = first = 0
    for m in range(1, K.MAXL):
        if m >= nseg or j < firsts[m]:
            break
        s, first = m, firsts[m]
    return s, first


def _threads(capT, B, lanes_fn, slots_fn):
    """Every thread of the warp path's grid over B lanes of capT slots, as
    gochugaru_warp_reduce_kernel maps it: (lane, slot) of each thread that
    owns one, the idle threads of each warp, and each lane's warps."""
    per, S = lanes_fn(capT), slots_fn(capT)
    ctas = (B * capT + S - 1) // S
    owned, idle, warps_of = [], {}, {}
    for w in range(ctas * K.TILE_THREADS // 32):
        lane0 = w * per
        if lane0 >= B:  # the whole warp returns
            continue
        for tid in range(32):
            k, j = tid // capT, tid % capT
            i = lane0 + k
            if k < per and i < B:
                owned.append((i, j))
                warps_of.setdefault(i, set()).add(w)
            elif k >= per:
                idle[w] = idle.get(w, 0) + 1
    return owned, idle, warps_of


@pytest.mark.parametrize("capT", range(1, 33))
def test_warp_path_covers_every_slot_once(capT, c_warp):
    lanes_fn, slots_fn = c_warp
    S, per, n_idle = K.warp_tile(capT)
    assert (S, per) == (slots_fn(capT), lanes_fn(capT))
    assert per * capT + n_idle == 32 and 0 <= n_idle < capT
    assert S == K.TILE_THREADS // 32 * per * capT and S % capT == 0
    for B in sorted({1, per - 1, per, per + 1, 8 * per + 3, 3 * S // capT + 2} - {0}):
        owned, idle, warps_of = _threads(capT, B, lanes_fn, slots_fn)
        assert sorted(owned) == [(i, j) for i in range(B) for j in range(capT)], B
        assert all(len(w) == 1 for w in warps_of.values()), B  # no lane split
        assert all(n == n_idle for n in idle.values()), B
        # the CTAs are the tiles of S slots: the last one holds the last lane
        assert (B * capT + S - 1) // S == -(-B // (per * K.TILE_THREADS // 32))


def test_warp_path_divides_by_capT_exactly():
    """The kernel takes a thread's lane and slot, and the lanes a warp,
    without a division: n // capT as (n * ceil(2^16 / capT)) >> 16 for
    n <= 32, with the multiplier the launch computes."""
    import re

    src = RT._c_source()
    div = re.search(r"w\.warp_div = (.+?);", src).group(1).replace("t.capT", "capT")
    assert "(tid * t.warp_div) >> 16" in src and "(32 * t.warp_div) >> 16" in src
    for capT in range(1, K.WARP_REDUCE_CAP + 1):
        m = eval(RT._c_expr(div), {"capT": capT})  # noqa: S307 - our own C source
        assert m == -(-65_536 // capT)
        assert [(n * m) >> 16 for n in range(33)] == [n // capT for n in range(33)]
        assert (32 * m) >> 16 == K.warp_tile(capT)[1]


@pytest.mark.parametrize("nseg", range(1, K.MAXL + 1))
def test_warp_path_slots_find_their_segment(nseg):
    """Each thread's slot j lies in the segment gochugaru_seg_of picks,
    for ladders of nseg levels (a level of cap 0 among them) up to 32
    slots a lane."""
    rng = np.random.default_rng(nseg)
    for _ in range(40):
        caps = list(rng.integers(0, 6, nseg))
        caps[0] = max(caps[0], 1)
        capT = sum(caps)
        if capT > K.WARP_REDUCE_CAP:
            continue
        firsts = np.concatenate([[0], np.cumsum(caps)])
        for j in range(capT):
            s, first = _seg_of(firsts, nseg, j)
            assert first == firsts[s] and firsts[s] <= j < firsts[s] + caps[s], (caps, j)


def test_long_lanes_route_to_the_shared_flag_tile(monkeypatch):
    assert K.reduce_path(1) == K.reduce_path(32) == "warp"
    assert K.reduce_path(33) == K.reduce_path(4_099) == "tile"
    for bad in (0, 33):
        with pytest.raises(ValueError):
            K.warp_tile(bad)
    for mode in K.REDUCED:
        for capT, nseg in ((33, 1), (64, 3), (4_099, 2)):
            assert K._tile_slots(mode, capT, 4, nseg) == K.reduce_tile(capT, nseg)[0]
            assert K._warp(mode, capT) == 0
    monkeypatch.setattr(K, "WARP_REDUCE_CAP", 3)  # read at call time
    assert K.reduce_path(3) == "warp" and K.reduce_path(4) == "tile"


@pytest.mark.parametrize("mode", ["any", "until2"])
def test_reduced_launch_geometry_of_both_wrappers(mode):
    """fused_probe passes (cap, 1 segment), fused_probe_aligned (capT,
    its levels): the warp path's CTAs up to 32 slots a lane, the
    shared-flag tile's beyond, and the warp flag beside them."""
    for capT in range(1, 70):
        for nseg in (1, 3, K.MAXL):
            want = K.warp_tile(capT)[0] if capT <= 32 else K.reduce_tile(capT, nseg)[0]
            assert K._tile_slots(mode, capT, 4, nseg) == want
            assert K._warp(mode, capT) == int(capT <= 32)
    # the main path's shapes: 32,768 lanes of 4 (any) and of 3 (aligned
    # until2) slots run 512 and 410 CTAs, against 128 of one thread a lane
    for capT, ctas in ((4, 512), (3, 410)):
        assert -(-32_768 * capT // K._tile_slots(mode, capT, 4, 1)) == ctas


# ---------------------------------------------------------------------------
# the plain any of fused_probe vs the reference's chain at the edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("codec", CS.UNTIL_CODECS)
def test_plain_any_matches_reference_at_reduced_edges(codec, packed):
    hits = clamped_hits = 0
    for i, cap in enumerate(CS.REDUCED_CAPS + (TB._long_lane(),)):
        for nq in (1, 2):
            n = 255 if cap < TB._long_lane() else 9
            t, qs = RT._until_table(codec, cap, packed, 300 + 2 * i + nq, nq, n)
            blk = TB._ref_probe(t, qs)  # lanes are independent: B lanes are its first B
            for B in (1, n):
                qb = [q[:B] for q in qs]
                got = TB._probe(t, qb, mode="any")
                want = TB._gate_tail(blk[:B], qb, 0)[0].any(-1)
                assert got.dtype == torch.bool and got.shape == (B,)
                assert np.array_equal(got.numpy(), want), (cap, nq, B)
            hits += int(want.sum())
            clamped_hits += int(want[TB._clamped(t, qs)].sum())
    assert hits and clamped_hits


# ---------------------------------------------------------------------------
# the plain aligned any and until2 vs the reference's chain on ladders
# ---------------------------------------------------------------------------


def _until_ladder(codec, caps, packed, seed, nq, B):
    """chip_smoke.py phase 3c's aligned recipe: ``until_rows`` levels of
    pow2 rows, every other live lane's keys planted at a random level
    (absent keys never); (tbls, sw, spec, key columns)."""
    rng = np.random.default_rng(seed)
    sizes = [max(256 >> (2 * l), 8) for l in range(len(caps))]
    spec = CS.until_rows(rng, 1, codec)[0]
    qs, absent = CS._until_queries(rng, B, nq)
    raws = [CS.until_rows(rng, s * c, codec)[1] for s, c in zip(sizes, caps)]
    CS.plant_levels(raws, caps, qs, rng, spec, absent)
    if packed:
        return ([JPK.pack_rows(r, spec).reshape(s, -1) for r, s in zip(raws, sizes)],
                spec[1], spec, qs)
    return [r.reshape(s, c * 4) for r, s, c in zip(raws, sizes, caps)], 4, None, qs


def _aligned_plain(tbls, caps, sw, spec, qs, **kw):
    return K.fused_probe_aligned(tuple(torch.from_numpy(q) for q in qs),
                                 [to_device_tensor(x, "cpu") for x in tbls], caps, sw,
                                 spec=spec, **kw)


def _aligned_ref(tbls, caps, sw, spec, qs):
    """The reference's aligned chain: probe_aligned, then decode_block."""
    blk = JH.probe_aligned([jnp.asarray(x) for x in tbls], caps, sw,
                           tuple(jnp.asarray(q) for q in qs))
    return np.asarray(blk if spec is None else JPK.decode_block(blk, spec))


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("codec", CS.UNTIL_CODECS)
def test_plain_aligned_reduced_modes_match_reference(codec, packed):
    tally = dict.fromkeys(("hit", "past level 0", "a", "b", "failing both"), 0)
    for i, caps in enumerate(LADDERS):
        for nq in (1, 2):
            tbls, sw, spec, qs = _until_ladder(codec, caps, packed, 400 + 2 * i + nq,
                                               nq, 255)
            blk = _aligned_ref(tbls, caps, sw, spec, qs)
            hit = TB._gate_tail(blk, qs, 0)[0]
            for B in (1, 255):
                qb = [q[:B] for q in qs]
                got = _aligned_plain(tbls, caps, sw, spec, qb, mode="any")
                assert got.dtype == torch.bool and got.shape == (B,)
                assert np.array_equal(got.numpy(), hit[:B].any(-1)), (caps, nq, B)
                for now in (CS.UNTIL_NOW, CS.UNTIL_NOW - 1):
                    got = _aligned_plain(tbls, caps, sw, spec, qb, mode="until2",
                                         now=now)
                    want = RT._until_tail(blk[:B], qb, now)
                    for a, b in zip(got, want):
                        assert a.shape == (B,) and np.array_equal(a.numpy(), b), \
                            (caps, nq, B, now)
            tally["hit"] += int(hit.any(-1).sum())
            tally["past level 0"] += int(hit[:, caps[0]:].any(-1).sum())
            tally["a"] += int(want[0].sum())
            tally["b"] += int(want[1].sum())
            tally["failing both"] += int((hit[:B].any(-1) & ~want[0] & ~want[1]).sum())
    assert all(tally.values()), tally


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_plain_aligned_reduced_modes_on_build_aligned_ladders(packed):
    """Phase 3b's >= 3-level ladders of build_aligned (test_torch_aligned's
    recipe, columns 2 and 3 as the until pair)."""
    import test_torch_aligned as TA

    t = TA._ladder(7, packed)
    ref = TA._ref_block(t)
    for mode in ("any", "until2"):
        got = TA._probe(t, mode)
        got = list(got) if isinstance(got, tuple) else [got]
        for a, b in zip(got, TA._ref_tail(ref, t["qs"], mode)):
            assert a.shape == b.shape and np.array_equal(a.numpy(), b), mode
    assert TA._ref_tail(ref, t["qs"], "gate")[0][..., t["caps"][0]:].any()


@pytest.mark.parametrize("mode", ["any", "until2"])
def test_aligned_call_of_no_slots_is_all_false(mode):
    tbls, sw, spec, qs = _until_ladder("range", (4,), False, 5, 2, 7)
    empty = [np.zeros((8, 0), np.int32)]
    got = _aligned_plain(empty, (0,), sw, None, qs, mode=mode, now=0)
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == (1 if mode == "any" else 2)
    assert all(g.shape == (7,) and g.dtype == torch.bool and not g.any() for g in got)


def test_probe_variants_floor_patch_needs_both_kernel_bodies():
    """tools/probe_variants.py's floor breakdown patches both reduced
    kernels' bodies; a source without one of them skips it."""
    from gochugaru_tpu_torch.tools import probe_variants as V

    src = RT._c_source()
    floor = V.reduced_variants(src)["floor"][0]
    assert floor is not None and floor.count("{\n  return;\n") == 2
    assert V.reduced_variants(src.replace(V._TILE_BODY, ""))["floor"][0] is None
    assert V.reduced_variants("// none")["kept"][0] == "// none"


# ---------------------------------------------------------------------------
# on the card: both paths against the plain twins
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernel has no"
                    " CPU mode); chip_smoke.py phase 3c runs this on the card")
    return "cuda"


def _both(call):
    got, want = call(False), call(True)
    got = list(got) if isinstance(got, tuple) else [got]
    want = list(want) if isinstance(want, tuple) else [want]
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("warp_cap", [32, 0], ids=["warp", "tile"])
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_reduced_kernels_equal_plain_on_card(cuda_device, packed, warp_cap, monkeypatch):
    dev = torch.device(cuda_device)
    monkeypatch.setattr(K, "WARP_REDUCE_CAP", warp_cap)
    for codec in CS.UNTIL_CODECS:
        for cap in (1, 3, 4, 31, 32, 33, TB._long_lane()):
            for nq in (1, 2):
                t, qs = RT._until_table(codec, cap, packed, cap + nq, nq, 257)
                args = (tuple(torch.from_numpy(q).to(dev) for q in qs),
                        to_device_tensor(t["off"], dev), to_device_tensor(t["tbl"], dev))
                kw = dict(cap=cap, spec=t["spec"], ashift=t["ashift"], now=CS.UNTIL_NOW,
                          off_a=None if t["off_a"] is None
                          else to_device_tensor(t["off_a"], dev))
                for mode in K.REDUCED:
                    assert _both(lambda p: K.fused_probe(*args, plain=p, mode=mode,
                                                         **kw)), (codec, cap, nq, mode)
        for caps in LADDERS + [(32,), (33,)]:
            tbls, sw, spec, qs = _until_ladder(codec, caps, packed, 7, 2, 257)
            qd = tuple(torch.from_numpy(q).to(dev) for q in qs)
            tb = [to_device_tensor(x, dev) for x in tbls]
            for mode in K.REDUCED:
                assert _both(lambda p: K.fused_probe_aligned(
                    qd, tb, caps, sw, spec=spec, mode=mode, now=CS.UNTIL_NOW,
                    plain=p)), (codec, caps, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["any", "until2"])
def test_aligned_call_of_no_slots_launches_nothing_on_card(cuda_device, mode):
    dev = torch.device(cuda_device)
    qs = (torch.arange(9, dtype=torch.int32, device=dev),) * 2
    K.reset_launches()
    got = K.fused_probe_aligned(qs, [torch.zeros((8, 0), dtype=torch.int32, device=dev)],
                                (0,), 4, mode=mode, now=0)
    got = list(got) if isinstance(got, tuple) else [got]
    assert all(g.shape == (9,) and not g.any() for g in got)
    assert K.LAUNCHES[f"aligned.{mode}"] == 0
