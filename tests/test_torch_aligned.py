"""The port's bucket-aligned table layout against the reference's.

``EngineConfig(flat_aligned=True)`` stores each bucket of a point table
as ONE row of a width-stratum level (engine/hash.py ``build_aligned``),
probed by ``kernels.fused_probe_aligned``.  Built from the same inputs,
the port must reproduce the reference package (``gochugaru_tpu``), bit
for bit:

- ``build_aligned`` level for level over three ``cover`` ladders, and
  its refusal of a duplicate-heavy tail;
- ``probe_aligned`` against the reference's jnp one, with negative and
  absent keys on a ladder of at least three levels;
- ``fused_probe_aligned``'s plain twin, mode by mode, int32 and packed,
  against the reference's XLA chain (``probe_aligned`` +
  ``packed.decode_block`` + the site tail);
- ``prepare_host`` arrays and FlatMeta, and the check planes, against the
  reference's ``flat_aligned=True`` engine (``pallas=False``) on every
  world of test_torch_engine.py plus a three-level ladder;
- lookups over an aligned snapshot with arrows (candidate blocks, pages
  and cursors, answers) against the reference's ``spmm=False`` path;
- a CPU client with the aligned configuration against the oracle.

Every output is int or bool: exact equality.  The CUDA kernel is held to
the plain twin by the ``cuda``-marked test here and by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_engine as TE
import test_torch_lookup as TL
from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine import lookup as jlookup
from gochugaru_tpu.engine import packed as JPK
from gochugaru_tpu.engine import spmv as jspmv
from gochugaru_tpu.engine.flat import _al_key as j_al_key

from gochugaru_tpu_torch import consistency as pcons, rel as prel
from gochugaru_tpu_torch.client import new_evaluator, with_engine_config
from gochugaru_tpu_torch.engine import hash as PH
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine import lookup as plookup
from gochugaru_tpu_torch.engine import spmv as pspmv
from gochugaru_tpu_torch.engine.device import to_device_tensor
from gochugaru_tpu_torch.engine.flat import _al_key
from gochugaru_tpu_torch.engine.plan import EngineConfig as PConfig
from gochugaru_tpu_torch.utils.context import background

NOW = TE.NOW
COVERS = [(0.999,), (0.99, 0.999), (0.5, 0.9)]


# ---------------------------------------------------------------------------
# host build and device probe
# ---------------------------------------------------------------------------


def _ladder_cols(seed, n=6_000, dup=20):
    """Two key columns (one full key repeated ``dup`` times, forcing
    deeper levels) plus two payload columns and an expiry column (0,
    expired and live stamps around 500)."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, n // 3, n).astype(np.int32)
    k2 = rng.integers(0, 40, n).astype(np.int32)
    k1[:dup], k2[:dup] = 7, 9
    u_d = rng.integers(0, 1000, n).astype(np.int32)
    u_p = (u_d // 2).astype(np.int32)
    exp = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 1000, n)).astype(np.int32)
    return [k1, k2], [k1, k2, u_d, u_p, exp]


@pytest.mark.parametrize("cover", COVERS, ids=lambda c: "-".join(map(str, c)))
def test_build_aligned_matches_reference(cover):
    keys, cols = _ladder_cols(1)
    want = JH.build_aligned(keys, cols, cover=cover)
    got = PH.build_aligned(keys, cols, cover=cover)
    assert got is not None and want is not None
    assert (got.w, got.n, got.caps) == (want.w, want.n, want.caps)
    assert len(got.levels) >= 2
    for (a, _), (b, _) in zip(got.levels, want.levels):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)
    if cover == (0.5, 0.9):
        assert len(got.levels) >= 3


def test_build_aligned_duplicate_tail_falls_back_on_both_sides():
    n = 4000
    k = np.zeros(n, np.int32)
    pay = np.arange(n, dtype=np.int32)
    assert JH.build_aligned([k, k], [k, k, pay]) is None
    assert PH.build_aligned([k, k], [k, k, pay]) is None


def test_level_salts_match_reference():
    for lvl in range(9):
        assert PH._level_salt(lvl) == JH._level_salt(lvl)
    assert PH._level_salt(1) == JH._SPILL_SALT
    assert [_al_key("tx", l) for l in range(4)] == [
        j_al_key("tx", l) for l in range(4)
    ] == ["tx_al", "tx_als", "tx_als2", "tx_als3"]


def test_aligned_budget_and_ladder_are_the_reference_defaults():
    j = TE.JConfig()
    assert PH.ALIGNED_MAX_BYTES == j.flat_aligned_max_bytes
    assert PH.ALIGNED_COVER == tuple(j.flat_aligned_cover)
    assert PConfig().flat_aligned_max_bytes == j.flat_aligned_max_bytes
    assert PConfig().flat_aligned_cover == tuple(j.flat_aligned_cover)
    assert PConfig().flat_aligned is False


def _ladder(seed, packed, cover=(0.5, 0.9)):
    """A >= 3-level aligned ladder (int32, or packed levels sharing one
    spec as engine/flat.py packs them) and a [9, 40] query lattice mixing
    present, absent and negative keys."""
    keys, cols = _ladder_cols(seed)
    ai = JH.build_aligned(keys, cols, cover=cover)
    assert ai is not None and len(ai.levels) >= 3
    tbls, sw, spec = [t for t, _ in ai.levels], ai.w, None
    if packed:
        spec = JPK.make_spec([JPK.col_range(-1, 2_000), JPK.col_range(-1, 40)]
                             + [JPK.col_range(-1, 1000)] * 3)
        tbls = [JPK.pack_rows(t.reshape(-1, ai.w), spec).reshape(t.shape[0], -1)
                for t in tbls]
        sw = spec[1]
    rng = np.random.default_rng(seed + 100)
    qi = rng.integers(0, keys[0].shape[0], (9, 40))
    q1 = keys[0][qi].copy()
    q2 = keys[1][qi].copy()
    q1[0, :5] = (7, -1, 2_500, 7, -3)  # the duplicated key, negative, absent
    q2[0, :5] = (9, 9, 1, -2, 9)
    q2[1] = rng.integers(0, 41, 40)  # mostly absent pairs
    return dict(tbls=tbls, caps=ai.caps, sw=sw, spec=spec, qs=(q1, q2))


def _ref_block(t):
    """The reference's XLA chain: probe_aligned, then decode_block."""
    blk = JH.probe_aligned([jnp.asarray(x) for x in t["tbls"]], t["caps"],
                           t["sw"], tuple(jnp.asarray(q) for q in t["qs"]))
    if t["spec"] is not None:
        blk = JPK.decode_block(blk, t["spec"])
    return np.asarray(blk)


def _probe(t, mode, device="cpu", plain=False, qs=None, **kw):
    dev = torch.device(device)
    return K.fused_probe_aligned(
        tuple(torch.from_numpy(q).to(dev) for q in (qs or t["qs"])),
        [to_device_tensor(x, dev) for x in t["tbls"]], t["caps"], t["sw"],
        spec=t["spec"], mode=mode, now=500, plain=plain, **kw,
    )


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_probe_aligned_matches_reference(packed):
    t = _ladder(2, packed)
    got = PH.probe_aligned([to_device_tensor(x, "cpu") for x in t["tbls"]],
                           t["caps"], t["sw"],
                           [torch.from_numpy(q) for q in t["qs"]])
    want = JH.probe_aligned([jnp.asarray(x) for x in t["tbls"]], t["caps"],
                            t["sw"], tuple(jnp.asarray(q) for q in t["qs"]))
    assert tuple(got.shape) == (9, 40, sum(t["caps"]), t["sw"])
    assert np.array_equal(got.numpy().view(np.asarray(want).dtype),
                          np.asarray(want))


def _ref_tail(ref, qs, mode, exp_lane=None):
    q1, q2 = qs
    hit = ((ref[..., 0] == q1[..., None]) & (ref[..., 1] == q2[..., None])
           & (q1 >= 0)[..., None] & (q2 >= 0)[..., None])
    if mode == "block":
        return [ref]
    if mode == "any":
        return [hit.any(-1)]
    if mode == "until2":
        return [(hit & (ref[..., 2] > 500)).any(-1),
                (hit & (ref[..., 3] > 500)).any(-1)]
    live = hit
    if exp_lane is not None:
        e = np.where(hit, ref[..., exp_lane], 0)
        live = hit & ((e == 0) | (e > 500))
    return [hit, live]


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
@pytest.mark.parametrize("mode", K.ALIGNED_MODES)
def test_aligned_twin_matches_reference_chain(mode, packed):
    t = _ladder(3, packed)
    ref = _ref_block(t)
    exp_lane = 4 if mode == "gate" else None
    got = _probe(t, mode, exp_lane=exp_lane)
    got = list(got) if isinstance(got, tuple) else [got]
    want = _ref_tail(ref, t["qs"], mode, exp_lane)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a.numpy(), b), mode
    hit = _ref_tail(ref, t["qs"], "gate", 4)
    # the lattice exercises hits past level 0, misses and expired rows
    lvl0 = t["caps"][0]
    assert hit[0][..., lvl0:].any() and (~hit[0].any(-1)).any()
    assert (hit[0] & ~hit[1]).any()


def test_aligned_twin_broadcasts_and_takes_one_key_column():
    t = _ladder(4, False)
    q1, q2 = t["qs"]
    got = _probe(t, "any", qs=(q1[:, :1], q2[:1, :]))
    ref = _ref_tail(_ref_block(dict(t, qs=np.broadcast_arrays(q1[:, :1], q2[:1, :]))),
                    np.broadcast_arrays(q1[:, :1], q2[:1, :]), "any")[0]
    assert got.shape == (9, 40) and np.array_equal(got.numpy(), ref)
    keys, cols = _ladder_cols(5)
    ai = PH.build_aligned([keys[0]], [keys[0], cols[2]], cover=(0.5, 0.9))
    one = dict(tbls=[x for x, _ in ai.levels], caps=ai.caps, sw=ai.w, spec=None,
               qs=(keys[0][:50],))
    blk = _probe(one, "block")
    assert blk.shape == (50, sum(ai.caps), 2)
    assert _probe(one, "any").all()
    empty = _probe(t, "gate", qs=(q1[:0, 0], q2[:0, 0]))
    assert [x.shape for x in empty] == [(0, sum(t["caps"]))] * 2


def test_cpu_aligned_calls_launch_nothing():
    t = _ladder(6, True)
    K.reset_launches()
    for mode in K.ALIGNED_MODES:
        _probe(t, mode)
    assert all(n == 0 for n in K.LAUNCHES.values())
    assert {f"aligned.{m}" for m in K.ALIGNED_MODES} <= set(K.LAUNCHES)


# ---------------------------------------------------------------------------
# prepare and planes vs the reference's flat_aligned=True engine
# ---------------------------------------------------------------------------


ALIGNED_WORLDS = {k: (make, None) for k, make in TE.WORLDS.items()}
# a three-level ladder on the docs world
ALIGNED_WORLDS["docs_cover_3"] = (TE._docs_world, (0.99, 0.999))


def _aligned(make, cover=None):
    """An aligned world.  ``cover`` is the ladder: the EngineConfig field
    ``flat_aligned_cover`` of both packages."""
    w = make()
    w.cfg = dict(w.cfg, flat_aligned=True)
    if cover is not None:
        w.cfg["flat_aligned_cover"] = tuple(cover)
    return w


@pytest.fixture(scope="module", params=sorted(ALIGNED_WORLDS))
def aworld(request):
    w = _aligned(*ALIGNED_WORLDS[request.param])
    je = w.j_engine()
    jd = je.prepare(w.j_snap)
    np_arrays = {k: np.asarray(v) for k, v in jd.arrays.items()}
    return w, je, jd, np_arrays


def test_aligned_prepare_matches_reference(aworld, monkeypatch):
    """Key for key (``_al``/``_als``/``_als2`` included) and bit for bit,
    with equal FlatMeta.  A table that went aligned has no HashIndex, so
    its probe geometry (e_cap, cl_cap, t_cap, pf_e_cap) takes the
    reference's defaults."""
    w, je, jd, np_arrays = aworld
    pe = w.p_engine()
    arrays, meta = pe.prepare_host(w.p_snap)
    assert set(arrays) == set(np_arrays)
    for k, v in np_arrays.items():
        assert arrays[k].dtype == v.dtype, k
        assert np.array_equal(arrays[k], v), k
    jm = dataclasses.asdict(jd.flat_meta)
    pm = dataclasses.asdict(meta)
    assert pm == {k: jm[k] for k in pm}
    al = {k: caps for k, _w, caps in meta.aligned}
    assert "ehx" in al and "ehx" not in arrays and "eh_off" not in arrays
    assert meta.e_cap == 4
    for tbl, caps in al.items():
        assert all(_al_key(tbl, l) in arrays for l in range(len(caps)))
    geom = {"clx": "cl_cap", "tx": "t_cap", "pfx": "pf_e_cap"}
    for tbl, field in geom.items():
        if tbl in al:
            assert getattr(meta, field) == 4, field
    packed = {k for k, _spec in meta.packed}
    assert packed & set(al)  # aligned levels pack under their table's spec


def test_aligned_planes_match_reference(aworld, monkeypatch):
    w, je, jd, _np_arrays = aworld
    ref = TE._ref_planes(w, je, jd)
    pe = w.p_engine()
    pd = pe.prepare(w.p_snap)
    assert pd.flat_meta.aligned
    for k, _w, _caps in pd.flat_meta.aligned:
        if k in dict(pd.flat_meta.packed):
            assert k in pd.specs
    got = TE._port_planes(w, pe, pd)
    for name, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), name
    # the same planes as the off+interleave snapshot
    pe0 = PConfig(**{k: v for k, v in w.cfg.items() if k != "flat_aligned"})
    from gochugaru_tpu_torch.engine.device import DeviceEngine

    e0 = DeviceEngine(w.p_cs, pe0, device="cpu")
    got0 = TE._port_planes(w, e0, e0.prepare(w.p_snap))
    for name, a, b in zip("dpo", got0, got):
        assert np.array_equal(a, b), name


def test_three_level_ladder_reaches_the_planes(monkeypatch):
    """cover=(0.5, 0.9): the docs world's point tables take >= 3 levels,
    and the planes still equal the reference's."""
    w = _aligned(TE._docs_world, (0.5, 0.9))
    je = w.j_engine()
    jd = je.prepare(w.j_snap)
    pe = w.p_engine()
    pd = pe.prepare(w.p_snap)
    assert max(len(c) for _k, _w, c in pd.flat_meta.aligned) >= 3
    assert dataclasses.asdict(pd.flat_meta) == {
        k: v for k, v in dataclasses.asdict(jd.flat_meta).items()
        if k in dataclasses.asdict(pd.flat_meta)}
    ref = TE._ref_planes(w, je, jd)
    got = TE._port_planes(w, pe, pd)
    for name, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), name


# ---------------------------------------------------------------------------
# lookups over an aligned snapshot with arrows
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["docs", "rbac"])
def alw(request):
    lw = {"docs": TL._docs, "rbac": TL._rbac}[request.param]

    orig = TE.World.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.cfg = dict(self.cfg, flat_aligned=True)

    TE.World.__init__ = init
    try:
        out = lw()
    finally:
        TE.World.__init__ = orig
    assert "argx" in {k for k, _w, _c in out.pd.flat_meta.aligned}
    assert "argx" in {k for k, _w, _c in out.jd.flat_meta.aligned}
    return out


def test_aligned_lookup_candidates_match_reference(alw):
    jst = jspmv.state_for(alw.je, alw.jd)
    pst = pspmv.state_for(alw.pe, alw.pd)
    assert jst._spmm is None and jst.arg_aligned
    n = 0
    for q in alw.res_q:
        r = plookup._resolve_resources(alw.pd, *q)
        assert r == jlookup._resolve_resources(alw.jd, *q)
        if r is None:
            continue
        rtid, _p, srel, subj, wc = r
        want = TL._blocks(jst.resource_candidates(rtid, subj, srel, wc, NOW))
        got = TL._blocks(pst.resource_candidates(rtid, subj, srel, wc, NOW))
        assert len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want)), q
        n += bool(want)
    for q in alw.subj_q:
        r = plookup._resolve_subjects(alw.pd, *q)
        if r is None:
            continue
        res, _p, srel, stid, wc = r
        want = TL._blocks(jst.subject_candidates(res, stid, srel, wc, NOW))
        got = TL._blocks(pst.subject_candidates(res, stid, srel, wc, NOW))
        assert len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want)), q
        n += bool(want)
    assert n


def test_aligned_lookup_arrow_probe_matches_reference(alw):
    """The forward arrow hop (argx's aligned ladder through
    fused_probe_aligned's block mode) == the reference's XLA
    probe_aligned body."""
    jst = jspmv.state_for(alw.je, alw.jd)
    pst = pspmv.state_for(alw.pe, alw.pd)
    rng = np.random.default_rng(3)
    keys = np.concatenate([
        rng.integers(-2, alw.pd.flat_meta.N * 4, 300), [-1, 0]]).astype(np.int32)
    jlo, jln, jtot = jst.kern.runs("arg", jst.arg_args, keys)
    plo, pln, ptot = pst.kern.runs("arg", pst.arg_args, keys)
    assert ptot == jtot
    assert np.array_equal(plo.numpy(), np.asarray(jlo))
    assert np.array_equal(pln.numpy(), np.asarray(jln))


def test_aligned_pages_and_answers_match_reference(alw):
    cs = alw.w.p_cs
    for q in alw.res_q[::2]:
        got = plookup.lookup_resources_device(
            alw.pe, alw.pd, *q, now_us=NOW, oracle_factory=lambda: alw.p_oracle)
        TL._assert_answer(cs, q[2], q[4], got, alw.p_oracle.lookup_resources(*q))
        assert got == jlookup.lookup_resources_device(
            alw.je, alw.jd, *q, now_us=NOW,
            oracle_factory=lambda: alw.j_oracle), q
    for q in alw.subj_q[::2]:
        got = plookup.lookup_subjects_device(
            alw.pe, alw.pd, *q, now_us=NOW, oracle_factory=lambda: alw.p_oracle)
        TL._assert_answer(cs, q[3], q[4], got, alw.p_oracle.lookup_subjects(*q))
        assert got == jlookup.lookup_subjects_device(
            alw.je, alw.jd, *q, now_us=NOW,
            oracle_factory=lambda: alw.j_oracle), q
    for q in alw.res_q[1::5]:
        want = TL._walk_pages(jlookup.lookup_resources_page, alw.je, alw.jd, q,
                              alw.j_oracle, 3)
        got = TL._walk_pages(plookup.lookup_resources_page, alw.pe, alw.pd, q,
                             alw.p_oracle, 3)
        assert got == want, q


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


def test_aligned_client_matches_oracle():
    from gochugaru_tpu_torch.engine.oracle import Oracle, T

    rels = [TE._port_rel(r) for r in TE._random_rels(9, 300)]
    c = new_evaluator(with_engine_config(PConfig(flat_aligned=True)),
                      device="cpu")
    ctx = background()
    c.write_schema(ctx, TE.RANDOM_SCHEMA)
    txn = prel.Txn()
    for r in rels:
        txn.touch(r)
    c.write(ctx, txn)
    oracle = Oracle(c.store.snapshot_for(pcons.full()).compiled, rels)
    checks = [TE._port_rel(r) for r in TE._random_checks(9, 120)]
    got = c.check(ctx, pcons.full(), *checks)
    want = [oracle.check_relationship(r) == T for r in checks]
    assert got == want and any(want) and not all(want)
    dsnap = next(iter(c._dsnap_cache.values()))
    assert dsnap.flat_meta.aligned
    for subj in ("user:u0", "user:u3", "team:t4#member"):
        st, rest = subj.split(":")
        sid, _, srel = rest.partition("#")
        got = list(c.lookup_resources(ctx, pcons.full(), "doc#view", subj))
        TL._assert_answer(dsnap.snapshot.compiled, st, srel, got,
                          oracle.lookup_resources("doc", "view", st, sid, srel))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernel has no"
                    " CPU mode); chip_smoke.py runs this comparison on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_aligned_kernel_equals_plain_on_card(cuda_device, packed):
    t = _ladder(7, packed)
    for mode in K.ALIGNED_MODES:
        kw = {"exp_lane": 4} if mode == "gate" else {}
        k = _probe(t, mode, cuda_device, **kw)
        p = _probe(t, mode, cuda_device, plain=True, **kw)
        ks = k if isinstance(k, tuple) else (k,)
        ps = p if isinstance(p, tuple) else (p,)
        for a, b in zip(ks, ps):
            assert torch.equal(a.cpu(), b.cpu()), mode
