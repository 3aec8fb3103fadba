"""The fused probe seam (gochugaru_tpu_torch/engine/kernels) against the
reference's XLA chain, mode by mode.

References are built as tests/test_pallas.py builds them: the reference's
``probe_block`` (or gather-then-``decode_block`` for packed tables with
anchored offsets) followed by the site's own compare and gate folds.
On the CPU the seam runs the plain PyTorch version; on a card the CUDA
kernel must equal that plain version bit for bit (``cuda``-marked test,
also driven by chip_smoke.py).  Every output is int or bool: exact
equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine import packed as JPK
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import to_device_tensor

NOW = 500


def _table(seed, packed):
    """Random 2-key table with two until columns and an expiry column
    (0 = never, else a stamp around NOW)."""
    rng = np.random.default_rng(seed)
    n = 600
    k1 = rng.integers(0, 70, n).astype(np.int32)
    k2 = rng.integers(0, 40, n).astype(np.int32)
    u_d = rng.integers(0, 1000, n).astype(np.int32)
    u_p = (u_d // 2).astype(np.int32)
    exp = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 1000, n)).astype(np.int32)
    hi = JH.build_hash([k1, k2], target_cap=4)
    raw = JH.interleave_buckets(hi, [k1, k2, u_d, u_p, exp])
    out = dict(raw=raw, hi=hi, spec=None, off=hi.off, off_a=None, ashift=None)
    if packed:
        spec = JPK.make_spec([
            JPK.col_range(-1, 70), JPK.col_range(-1, 40),
            JPK.col_range(-1, 1000), JPK.col_range(-1, 1000),
            JPK.col_range(-1, 1000),
        ])
        res, anchor = JPK.pack_off(hi.off)
        out.update(tbl=JPK.pack_rows(raw, spec), spec=spec, off=res,
                   off_a=anchor, ashift=JPK.OFF_ANCHOR_SHIFT)
    else:
        out["tbl"] = raw
    q1 = rng.integers(-2, 72, (9, 5)).astype(np.int32)  # negatives: dead lanes
    q2 = rng.integers(0, 41, (9, 5)).astype(np.int32)
    out["qs"] = (q1, q2)
    return out


def _ref_block(t):
    """Reference block: probe_block (unpacked) or anchored-offset gather
    then decode_block (packed), exactly as test_pallas.py builds it."""
    qs = tuple(jnp.asarray(q) for q in t["qs"])
    if t["spec"] is None:
        return np.asarray(JH.probe_block(
            jnp.asarray(t["off"]), jnp.asarray(t["tbl"]), t["hi"].cap, qs))
    hh = (JH.mix32(list(qs), jnp) & jnp.uint32(t["hi"].size - 1)).astype(jnp.int32)
    start = (JH.take_in_bounds(jnp.asarray(t["off_a"]), hh >> t["ashift"])
             + JH.take_in_bounds(jnp.asarray(t["off"]), hh).astype(jnp.int32))
    return np.asarray(JPK.decode_block(
        JH.slice_blocks(jnp.asarray(t["tbl"]), start, t["hi"].cap), t["spec"]))


def _probe(t, mode, device="cpu", plain=False, **kw):
    dev = torch.device(device)
    return K.fused_probe(
        tuple(torch.from_numpy(q).to(dev) for q in t["qs"]),
        to_device_tensor(t["off"], dev), to_device_tensor(t["tbl"], dev),
        cap=t["hi"].cap, spec=t["spec"],
        off_a=None if t["off_a"] is None else to_device_tensor(t["off_a"], dev),
        ashift=t["ashift"], mode=mode, now=NOW, plain=plain, **kw,
    )


def _ref_hit(ref, qs):
    q1, q2 = qs
    return ((ref[..., 0] == q1[..., None]) & (ref[..., 1] == q2[..., None])
            & (q1 >= 0)[..., None] & (q2 >= 0)[..., None])


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_block_mode(packed):
    t = _table(0, packed)
    got = _probe(t, "block").numpy()
    assert got.shape == t["qs"][0].shape + (t["hi"].cap, 5)
    assert np.array_equal(got, _ref_block(t))


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_any_mode(packed):
    t = _table(1, packed)
    hit = _ref_hit(_ref_block(t), t["qs"])
    assert np.array_equal(_probe(t, "any").numpy(), hit.any(-1))
    assert hit.any() and not hit.any(-1).all()


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_until2_mode(packed):
    t = _table(2, packed)
    ref = _ref_block(t)
    hit = _ref_hit(ref, t["qs"])
    d, p = _probe(t, "until2")
    assert np.array_equal(d.numpy(), (hit & (ref[..., 2] > NOW)).any(-1))
    assert np.array_equal(p.numpy(), (hit & (ref[..., 3] > NOW)).any(-1))


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_gate_mode(packed):
    """gate == the reference's gate2_blk expiry fold (flat.py)."""
    t = _table(3, packed)
    ref = _ref_block(t)
    hit = _ref_hit(ref, t["qs"])
    exp = np.where(hit, ref[..., 4], 0)
    live = hit & ((exp == 0) | (exp > NOW))
    g_hit, g_live = _probe(t, "gate", exp_lane=4)
    assert np.array_equal(g_hit.numpy(), hit)
    assert np.array_equal(g_live.numpy(), live)
    assert (hit & ~live).any()  # some hit rows are expired
    n_hit, n_live = _probe(t, "gate")  # no expiry lane: live == hit
    assert np.array_equal(n_live.numpy(), hit)


def test_cpu_calls_run_the_plain_version_and_launch_nothing():
    t = _table(4, True)
    K.reset_launches()
    for mode in K.MODES:
        if mode == "runs":
            r = _runs_table(4, True)
            _runs(r)
        else:
            _probe(t, mode)
    assert set(K.LAUNCHES) >= set(K.MODES)
    assert all(n == 0 for n in K.LAUNCHES.values())


def _runs_table(seed, packed):
    """A rev-style table (engine/rev.py layout: buckets by mix32 of column
    0, rows sorted within each bucket) with one 1,500-row key, so the
    bisect cap is 2,048; keys mix present, absent and negative."""
    from gochugaru_tpu_torch.engine import rev as R
    from gochugaru_tpu_torch.engine.partition import _hash_cols

    rng = np.random.default_rng(seed)
    k0 = np.concatenate([np.full(1500, 9, np.int32),
                         rng.integers(10, 900, 3000).astype(np.int32)])
    k1 = rng.integers(0, 70_000, k0.shape[0]).astype(np.int32)
    h = _hash_cols([k0])
    geom = R.rev_geom(h, 1)
    off, tbl = R.build_rev_full(h, [k0, k1], geom, 2)
    cap = R.rev_meta_kw(geom, geom, None)["rv_cap"]
    out = dict(off=off, tbl=tbl, spec=None, off_a=None, ashift=None, cap=cap)
    if packed:
        spec = JPK.make_spec([JPK.col_range(-1, 900), JPK.col_range(-1, 70_000)])
        res, anchor = JPK.pack_off(off)
        out.update(tbl=JPK.pack_rows(tbl, spec), spec=spec, off=res,
                   off_a=anchor, ashift=JPK.OFF_ANCHOR_SHIFT)
    keys = rng.integers(-3, 950, 5000).astype(np.int32)
    keys[:3] = (9, -1, 9)
    out["keys"] = keys
    out["k0"] = k0
    return out


def _runs(r, device="cpu", plain=False):
    dev = torch.device(device)
    return K.fused_probe(
        (torch.from_numpy(r["keys"]).to(dev),),
        to_device_tensor(r["off"], dev), to_device_tensor(r["tbl"], dev),
        cap=r["cap"], spec=r["spec"],
        off_a=None if r["off_a"] is None else to_device_tensor(r["off_a"], dev),
        ashift=r["ashift"], mode="runs", plain=plain,
    )


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_runs_mode_finds_each_keys_rows(packed):
    """runs: (lo, ln) is each present key's contiguous run of rows, (0, 0)
    for absent or negative keys (the reference body is held to the same
    outputs in test_torch_lookup.py)."""
    r = _runs_table(6, packed)
    assert r["cap"] == 2048
    lo, ln = (x.numpy() for x in _runs(r))
    keys, k0 = r["keys"], r["k0"]
    counts = np.bincount(k0, minlength=1000)
    ok = keys >= 0
    assert np.array_equal(ln[ok], counts[keys[ok]])
    assert (lo[~ok] == 0).all() and (ln[~ok] == 0).all()
    assert ln[0] == 1500


@pytest.mark.parametrize("shapes", [
    ((5,),), ((1,), (7,)), ((4, 1), (1, 3)), ((2, 1, 3), (5, 1)), ((0,), (1,)),
    ((3, 0), (1, 0)), ((), (6,)),
])
def test_broadcast_shape_equals_torch(shapes):
    assert K.broadcast_shape(*shapes) == tuple(torch.broadcast_shapes(*shapes))


def test_spec_tensors_pad_dictionaries_with_their_last_value():
    spec = JPK.make_spec([JPK.col_range(-1, 9), JPK.col_dict((3, 8, 2**31 - 1))])
    f, d = K.spec_tensors(spec, "cpu")
    assert f.shape == (2, 5) and f.dtype == torch.int32
    assert d.shape == (1, 256)
    assert d[0, :3].tolist() == [3, 8, 2**31 - 1]
    assert (d[0, 3:] == 2**31 - 1).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernel has no"
                    " CPU mode); chip_smoke.py runs this comparison on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_runs_kernel_equals_plain_on_card(cuda_device, packed):
    r = _runs_table(7, packed)
    k = _runs(r, cuda_device)
    p = _runs(r, cuda_device, plain=True)
    for a, b in zip(k, p):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_kernel_equals_plain_on_card(cuda_device, packed):
    t = _table(5, packed)
    for mode, kw in (("block", {}), ("any", {}), ("until2", {}),
                     ("gate", {"exp_lane": 4})):
        k = _probe(t, mode, cuda_device, **kw)
        p = _probe(t, mode, cuda_device, plain=True, **kw)
        ks = k if isinstance(k, tuple) else (k,)
        ps = p if isinstance(p, tuple) else (p,)
        for a, b in zip(ks, ps):
            assert torch.equal(a.cpu(), b.cpu()), mode
