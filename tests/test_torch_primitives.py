"""The port's device primitives against the reference's: mix32, the slice
clamp, and the packed decode.  Inputs come from numpy with fixed seeds;
every output is an integer, so the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine import packed as JPK
from gochugaru_tpu_torch.engine import hash as PH
from gochugaru_tpu_torch.engine import packed as PPK
from gochugaru_tpu_torch.engine.device import to_device_tensor

_EDGES = np.array(
    [-(2**31), -(2**31) + 1, -65536, -1, 0, 1, 255, 65535, 65536,
     2**24 - 1, 2**30, 2**31 - 2, 2**31 - 1], np.int64,
)


def _full_range(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(-(2**31), 2**31, n, dtype=np.int64)
    return np.concatenate([_EDGES, v]).astype(np.int32)


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_mix32_matches_numpy_over_int32_range(ncols):
    cols = [_full_range(20_000, 11 + k) for k in range(ncols)]
    # every pairing of the edge values appears in the first columns
    want = JH.mix32(cols, np).astype(np.int64)
    got = PH.mix32_t([torch.from_numpy(c) for c in cols]).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


def test_bucket_of_and_probe_block_match_reference():
    rng = np.random.default_rng(3)
    k1 = rng.integers(0, 90, 700).astype(np.int32)
    k2 = rng.integers(0, 40, 700).astype(np.int32)
    pay = rng.integers(-5, 1000, 700).astype(np.int32)
    hi = JH.build_hash([k1, k2], target_cap=4)
    tbl = JH.interleave_buckets(hi, [k1, k2, pay])
    q1 = rng.integers(-3, 95, (6, 7)).astype(np.int32)
    q2 = rng.integers(0, 41, (6, 7)).astype(np.int32)
    ref = np.asarray(JH.probe_block(
        jnp.asarray(hi.off), jnp.asarray(tbl), hi.cap,
        (jnp.asarray(q1), jnp.asarray(q2))))
    got = PH.probe_block(
        torch.from_numpy(hi.off), torch.from_numpy(tbl), hi.cap,
        (torch.from_numpy(q1), torch.from_numpy(q2))).numpy()
    assert got.shape == (6, 7, hi.cap, 3)
    assert np.array_equal(got, ref)


def test_slice_blocks_clamps_like_reference():
    tbl = np.arange(40, dtype=np.int32).reshape(20, 2)
    start = np.array([-5, 0, 3, 17, 18, 30], np.int32)
    ref = np.asarray(JH.slice_blocks(jnp.asarray(tbl), jnp.asarray(start), 4))
    got = PH.slice_blocks(torch.from_numpy(tbl), torch.from_numpy(start), 4)
    assert np.array_equal(got.numpy(), ref)


def _pack_case(seed):
    """A table with every field kind: dictionary, delta, a full 32-bit
    field, a zero-bit constant, plain ranges straddling lanes."""
    rng = np.random.default_rng(seed)
    n = 257
    k = rng.integers(-1, 5000, n).astype(np.int32)
    dic_vals = (7, 100, 2**31 - 1, -1)
    d = np.asarray(dic_vals, np.int32)[rng.integers(0, 4, n)]
    lo = rng.integers(0, 3000, n).astype(np.int32)
    run = (lo + rng.integers(0, 9, n)).astype(np.int32)
    full = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    const = np.full(n, 42, np.int32)
    small = rng.integers(-1, 3, n).astype(np.int32)
    tbl = np.stack([k, d, lo, run, full, const, small], axis=1)
    spec = JPK.make_spec([
        JPK.col_range(-1, 5000),
        JPK.col_dict(dic_vals),
        JPK.col_range(0, 3000),
        JPK.col_delta(0, 8, 2),
        JPK.col_range(-(2**31), 2**31 - 1),
        JPK.col_const(42),
        JPK.col_range(-1, 2),
    ])
    assert spec is not None
    kinds = {(f[0] == 0, f[2] >= 0, f[3] >= 0, f[0] == 32) for f in spec[2]}
    assert (True, False, False, False) in kinds  # zero-bit constant
    assert (False, True, False, False) in kinds  # delta
    assert (False, False, True, False) in kinds  # dictionary
    assert (False, False, False, True) in kinds  # 32-bit
    return tbl, spec


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_block_matches_reference_on_every_field_kind(seed):
    tbl, spec = _pack_case(seed)
    packed = JPK.pack_rows(tbl, spec)
    blk = packed.reshape(257, 1, -1)
    ref = np.asarray(JPK.decode_block(jnp.asarray(blk), spec))
    got = PPK.decode_block(to_device_tensor(blk, "cpu"), spec).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    assert np.array_equal(got.reshape(257, -1), tbl)


def test_port_pack_rows_matches_reference():
    tbl, spec = _pack_case(2)
    assert np.array_equal(PPK.pack_rows(tbl, spec), JPK.pack_rows(tbl, spec))
    res_j = JPK.pack_off(np.cumsum(np.arange(5000) % 5).astype(np.int32))
    res_p = PPK.pack_off(np.cumsum(np.arange(5000) % 5).astype(np.int32))
    assert all(np.array_equal(a, b) for a, b in zip(res_j, res_p))
