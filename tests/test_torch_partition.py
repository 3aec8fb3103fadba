"""The port's partition-first stacking against the reference's.

engine/partition.py builds a bucket-sharded table a shard at a time from
the key hashes (``point_geom`` / ``range_geom`` decide the shapes first);
engine/rev.py builds the reverse-CSR index the same way
(``build_rev_shards`` / ``build_rev_partitioned``).  Fed the same
columns (numpy, from a seed), the port must give the reference package's
arrays bit for bit — offsets, group tables, row tables, pads — over
empty, tiny, duplicate-heavy and native-threshold-crossing inputs, the
owned-subset form (``ShardSlices``) must equal the matching blocks of the
full arrays, and the partitioned builds must equal the port's own
build-full-then-stack ones (``_stack_point`` / ``_stack_range`` /
``build_rev_full``), as tests/test_partition.py holds the reference's.
All outputs are ints: exact equality.
"""

import numpy as np
import pytest

from gochugaru_tpu.engine import partition as JP, rev as JR

from gochugaru_tpu_torch.engine import flat as PF, hash as PH
from gochugaru_tpu_torch.engine import partition as PP, rev as PR
from gochugaru_tpu_torch.native.sort import sorted_runs


def _keys(rng, n, dup_frac):
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    k1 = rng.integers(0, max(int(n * (1 - dup_frac)), 2), n).astype(np.int32)
    k2 = rng.integers(0, 1 << 20, n).astype(np.int32)
    return k1, k2


def _eq(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("n", [0, 1, 37, 5_000, 80_000])
@pytest.mark.parametrize("M", [1, 2, 8])
def test_stack_point_matches_reference(n, M):
    rng = np.random.default_rng(n * 31 + M)
    k1, k2 = _keys(rng, n, dup_frac=0.3)
    pay = rng.integers(-1, 1 << 15, n).astype(np.int32)
    cols = [k1, k2, pay]
    ms = max(8, M)

    h_full = PP._hash_cols([k1, k2])
    assert np.array_equal(h_full, JP._hash_cols([k1, k2]))
    geom = PP.point_geom(h_full, M, min_size=ms)
    jgeom = JP.point_geom(h_full, M, min_size=ms)
    assert (geom.size, geom.cap, geom.n, geom.R_pad) == (
        jgeom.size, jgeom.cap, jgeom.n, jgeom.R_pad)
    got_off, got_tbl = PP.stack_point(h_full, PP.gather_cols(cols), geom, 3)
    ref_off, ref_tbl = JP.stack_point(h_full, JP.gather_cols(cols), jgeom, 3)
    _eq(got_off, ref_off, "off")
    _eq(got_tbl, ref_tbl, "tbl")
    # the port's full-then-stack build gives the same bits
    h = PH.build_hash([k1, k2], min_size=ms)
    st_off, st_tbl = PF._stack_point(h, cols, M)
    _eq(st_off, got_off, "stacked off")
    _eq(st_tbl, got_tbl, "stacked tbl")

    owned = [0, M - 1] if M > 1 else [0]
    so, st = PP.stack_point(h_full, PP.gather_cols(cols), geom, 3, owned=owned)
    for s in owned:
        _eq(so.blocks[s], ref_off[s * (geom.bpd + 1):(s + 1) * (geom.bpd + 1)],
            f"owned off {s}")
        _eq(st.blocks[s], ref_tbl[s * geom.R_pad:(s + 1) * geom.R_pad],
            f"owned tbl {s}")
    if len(owned) == M:
        _eq(st.to_full(), ref_tbl, "to_full")


def _groups(k):
    n = k.shape[0]
    if not n:
        z = np.zeros(0, np.int64)
        return np.zeros(0, np.int32), z, z
    starts = sorted_runs(k)
    ends = np.concatenate([starts[1:], np.asarray([n])])
    return np.ascontiguousarray(k[starts], np.int32), starts, ends - starts


@pytest.mark.parametrize("n", [0, 1, 53, 7_000, 80_000])
@pytest.mark.parametrize("M", [2, 4])
def test_stack_range_matches_reference(n, M):
    rng = np.random.default_rng(n * 13 + M)
    k = np.sort(rng.integers(0, max(n // 6, 2), n)).astype(np.int32)
    r1 = rng.integers(0, 1 << 20, n).astype(np.int32)
    r2 = rng.integers(-1, 9, n).astype(np.int32)
    ms = max(8, M)
    gk, glo, lens = _groups(k)
    h_g = PP._hash_cols([gk])
    geom = PP.range_geom(gk, lens, h_g, M, min_size=ms, fan_pad=64)
    jgeom = JP.range_geom(gk, lens, h_g, M, min_size=ms, fan_pad=64)
    assert (geom.cap, geom.G_pad, geom.R_pad, geom.max_run, geom.rows) == (
        jgeom.cap, jgeom.G_pad, jgeom.R_pad, jgeom.max_run, jgeom.rows)
    got = PP.stack_range(gk, glo, lens, h_g, PP.gather_cols([r1, r2]), geom, 2)
    ref = JP.stack_range(gk, glo, lens, h_g, JP.gather_cols([r1, r2]), jgeom, 2)
    for a, b, nm in zip(got, ref, ("goff", "gtbl", "rows")):
        _eq(a, b, nm)
    ri = PH.build_range_hash(k, min_size=ms)
    stacked = PF._stack_range(ri, [r1, r2], M, 64)
    assert stacked[3] == geom.cap
    for a, b, nm in zip(stacked[:3], got, ("goff", "gtbl", "rows")):
        _eq(a, b, "stacked " + nm)

    so, sg, sr = PP.stack_range(gk, glo, lens, h_g, PP.gather_cols([r1, r2]),
                                geom, 2, owned=[1])
    bpd = geom.gh.bpd
    _eq(so.blocks[1], ref[0][bpd + 1:2 * (bpd + 1)], "owned goff")
    _eq(sg.blocks[1], ref[1][geom.G_pad:2 * geom.G_pad], "owned gtbl")
    _eq(sr.blocks[1], ref[2][geom.R_pad:2 * geom.R_pad], "owned rows")


@pytest.mark.parametrize("n", [0, 1, 41, 6_000, 70_000])
@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("w", [1, 4])
def test_build_rev_shards_matches_reference(n, M, w):
    """The reverse index shard by shard (rows sorted by local bucket and
    full row identity): the reference's bits from the partitioned build,
    and the same bits as the port's one-sort ``build_rev_full``."""
    rng = np.random.default_rng(n * 7 + M + w)
    key = rng.integers(0, max(n // 3, 2), n).astype(np.int32)
    cols = [key] + [rng.integers(-1, 1 << 18, n).astype(np.int32)
                    for _ in range(w - 1)]
    h = PP._hash_cols([key])
    geom = PR.rev_geom(h, M)
    jgeom = JR.rev_geom(h, M)
    assert (geom.size, geom.cap, geom.R_pad) == (jgeom.size, jgeom.cap, jgeom.R_pad)
    got = PR.build_rev_partitioned(h, PP.gather_cols(cols), geom, w)
    ref = JR.build_rev_partitioned(h, JP.gather_cols(cols), jgeom, w)
    _eq(got[0], ref[0], "off")
    _eq(got[1], ref[1], "tbl")
    full = PR.build_rev_full(h, cols, geom, w)
    _eq(full[0], got[0], "full off")
    _eq(full[1], got[1], "full tbl")

    # shard_h may hand rows over in any order: the identity sort
    # canonicalizes, so a reversed feed gives the same shard
    order, starts = PP.shard_order(h, geom.size, M)
    owned = [M - 1]

    def shard_h(s):
        return h[order[starts[s]:starts[s + 1]][::-1]]

    def shard_cols(s, perm):
        return [c[order[starts[s]:starts[s + 1]][::-1][perm]] for c in cols]

    so, st = PR.build_rev_shards(geom, w, shard_h, shard_cols, owned=owned)
    jso, jst = JR.build_rev_shards(jgeom, w, shard_h, shard_cols, owned=owned)
    s = M - 1
    _eq(so.blocks[s], jso.blocks[s], "owned off")
    _eq(st.blocks[s], jst.blocks[s], "owned tbl")
    _eq(st.blocks[s], ref[1][s * geom.R_pad:(s + 1) * geom.R_pad], "owned vs full")


def test_stack_point_precomputed_order_matches():
    """``order=`` (point_geom's frozen-branch partition handed back): the
    same bits as the self-computed partition, full and owned."""
    rng = np.random.default_rng(5)
    k1, k2 = _keys(rng, 20_000, dup_frac=0.4)
    pay = rng.integers(-1, 1 << 15, 20_000).astype(np.int32)
    cols = [k1, k2, pay]
    M = 8
    h_full = PP._hash_cols([k1, k2])
    geom = PP.point_geom(h_full, M, min_size=M)
    ord_starts = PP.shard_order(h_full, geom.size, M)
    ref = JP.stack_point(h_full, JP.gather_cols(cols), JP.point_geom(
        h_full, M, min_size=M), 3)
    got = PP.stack_point(h_full, PP.gather_cols(cols), geom, 3,
                         order=ord_starts)
    _eq(got[0], ref[0], "off")
    _eq(got[1], ref[1], "tbl")
    so, st = PP.stack_point(h_full, PP.gather_cols(cols), geom, 3,
                            owned=[1, 6], order=ord_starts)
    for s in (1, 6):
        _eq(st.blocks[s], ref[1][s * geom.R_pad:(s + 1) * geom.R_pad], f"tbl {s}")


@pytest.mark.parametrize("bpd", [1, 8, 1024])
def test_local_bucket_index_matches_reference(bpd):
    rng = np.random.default_rng(bpd)
    h = rng.integers(0, 1 << 32, 3_000, dtype=np.uint32)
    perm, off = PP.local_bucket_index(h, bpd)
    jperm, joff = JP.local_bucket_index(h, bpd)
    assert np.array_equal(perm, jperm)
    assert np.array_equal(np.asarray(off, np.int64), np.asarray(joff, np.int64))
    lb = (h & np.uint32(bpd - 1)).astype(np.int64)
    assert np.all(np.diff(lb[perm]) >= 0)
