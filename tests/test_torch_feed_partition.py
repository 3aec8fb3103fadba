"""The port's feed partition against the reference's.

engine/partition.py ``partition_feed`` prepares the bucket-sharded flat
tables from a RAW store feed, materializing only the rows of the shards
a process owns (plus the replicated membership subgraph).  Fed the same
columns (made from a seed), the port must give the reference package's
``partition_feed`` array for array — the owned-subset form
(``ShardSlices``) through ``to_full`` — and an equal FlatMeta, in both
serve modes (``partitioned``: every O(E) table split; ``routed``: only the
primary / fold point / T tables split, FlatMeta.part_serve), with and
without the device plan (the fold and the ancestor closures), on the
worlds of the reference's tests/test_feed_partition.py and
tests/test_fold_partition.py (caveats with contexts, expirations,
wildcards, userset chains, closure overflow, the T join, the fold and
the rc index) at smaller sizes.  Every output is an int: exact equality.
"""

import numpy as np
import pytest

import test_torch_engine as TE
from test_fold_partition import (
    RC_SCHEMA, ROUTED_SCHEMA, _folder_world, _routed_world,
)
from test_prepare_parity import NOW, SCHEMA, _random_world

from gochugaru_tpu.engine.partition import (
    ShardSlices as JSlices, partition_feed as j_feed,
)
from gochugaru_tpu.engine.plan import EngineConfig as JConfig, build_plan as j_plan
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.store.interner import Interner as JInterner
from gochugaru_tpu.store.snapshot import relationships_to_raw_columns as j_raw

from gochugaru_tpu_torch.engine import device as pdevice
from gochugaru_tpu_torch.engine import flat as PF, packed as PK
from gochugaru_tpu_torch.engine.partition import (
    ShardSlices, partition_feed, snapshot_raw_columns,
)
from gochugaru_tpu_torch.engine.plan import EngineConfig, build_plan
from gochugaru_tpu_torch.schema import compile_schema, parse_schema
from gochugaru_tpu_torch.store.interner import Interner
from gochugaru_tpu_torch.store.snapshot import (
    build_snapshot, relationships_to_raw_columns,
)

WORLDS = {
    # caveats with contexts, expirations, wildcards, userset chains, the
    # T join (tests/test_feed_partition.py's world)
    "random": (SCHEMA, lambda: _random_world(7, 3_000), {}),
    # a small closure cap: overflow sources, and the fold declines
    "overflow": (SCHEMA, lambda: _random_world(3, 3_000),
                 {"closure_source_cap": 12}),
    # the fold (read/admin), caveated leaves, an intersection
    "routed": (ROUTED_SCHEMA, lambda: _routed_world(n_repos=150), {}),
    # a recursive hierarchy past the unroll budget: the rc index
    "rc": (RC_SCHEMA, lambda: _folder_world(depth=14, chains=12),
           {"flat_fold": False}),
}


class Feed:
    """One world's raw feed in both packages."""

    def __init__(self, name):
        schema, rels_of, self.cfg = WORLDS[name]
        rels = rels_of()
        self.j_cs = j_compile(j_parse(schema))
        self.p_cs = compile_schema(parse_schema(schema))
        self.j_itn, self.p_itn = JInterner(), Interner()
        self.j_raw, self.j_ctx = j_raw(self.j_cs, self.j_itn, rels)
        self.p_raw, self.p_ctx = relationships_to_raw_columns(
            self.p_cs, self.p_itn, [TE._port_rel(r) for r in rels])
        for k, v in self.j_raw.items():
            assert np.array_equal(v, self.p_raw[k]), k

    def j(self, M, plan=True, **kw):
        return j_feed(
            1, self.j_cs, self.j_itn, {k: v.copy() for k, v in self.j_raw.items()},
            JConfig.for_schema(self.j_cs, **self.cfg), M, contexts=self.j_ctx,
            epoch_us=NOW, plan=j_plan(self.j_cs) if plan else None, **kw)

    def p(self, M, plan=True, **kw):
        return partition_feed(
            1, self.p_cs, self.p_itn, {k: v.copy() for k, v in self.p_raw.items()},
            EngineConfig.for_schema(self.p_cs, **self.cfg), M, contexts=self.p_ctx,
            epoch_us=NOW, plan=build_plan(self.p_cs) if plan else None, **kw)


def _full(v):
    return v.to_full() if isinstance(v, (ShardSlices, JSlices)) else v


def _assert_same(pp, jp):
    assert set(pp.arrays) == set(jp.arrays), set(pp.arrays) ^ set(jp.arrays)
    for k, v in jp.arrays.items():
        a, b = _full(pp.arrays[k]), _full(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), f"table {k} differs"
        assert isinstance(pp.arrays[k], ShardSlices) == isinstance(v, JSlices), k
    assert pdevice._meta_from(jp.meta) == pp.meta, "FlatMeta differs"
    assert pp.owned == jp.owned and pp.M == jp.M
    for c in ("e_rel", "e_res", "e_subj", "us_rel", "us_res", "ar_rel",
              "ar_child", "ms_subj", "mp_subj"):
        assert np.array_equal(getattr(pp.snapshot, c), getattr(jp.snapshot, c)), c


CASES = [(w, serve, plan, M)
         for w in WORLDS for serve in ("partitioned", "routed")
         for plan in (False, True) for M in ((2,) if plan else (4,))]


@pytest.mark.parametrize("name,serve,plan,M", CASES,
                         ids=[f"{w}-{s}-{'plan' if p else 'noplan'}-M{m}"
                              for w, s, p, m in CASES])
def test_feed_partition_matches_reference(name, serve, plan, M):
    """Every table (ShardSlices assembled with ``to_full``), every
    FlatMeta field, and the bucket-filtered snapshot's views."""
    f = Feed(name)
    jp = f.j(M, plan=plan, serve=serve)
    pp = f.p(M, plan=plan, serve=serve)
    _assert_same(pp, jp)
    assert pp.meta.part_serve == (serve == "routed")
    assert not pp.meta.has_rev  # the feed declines the reverse index
    if plan and name == "routed":
        assert pp.meta.fold_pairs and pp.fold_state is not None
        assert pp.fold_state.maps is not None  # armed for the delta chain
    if name == "rc" and plan:
        assert pp.meta.rc_slots
    if name == "overflow":
        assert pp.meta.has_ovf


@pytest.mark.parametrize("serve", ["partitioned", "routed"])
def test_owned_subset_slices(serve):
    """``owned=(1, 3)`` of four shards: the split tables hold exactly
    those blocks (the reference's, and the full feed's matching slices),
    the small tables are whole, FlatMeta is the full feed's (the geometry
    is global), and the bucket-filtered snapshot keeps only owned primary
    rows and the membership subgraph whole."""
    f = Feed("routed")
    owned = (1, 3)
    jp = f.j(4, owned=owned, serve=serve)
    pp = f.p(4, owned=owned, serve=serve)
    full = f.p(4, serve=serve)
    assert pp.meta == full.meta and pdevice._meta_from(jp.meta) == pp.meta
    assert pp.owned == owned
    n_split = 0
    for k, v in pp.arrays.items():
        ref = full.arrays[k]
        if not isinstance(v, ShardSlices):
            assert np.array_equal(v, ref) and np.array_equal(v, jp.arrays[k]), k
            continue
        n_split += 1
        assert sorted(v.blocks) == list(owned), k
        for s in owned:
            want = _full(ref)[s * v.per:(s + 1) * v.per]
            assert np.array_equal(v.blocks[s], want), (k, s)
            assert np.array_equal(v.blocks[s], jp.arrays[k].blocks[s]), (k, s)
    if serve == "routed":
        assert {k for k, v in pp.arrays.items()
                if isinstance(v, ShardSlices)} <= PF.PART_SHARDED_KEYS
    assert n_split >= 2
    assert 0 < pp.snapshot.e_rel.shape[0] < full.snapshot.e_rel.shape[0]
    assert np.array_equal(pp.snapshot.ms_subj, full.snapshot.ms_subj)
    assert pp.snapshot.partition_owned == owned


def test_shard_slices_helpers():
    """``block_for`` answers a slice index with the owned block (and cuts
    its columns when asked); ``map_blocks`` transforms every block and
    keeps the geometry; ``to_full`` reassembles."""
    rng = np.random.default_rng(3)
    full = rng.integers(-1, 100, (16, 3)).astype(np.int32)
    ss = ShardSlices(full.shape, np.dtype(np.int32), 4,
                     {s: full[4 * s:4 * s + 4].copy() for s in range(4)})
    assert np.array_equal(ss.to_full(), full)
    assert np.array_equal(ss.block_for((slice(8, 12),)), full[8:12])
    assert np.array_equal(ss.block_for((slice(4, 8), slice(1, 3))), full[4:8, 1:3])
    m = ss.map_blocks(lambda b: (b[:, :2] + 1).astype(np.uint16), 2, np.uint16)
    assert m.shape == (16, 2) and m.dtype == np.uint16 and m.per == 4
    assert np.array_equal(m.to_full(), (full[:, :2] + 1).astype(np.uint16))
    assert m.nbytes == 16 * 2 * 2
    owned = ShardSlices(full.shape, np.dtype(np.int32), 4,
                        {1: full[4:8], 3: full[12:16]})
    assert owned.nbytes == 8 * 3 * 4


def test_pack_error_on_owned_slices_raises(monkeypatch):
    """A table that fails its pack on owned slices raises: each process
    checks only its own blocks, and a local despec would make FlatMeta
    differ between the processes of a mesh.  Whole tables despec
    quietly, as before."""
    f = Feed("routed")

    def refuse(b, spec):
        raise PK.PackError("refused")

    monkeypatch.setattr(PK, "pack_rows", refuse)
    with pytest.raises(PK.PackError):
        f.p(4, owned=(0, 2))
    from gochugaru_tpu_torch.engine.flat import build_flat_arrays_sharded

    snap = build_snapshot(1, f.p_cs, Interner(),
                          [TE._port_rel(r) for r in _routed_world(n_repos=40)],
                          epoch_us=NOW)
    _a, meta, _f, _c = build_flat_arrays_sharded(
        snap, EngineConfig.for_schema(f.p_cs), 2, plan=build_plan(f.p_cs))
    assert not meta.packed


def test_snapshot_raw_columns_round_trip():
    """``snapshot_raw_columns`` hands the feed a resident snapshot's raw
    columns (srel re-encoded, -1 = direct): the feed of a snapshot equals
    the feed of the relationships it was built from."""
    f = Feed("routed")
    snap = build_snapshot(1, f.p_cs, f.p_itn,
                          [TE._port_rel(r) for r in _routed_world(n_repos=150)],
                          epoch_us=NOW)
    raw = snapshot_raw_columns(snap, copy=True)
    assert (raw["srel"] >= -1).all() and raw["res"].shape[0] == snap.num_edges
    a = partition_feed(1, f.p_cs, snap.interner, raw,
                       EngineConfig.for_schema(f.p_cs), 2,
                       contexts=snap.contexts, epoch_us=NOW,
                       plan=build_plan(f.p_cs))
    b = f.p(2)
    assert a.meta == b.meta
    for k, v in b.arrays.items():
        assert np.array_equal(_full(a.arrays[k]), _full(v)), k
