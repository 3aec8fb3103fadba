"""The port's caveated Check against the reference: the CEL tri-state VM,
the gate's caveat planes, the engine's planes and the client.

- **VM parity.**  ``caveats/device.py`` in both packages builds the same
  plan (slots, bounds, host-only set, string pool) and encodes the same
  context tables; the port's ``make_tri_fn`` (torch) gives the
  reference's (jnp) tri-states on the same tables, over every caveat
  shape of ``tests/test_device_caveats.py`` plus division, ternaries,
  negation and time selects, fuzzed from numpy seeds.
- **Plain gate parity.**  ``fused_probe_plain`` / ``fused_probe_aligned_plain``
  mode ``gate`` with the caveat and context lanes against the reference's
  XLA chain (probe, decode, hit, ``where``), packed and int32, with and
  without the context lane.
- **Engine parity.**  The port's (definite, possible, overflow) planes
  against ``DeviceEngine(pallas=False)``'s flat program on caveated
  worlds under both table layouts, over the reference's arrays and over
  the port's own prepare.
- **Client.**  The port's client against the reference's on the same
  writes, a schema whose caveat no relationship uses included.

Every output is an int or a bool: the tolerance is exact equality.
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_engine as TE
import test_device_caveats as TDC
import gochugaru_tpu.client as jclient
from gochugaru_tpu import consistency as jcons, rel as jrel
from gochugaru_tpu.caveats import cel as jcel, device as jcd
from gochugaru_tpu.engine import hash as JH
from gochugaru_tpu.engine import packed as JPK
from gochugaru_tpu.engine.oracle import T
from gochugaru_tpu.schema import compile_schema as j_compile, parse_schema as j_parse
from gochugaru_tpu.utils.context import background as j_background

from gochugaru_tpu_torch import consistency as pcons, rel as prel
from gochugaru_tpu_torch.caveats import cel as pcel, device as pcd
from gochugaru_tpu_torch.client import new_evaluator, with_engine_config
from gochugaru_tpu_torch.engine import kernels as K
from gochugaru_tpu_torch.engine.device import DeviceEngine, to_device_tensor
from gochugaru_tpu_torch.engine.oracle import SnapshotOracle
from gochugaru_tpu_torch.engine.plan import EngineConfig
from gochugaru_tpu_torch.schema import compile_schema as p_compile, parse_schema as p_parse
from gochugaru_tpu_torch.utils.context import background

NOW = TE.NOW

EXTRA_SCHEMA = """
caveat divmod(a int, b int) { a / b == -2 || a % b * 2 > b }
caveat pick(flag bool, x int, y double) { (flag ? x : -x) > 3 && !(y < -1.5) }
caveat boolcmp(p bool, q bool) { p == q || p != !q }
caveat strin(s string, t string) { s == t || s in ['x', t] }
caveat negd(y double, z double) { -y <= z && z in [0.25, 3] }
caveat tsel(flag bool, at timestamp, d duration) {
  (flag ? at + d : at - d) > timestamp("2023-11-14T00:00:00Z")
    || -d == duration("-1h")
}
definition user {}
definition doc {
    relation viewer: user with divmod | user with pick | user with boolcmp | user with strin | user with negd | user with tsel
    permission view = viewer
}
"""

RANDOM_SCHEMA = """
caveat lim(v int, cap int) { v < cap }
caveat tag_ok(tag string) { tag in ['a', 'b', 'c'] }
definition user {}
definition group { relation member: user | group#member | user with lim }
definition res {
    relation parent: group
    relation writer: user | user with tag_ok | group#member
    relation banned: user
    permission write = (writer - banned) + parent->member
}
"""

#: every caveat schema of tests/test_device_caveats.py, and more shapes
SCHEMAS = {
    "basic": TDC.SCHEMA_BASIC,
    "arith": TDC.SCHEMA_ARITH,
    "host_only": TDC.SCHEMA_HOSTONLY,
    "double": TDC.SCHEMA_DOUBLE,
    "groups": TDC.SCHEMA_GROUPS,
    "f32": TDC.SCHEMA_F32,
    "mod": TDC.SCHEMA_MOD,
    "time": TDC.SCHEMA_TIME,
    "random": RANDOM_SCHEMA,
    "extra": EXTRA_SCHEMA,
}

STRINGS = ("10.0.0.1", "10.0.0.2", "1.2.3.4", "tuesday", "a", "b", "c", "x",
           "alice", "zz")


# ---------------------------------------------------------------------------
# random contexts (numpy seeds), materialized per package
# ---------------------------------------------------------------------------


def _value(rng, ptype):
    """One context value for a parameter of ``ptype``: well-typed most of
    the time, else missing (None), out of bound, not f32-exact or of
    the wrong type.  Times are ("ts"/"dur", µs) markers that
    ``_materialize`` turns into each package's own classes."""
    base = ptype.split("<", 1)[0].strip()
    r = rng.random()
    if r < 0.08:
        return None
    if r < 0.14:
        return ("junk", 2.5, True, 7, "10.0.0.1")[int(rng.integers(0, 5))]
    if base in ("int", "uint"):
        m = rng.random()
        if m < 0.75:
            return int(rng.integers(-12, 13))
        if m < 0.9:
            return int(rng.integers(-2**20, 2**20))
        return int(rng.integers(2**24, 2**40)) * int(rng.choice([-1, 1]))
    if base == "double":
        return float(rng.choice([0.25, 0.5, 0.75, -1.5, 3.0, -2.0, 0.1, 1e8,
                                 100000001.0, 5.0]))
    if base == "bool":
        return bool(rng.random() < 0.5)
    if base == "string":
        return str(rng.choice(STRINGS))
    if base == "timestamp":
        us = NOW + int(rng.integers(-10**13, 10**13))
        style = rng.random()
        if style < 0.4:
            return ("ts", us)
        if style < 0.7:
            return dt.datetime.fromtimestamp(us / 1e6, dt.timezone.utc).isoformat()
        return us / 1e6
    if base == "duration":
        us = int(rng.integers(-10**10, 10**10))
        style = rng.random()
        if style < 0.4:
            return ("dur", us)
        if style < 0.7:
            return f"{us}us" if us >= 0 else f"-{-us}us"
        return us / 1e6
    return {"owner": str(rng.choice(["alice", "bob"]))}


def _clean_value(rng, ptype):
    """A well-typed value inside every caveat's device bounds."""
    base = ptype.split("<", 1)[0].strip()
    if base in ("int", "uint"):
        return int(rng.integers(-12, 13))
    if base == "double":
        return float(rng.choice([0.25, 0.5, -1.5, 3.0, -2.0]))
    if base == "bool":
        return bool(rng.random() < 0.5)
    if base == "string":
        return str(rng.choice(STRINGS))
    if base == "timestamp":
        return ("ts", NOW + int(rng.integers(-10**13, 10**13)))
    return ("dur", int(rng.integers(-10**10, 10**10)))


def _context(rng, params, p_keep):
    out = {}
    for pname in sorted(params):
        if rng.random() < p_keep:
            v = _value(rng, params[pname])
            if v is not None:
                out[pname] = v
    return out


def _materialize(ctx, cel):
    """A context with its time markers as ``cel``'s Timestamp/Duration."""
    out = {}
    for k, v in ctx.items():
        if isinstance(v, tuple) and v[0] == "ts":
            v = cel.Timestamp(v[1])
        elif isinstance(v, tuple) and v[0] == "dur":
            v = cel.Duration(v[1])
        out[k] = v
    return out


def _all_params(cs):
    params = {}
    for decl in cs.schema.caveats.values():
        params.update(decl.params)
    return params


def _plans(schema):
    j_cs = j_compile(j_parse(schema))
    p_cs = p_compile(p_parse(schema))
    return j_cs, jcd.build_caveat_plan(j_cs), p_cs, pcd.build_caveat_plan(p_cs)


# ---------------------------------------------------------------------------
# VM parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_caveat_plan_matches_reference(name):
    """Slots, types, bounds, host-only set and string pool (its ids and
    their order) are the reference's."""
    _j_cs, jp, _p_cs, pp = _plans(SCHEMAS[name])
    for f in ("num_params", "num_caveats", "slot_of", "slot_type",
              "slots_of_param", "base_strings", "caveat_params", "name_of_id"):
        assert getattr(pp, f) == getattr(jp, f), f
    assert list(pp.base_strings) == list(jp.base_strings)
    for f in ("host_only", "int_bound", "time_bound"):
        assert np.array_equal(getattr(pp, f), getattr(jp, f)), f
    assert sorted(pp.programs) == sorted(jp.programs)
    assert bool(pp.programs) == (name != "host_only")


def _encode_both(jp, pp, rows, strings_j, strings_p, query):
    kw = {"extra_strings": {}} if query else {}
    jt = jcd.encode_contexts(jp, [_materialize(r, jcel) for r in rows],
                             strings_j, **dict(kw))
    pt = pcd.encode_contexts(pp, [_materialize(r, pcel) for r in rows],
                             strings_p, **dict(kw))
    for f in ("vi", "vf", "present", "host"):
        a, b = getattr(jt, f), getattr(pt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return jt


def _tables(et, qt):
    return {"ectx_vi": et.vi, "ectx_vf": et.vf, "ectx_pr": et.present,
            "ectx_host": et.host, "qctx_vi": qt.vi, "qctx_vf": qt.vf,
            "qctx_pr": qt.present, "qctx_host": qt.host}


def _tri_both(jp, pp, tables, cav, e, q):
    """(reference tri, port tri) on the same numpy tables and indices."""
    ref = np.asarray(jcd.make_tri_fn(jp)(
        jnp.asarray(cav), jnp.asarray(e), jnp.asarray(q),
        {k: jnp.asarray(v) for k, v in tables.items()}))
    got = pcd.make_tri_fn(pp)(
        torch.from_numpy(cav), torch.from_numpy(e), torch.from_numpy(q),
        {k: torch.from_numpy(v) for k, v in tables.items()})
    assert got.dtype == torch.int32 and tuple(got.shape) == cav.shape
    return ref, got.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_tri_vm_matches_reference(name, seed):
    """Stored and query contexts drawn from a numpy seed, encoded by both
    packages (identical tables and pools), then every (caveat, stored
    row, query row) draw — missing rows (-1) included — gives the
    reference's tri-state, tolerance 0."""
    j_cs, jp, _p_cs, pp = _plans(SCHEMAS[name])
    rng = np.random.default_rng(1000 * seed + len(name))
    params = _all_params(j_cs)
    stored = [_context(rng, params, 0.4) for _ in range(24)]
    queries = [_context(rng, params, 0.7) for _ in range(24)]
    sj, sp = dict(jp.base_strings), dict(pp.base_strings)
    et = _encode_both(jp, pp, stored, sj, sp, query=False)
    assert sj == sp and list(sj) == list(sp)
    qt = _encode_both(jp, pp, queries, sj, sp, query=True)
    assert sj == sp
    n = 4096
    cav = rng.integers(0, jp.num_caveats + 1, n).astype(np.int32).reshape(-1, 4)
    e = rng.integers(-1, len(stored), n).astype(np.int32).reshape(-1, 4)
    q = rng.integers(-1, len(queries), n).astype(np.int32).reshape(-1, 4)
    ref, got = _tri_both(jp, pp, _tables(et, qt), cav, e, q)
    assert np.array_equal(ref, got)
    if name != "host_only":
        # the fuzz reaches definite answers, not only UNKNOWN
        assert (got == 0).any() and (got == 2).any(), name


@pytest.mark.parametrize("name", ["time", "extra", "mod", "arith"])
def test_tri_vm_on_clean_contexts_is_definite(name):
    """A full, well-typed context of small values evaluates on the device
    (no gratuitous UNKNOWN), and equals the host CEL program's answer."""
    j_cs, jp, _p_cs, pp = _plans(SCHEMAS[name])
    rng = np.random.default_rng(7)
    rows, cids, progs = [], [], []
    for cname in sorted(j_cs.caveat_ids):
        decl = j_cs.schema.caveats[cname]
        prog = pcel.compile_cel(cname, decl.params, decl.expression)
        for _ in range(40):
            ctx = {p: _clean_value(rng, t) for p, t in decl.params.items()}
            rows.append(ctx)
            cids.append(j_cs.caveat_ids[cname])
            progs.append(prog)
    sj, sp = dict(jp.base_strings), dict(pp.base_strings)
    et = _encode_both(jp, pp, rows, sj, sp, query=False)
    qt = _encode_both(jp, pp, [], sj, sp, query=True)
    cav = np.asarray(cids, np.int32)
    e = np.arange(len(rows), dtype=np.int32)
    q = np.full(len(rows), -1, np.int32)
    ref, got = _tri_both(jp, pp, _tables(et, qt), cav, e, q)
    assert np.array_equal(ref, got)
    for k, (prog, ctx) in enumerate(zip(progs, rows)):
        try:
            host = prog.evaluate(_materialize(ctx, pcel))
        except pcel.CelCompileError:  # divide by zero: UNKNOWN on device
            assert got[k] == 1, (prog.name, ctx)
            continue
        assert got[k] == (2 if host else 0), (prog.name, ctx, got[k])


def test_tri_vm_stored_context_wins_and_caveat_zero_is_true():
    """Stored values override query values per parameter; caveat 0 is
    TRUE whatever the contexts; a host-only caveat is UNKNOWN."""
    j_cs, jp, _p_cs, pp = _plans(TDC.SCHEMA_BASIC + """
caveat complex_one(m map<string>) { m.owner == 'alice' }
""")
    sj, sp = dict(jp.base_strings), dict(pp.base_strings)
    et = _encode_both(jp, pp, [{"minimum": 3}, {"tier": 1, "minimum": 3}], sj, sp,
                      query=False)
    qt = _encode_both(jp, pp, [{"tier": 5}, {"tier": 1}], sj, sp, query=True)
    tier = j_cs.caveat_ids["tier_at_least"]
    host = j_cs.caveat_ids["complex_one"]
    cav = np.array([tier, tier, tier, 0, host], np.int32)
    e = np.array([0, 0, 1, -1, -1], np.int32)
    q = np.array([0, 1, 0, -1, 0], np.int32)
    ref, got = _tri_both(jp, pp, _tables(et, qt), cav, e, q)
    assert np.array_equal(ref, got)
    assert got.tolist() == [2, 0, 0, 2, 1]


def test_tri_vm_ops_keep_int32_and_f32():
    """The VM's constants are tensors of an explicit dtype: an int
    subtree promoted into a double compare stays f32, the limb shift
    stays arithmetic, truncating / and % match the host on negatives."""
    cs = p_compile(p_parse("""
caveat dm(a int, b int) { a / b == -3 && a % b == -1 }
caveat lt(a int, y double) { a < y }
definition user {}
definition doc { relation viewer: user with dm | user with lt
 permission view = viewer }
"""))
    plan = pcd.build_caveat_plan(cs)
    fn_dm = plan.programs[cs.caveat_ids["dm"]]
    fn_lt = plan.programs[cs.caveat_ids["lt"]]
    slot = plan.slot_of
    vi = torch.zeros((4, plan.num_params), dtype=torch.int32)
    vf = torch.zeros((4, plan.num_params), dtype=torch.float32)
    pr = torch.ones((4, plan.num_params), dtype=torch.bool)
    for i, (a, b) in enumerate([(-10, 3), (10, -3), (-10, -3), (7, 0)]):
        vi[i, slot[("dm", "a")]] = a
        vi[i, slot[("dm", "b")]] = b
    out = fn_dm(vi, vf, pr)
    assert out.dtype == torch.int32
    # -10 / 3 = -3 rem -1 (truncated); 10 / -3 = -3 rem 1; -10/-3 = 3; b = 0
    assert out.tolist() == [2, 0, 0, 1]
    vi[:, slot[("lt", "a")]] = torch.tensor([1, 2, 3, -4], dtype=torch.int32)
    vf[:, slot[("lt", "y")]] = torch.tensor([1.5, 2.0, 2.5, -3.5])
    assert fn_lt(vi, vf, pr).tolist() == [2, 0, 0, 2]
    lo = torch.tensor([-1, (1 << 30) + 5, -(1 << 30) - 1], dtype=torch.int32)
    hi, lo2 = pcd._time_norm(torch.zeros(3, dtype=torch.int32), lo)
    assert hi.tolist() == [-1, 1, -2] and lo2.tolist() == [(1 << 30) - 1, 5, (1 << 30) - 1]


# ---------------------------------------------------------------------------
# plain gate with the caveat planes vs the reference's XLA chain
# ---------------------------------------------------------------------------


def _cav_table(seed, packed, codec):
    """A two-key table with caveat, context and expiry columns, under one
    of the codecs a context column gets: ``range`` (the table build's, with
    the -1 sentinel at base -1), ``dict`` (caveat ids a dictionary) or
    ``delta`` (context as a delta of the caveat column)."""
    rng = np.random.default_rng(seed)
    n = 700
    k1 = rng.integers(0, 70, n).astype(np.int32)
    k2 = rng.integers(0, 40, n).astype(np.int32)
    cav = np.where(rng.random(n) < 0.4, 0, rng.integers(1, 4, n)).astype(np.int32)
    ctx = np.where(rng.random(n) < 0.3, -1, rng.integers(0, 500, n)).astype(np.int32)
    if codec == "delta":
        ctx = (cav + rng.integers(-1, 9, n)).astype(np.int32)
    exp = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 1000, n)).astype(np.int32)
    cols = [k1, k2, cav, ctx, exp]
    descs = [JPK.col_range(-1, 70), JPK.col_range(-1, 40),
             JPK.col_dict((-1, 0, 1, 2, 3)) if codec == "dict" else JPK.col_range(-1, 3),
             JPK.col_delta(-1, 8, 2) if codec == "delta" else JPK.col_range(-1, 499),
             JPK.col_range(-1, 1000)]
    spec = JPK.make_spec(descs) if packed else None
    q1 = rng.integers(-2, 72, (9, 5)).astype(np.int32)
    q2 = rng.integers(0, 41, (9, 5)).astype(np.int32)
    return cols, spec, (q1, q2)


def _ref_gate_planes(blk, qs, lanes, now):
    """The reference's gate triple from a decoded block (pallas.py's
    gate tail, written as numpy over the XLA chain's block)."""
    hit = np.ones(blk.shape[:-1], bool)
    for j, q in enumerate(qs):
        hit &= (blk[..., j] == q[..., None]) & (q >= 0)[..., None]
    exp = np.where(hit, blk[..., lanes["exp"]], 0)
    live = hit & ((exp == 0) | (exp > now))
    return [hit, live, np.where(hit, blk[..., lanes["cav"]], 0),
            np.where(hit, blk[..., lanes["ctx"]], -1)]


LANES = {"cav": 2, "ctx": 3, "exp": 4}


@pytest.mark.parametrize("needctx", [True, False], ids=["ctx", "cav_only"])
@pytest.mark.parametrize("codec", ["range", "dict", "delta"])
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_plain_gate_planes_match_reference_chain(packed, codec, needctx):
    cols, spec, qs = _cav_table(3 + len(codec), packed, codec)
    hi = JH.build_hash(cols[:2], target_cap=4)
    raw = JH.interleave_buckets(hi, cols)
    qj = tuple(jnp.asarray(q) for q in qs)
    if spec is None:
        blk = np.asarray(JH.probe_block(jnp.asarray(hi.off), jnp.asarray(raw), hi.cap, qj))
        tbl, off, off_a, shift = raw, hi.off, None, None
    else:
        tbl = JPK.pack_rows(raw, spec)
        off, off_a = JPK.pack_off(hi.off)
        shift = JPK.OFF_ANCHOR_SHIFT
        hh = (JH.mix32(list(qj), jnp) & jnp.uint32(hi.size - 1)).astype(jnp.int32)
        start = (JH.take_in_bounds(jnp.asarray(off_a), hh >> shift)
                 + JH.take_in_bounds(jnp.asarray(off), hh).astype(jnp.int32))
        blk = np.asarray(JPK.decode_block(
            JH.slice_blocks(jnp.asarray(tbl), start, hi.cap), spec))
    want = _ref_gate_planes(blk, qs, LANES, 500)[: 4 if needctx else 3]
    got = K.fused_probe(
        tuple(torch.from_numpy(q) for q in qs), to_device_tensor(off, "cpu"),
        to_device_tensor(tbl, "cpu"), cap=hi.cap, spec=spec,
        off_a=None if off_a is None else to_device_tensor(off_a, "cpu"),
        ashift=shift, mode="gate", now=500, exp_lane=LANES["exp"],
        cav_lane=LANES["cav"], ctx_lane=LANES["ctx"] if needctx else None)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == (torch.bool if k < 2 else torch.int32)
        assert np.array_equal(a.numpy(), b), k
    hit = want[0]
    assert hit.any() and (want[2][hit] != 0).any() and (want[2][~hit] == 0).all()
    if needctx:
        assert (want[3][hit] == -1).any() or codec == "delta"
        assert (want[3][~hit] == -1).all()


@pytest.mark.parametrize("needctx", [True, False], ids=["ctx", "cav_only"])
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_plain_aligned_gate_planes_match_reference_chain(packed, needctx):
    cols, spec, qs = _cav_table(11, packed, "range")
    ai = JH.build_aligned(cols[:2], cols, cover=(0.5, 0.9))
    assert ai is not None and len(ai.levels) >= 3
    levels = [t for t, _ in ai.levels]
    if spec is not None:
        levels = [JPK.pack_rows(t.reshape(-1, ai.w), spec).reshape(t.shape[0], -1)
                  for t in levels]
    sw = ai.w if spec is None else spec[1]
    # queries drawn from the stored keys, so hits land past level 0 too
    rng = np.random.default_rng(5)
    qi = rng.integers(0, cols[0].shape[0], 300)
    qs = (np.where(rng.random(300) < 0.05, -1, cols[0][qi]).astype(np.int32),
          cols[1][qi].astype(np.int32))
    blk = JH.probe_aligned([jnp.asarray(x) for x in levels], ai.caps, sw,
                           tuple(jnp.asarray(q) for q in qs))
    blk = np.asarray(blk if spec is None else JPK.decode_block(blk, spec))
    want = _ref_gate_planes(blk, qs, LANES, 500)[: 4 if needctx else 3]
    got = K.fused_probe_aligned(
        tuple(torch.from_numpy(q) for q in qs),
        [to_device_tensor(x, "cpu") for x in levels], ai.caps, sw, spec=spec,
        mode="gate", now=500, exp_lane=LANES["exp"], cav_lane=LANES["cav"],
        ctx_lane=LANES["ctx"] if needctx else None)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    assert want[0][:, ai.caps[0]:].any()


def test_gate_planes_refuse_bad_lanes():
    cols, spec, qs = _cav_table(1, False, "range")
    hi = JH.build_hash(cols[:2], target_cap=4)
    raw = JH.interleave_buckets(hi, cols)
    args = (tuple(torch.from_numpy(q) for q in qs), torch.from_numpy(hi.off),
            torch.from_numpy(raw))
    with pytest.raises(ValueError):
        K.fused_probe(*args, cap=hi.cap, mode="gate", ctx_lane=3)
    with pytest.raises(ValueError):
        K.fused_probe(*args, cap=hi.cap, mode="any", cav_lane=2)


# ---------------------------------------------------------------------------
# engine parity on caveated worlds
# ---------------------------------------------------------------------------


def _doc_world_rels(cs, seed):
    """Random doc#viewer edges of a ``definition doc`` schema: uncaveated,
    and caveated with each declared caveat and a partial stored context
    (some expiring); checks ``doc#view`` with random request contexts."""
    rng = np.random.default_rng(seed)
    names = sorted(cs.schema.caveats)
    params = _all_params(cs)
    rels, checks = [], []
    for d in range(14):
        for u in rng.choice(6, 3, replace=False):
            r = jrel.must_from_triple(f"doc:d{d}", "viewer", f"user:u{u}")
            if rng.random() < 0.8:
                name = names[int(rng.integers(0, len(names)))]
                decl = cs.schema.caveats[name]
                r = r.with_caveat(name, _materialize(
                    _context(rng, decl.params, 0.5), jcel))
            if rng.random() < 0.15:
                r = jrel.Relationship(**{**r.__dict__, "expiration": dt.datetime.fromtimestamp(
                    (NOW + int(rng.integers(-10**9, 10**12))) / 1e6, tz=dt.timezone.utc)})
            rels.append(r)
    for _ in range(96):
        q = jrel.must_from_triple(f"doc:d{int(rng.integers(0, 15))}", "view",
                                  f"user:u{int(rng.integers(0, 6))}")
        if rng.random() < 0.8:
            q = q.with_caveat("", _materialize(_context(rng, params, 0.7), jcel))
        checks.append(q)
    return rels, checks


def _random_schema_world(seed=42):
    """tests/test_device_caveats.py's randomized world, drawn from numpy:
    caveated membership (closure) and caveated direct grants."""
    rng = np.random.default_rng(seed)
    users = [f"user:u{i}" for i in range(12)]
    groups = [f"group:g{i}" for i in range(4)]
    ress = [f"res:r{i}" for i in range(8)]
    rels = []
    for g in groups:
        for u in rng.choice(users, 4, replace=False):
            r = jrel.must_from_tuple(f"{g}#member", str(u))
            if rng.random() < 0.4:
                r = r.with_caveat("lim", {"cap": int(rng.integers(1, 11))}
                                  if rng.random() < 0.7 else {})
            rels.append(r)
    for g in groups[1:]:
        rels.append(jrel.must_from_tuple(f"{g}#member", f"{groups[0]}#member"))
    for rs in ress:
        rels.append(jrel.must_from_tuple(f"{rs}#parent", str(rng.choice(groups))))
        for u in rng.choice(users, 3, replace=False):
            r = jrel.must_from_tuple(f"{rs}#writer", str(u))
            if rng.random() < 0.5:
                r = r.with_caveat("tag_ok", {"tag": str(rng.choice(["a", "x"]))}
                                  if rng.random() < 0.5 else {})
            rels.append(r)
        if rng.random() < 0.5:
            rels.append(jrel.must_from_tuple(f"{rs}#banned", str(rng.choice(users))))
    checks = []
    for _ in range(64):
        q = jrel.must_from_triple(str(rng.choice(ress)), "write", str(rng.choice(users)))
        ctx = {}
        if rng.random() < 0.6:
            ctx["v"] = int(rng.integers(0, 11))
        if rng.random() < 0.6:
            ctx["tag"] = str(rng.choice(["a", "b", "x"]))
        checks.append(q.with_caveat("", ctx) if ctx else q)
    return rels, checks


def _port_rel(r):
    """The reference Relationship as the port's, its context's times as
    the port's Timestamp/Duration."""
    kw = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    kw["caveat_context"] = {
        k: (pcel.Timestamp(v.us) if isinstance(v, jcel.Timestamp)
            else pcel.Duration(v.us) if isinstance(v, jcel.Duration) else v)
        for k, v in (r.caveat_context or {}).items()
    }
    return prel.Relationship(**kw)


def _world(name, **cfg):
    schema = SCHEMAS[name]
    if name == "groups":
        rels, checks = TDC._membership_caveat_world()
    elif name == "random":
        rels, checks = _random_schema_world()
    else:
        rels, checks = _doc_world_rels(j_compile(j_parse(schema)), len(name))
    w = TE.World(schema, rels=rels, checks=checks, **cfg)
    # rebuild the port's snapshot with the port's time classes
    from gochugaru_tpu_torch.store import snapshot as psnap
    from gochugaru_tpu_torch.store.interner import Interner as PInterner

    w.p_snap = psnap.build_snapshot(1, w.p_cs, PInterner(),
                                    [_port_rel(r) for r in rels], epoch_us=NOW)
    return w


def _ref_planes(w, je, jd):
    q, _u, qctx = je._lower_queries(w.j_snap, w.checks, jd.strings)
    B = len(w.checks)
    fn, args = je.flat_fn_and_args(jd, q, qctx, jnp.int32(w.j_snap.now_rel32(NOW)),
                                   B)
    return [np.asarray(x)[:B] for x in fn(*args)]


LAYOUTS = {"interleave": {}, "aligned": {"flat_aligned": True}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_engine_planes_match_reference(name, layout):
    """Planes over the reference's arrays (and string pool) and over the
    port's own prepare equal the reference's pallas=False planes; the
    port's prepare builds the reference's arrays, ``ectx_*`` included."""
    w = _world(name, **LAYOUTS[layout])
    je = w.j_engine()
    jd = je.prepare(w.j_snap)
    ref = _ref_planes(w, je, jd)
    pe = w.p_engine()
    assert pe.caveat_plan is not None
    assert np.array_equal(pe.caveat_plan.host_only, je.caveat_plan.host_only)
    np_arrays = {k: np.asarray(v) for k, v in jd.arrays.items()}
    arrays, meta = pe.prepare_host(w.p_snap)
    assert set(arrays) == set(np_arrays) and "ectx_vi" in arrays
    for k, v in np_arrays.items():
        assert arrays[k].dtype == v.dtype and np.array_equal(arrays[k], v), k
    assert meta.e_hascav == jd.flat_meta.e_hascav
    checks = [_port_rel(c) for c in w.checks]
    pd = pe.snapshot_from_reference(w.p_snap, np_arrays, jd.flat_meta, jd.strings)
    own = pe.prepare(w.p_snap)
    assert own.strings == jd.strings
    for pdx in (pd, own):
        got = pe.check_batch(pdx, checks, now_us=NOW)
        for nm, a, b in zip("dpo", ref, got):
            assert np.array_equal(a, b), nm
    assert ref[0].any() and (~ref[0]).any()


#: benchmarks/bench4_caveats.py's schema
CONFIG4_SCHEMA = """
caveat same_tenant(tenant string, edge_tenant string, tier int) {
    tenant == edge_tenant && tier >= 1
}
definition user {}
definition org { relation admin: user }
definition item {
    relation org: org
    relation holder: user with same_tenant
    permission access = holder + org->admin
}
"""


def _config4_columns(build, cs, interner, n_edges=12_000, n_users=600,
                     n_orgs=40, n_tenants=64, seed=31):
    """benchmarks/bench4_caveats.py's generator at a small scale (the
    same_tenant caveat on every holder edge, one stored context a
    tenant)."""
    rng = np.random.default_rng(seed)
    n_items = max(n_edges // 10, 100)
    users = np.array([interner.node("user", f"u{i}") for i in range(n_users)], np.int64)
    orgs = np.array([interner.node("org", f"o{i}") for i in range(n_orgs)], np.int64)
    items = np.array([interner.node("item", f"i{i}") for i in range(n_items)], np.int64)
    slot = cs.slot_of_name
    contexts = [{"edge_tenant": f"t{t}", "tier": 2} for t in range(n_tenants)]
    n_holder = n_edges - n_items - n_orgs
    res = np.concatenate([rng.choice(items, n_holder), items, orgs])
    rel = np.concatenate([np.full(n_holder, slot["holder"], np.int64),
                          np.full(n_items, slot["org"], np.int64),
                          np.full(n_orgs, slot["admin"], np.int64)])
    subj = np.concatenate([rng.choice(users, n_holder), rng.choice(orgs, n_items),
                           rng.choice(users, n_orgs)])
    caveat = np.concatenate([np.full(n_holder, cs.caveat_ids["same_tenant"], np.int32),
                             np.zeros(n_items + n_orgs, np.int32)])
    ctx = np.concatenate([rng.integers(0, n_tenants, n_holder).astype(np.int32),
                          np.full(n_items + n_orgs, -1, np.int32)])
    snap = build(1, cs, interner, res=res, rel=rel, subj=subj,
                 srel=np.full(res.shape[0], -1, np.int64), caveat=caveat,
                 ctx=ctx, contexts=contexts, epoch_us=NOW)
    return snap, users, items, n_tenants


def _config4_queries(snap, slot, users, items, n_tenants, B=2_000, seed=3):
    rng = np.random.default_rng(seed)
    holder = np.nonzero(snap.e_rel == slot["holder"])[0]
    hit = rng.choice(holder, B // 2)
    q_res = np.concatenate([snap.e_res[hit], rng.choice(items, B - B // 2)]).astype(np.int32)
    q_subj = np.concatenate([snap.e_subj[hit], rng.choice(users, B - B // 2)]).astype(np.int32)
    q_perm = np.full(B, slot["access"], np.int32)
    edge_tenant = snap.e_ctx[hit].astype(np.int64)
    match = rng.random(B // 2) < 0.5
    q_ctx = np.concatenate([np.where(match, edge_tenant, (edge_tenant + 1) % n_tenants),
                            rng.integers(0, n_tenants, B - B // 2)]).astype(np.int32)
    rows = [{"tenant": f"t{t}", "tier": 2} for t in range(n_tenants)]
    return q_res, q_perm, q_subj, q_ctx, rows


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_config4_shaped_world_matches_reference(layout):
    """A config-4-shaped world (columns, per-query request contexts
    through ``check_columns(q_ctx=, qctx_rows=)``): planes equal the
    reference's, no row is conditional, definite rows equal the host
    oracle's."""
    from gochugaru_tpu.store import snapshot as jsnap
    from gochugaru_tpu.store.interner import Interner as JInterner
    from gochugaru_tpu_torch.store import snapshot as psnap
    from gochugaru_tpu_torch.store.interner import Interner as PInterner

    j_cs, p_cs = j_compile(j_parse(CONFIG4_SCHEMA)), p_compile(p_parse(CONFIG4_SCHEMA))
    cfg = LAYOUTS[layout]
    j_snap, *_ = _config4_columns(jsnap.build_snapshot_from_columns, j_cs, JInterner())
    p_snap, users, items, n_t = _config4_columns(
        psnap.build_snapshot_from_columns, p_cs, PInterner())
    q_res, q_perm, q_subj, q_ctx, rows = _config4_queries(
        p_snap, p_cs.slot_of_name, users, items, n_t)
    je = TE.JEngine(j_cs, TE.JConfig(pallas=False, spmm=False, **cfg))
    jd = je.prepare(j_snap)
    q, qctx = je._columns_preamble(jd, q_res, q_perm, q_subj, None, None, q_ctx, rows)
    fn, args = je.flat_fn_and_args(jd, q, qctx, jnp.int32(j_snap.now_rel32(NOW)),
                                   q_res.shape[0])
    ref = [np.asarray(x)[: q_res.shape[0]] for x in fn(*args)]
    pe = DeviceEngine(p_cs, EngineConfig(**cfg), device="cpu")
    assert not pe.caveat_plan.host_only[p_cs.caveat_ids["same_tenant"]]
    pd = pe.prepare(p_snap)
    got = pe.check_columns(pd, q_res, q_perm, q_subj, q_ctx=q_ctx, qctx_rows=rows,
                           now_us=NOW)
    for nm, a, b in zip("dpo", ref, got):
        assert np.array_equal(a, b), nm
    d, p, ovf = got
    assert not (p & ~d).any() and not ovf.any()
    assert 0 < int(d.sum()) < q_res.shape[0]
    oracle = SnapshotOracle(p_snap, {"same_tenant": pcel.compile_cel(
        "same_tenant", p_cs.schema.caveats["same_tenant"].params,
        p_cs.schema.caveats["same_tenant"].expression)}, now_us=NOW)
    it = p_snap.interner
    for i in range(0, q_res.shape[0], 7):
        rt, rid = it.key_of(int(q_res[i]))
        _st, sid = it.key_of(int(q_subj[i]))
        want = oracle.check(rt, rid, "access", "user", sid, "",
                            context=rows[q_ctx[i]], now_us=NOW)
        assert bool(d[i]) == (want == T), i


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------

FAULT1_SCHEMA = """
caveat ip_ok(x int) { x > 3 }
definition user {}
definition doc {
    relation reader: user | user with ip_ok
    permission view = reader
}
"""

CLIENT_SCHEMA = """
caveat same_tenant(tenant string, edge_tenant string, tier int) {
    tenant == edge_tenant && tier >= 1
}
caveat quota(used int, limit int) { used * 2 < limit }
caveat before(at timestamp, until timestamp) { at < until }
caveat owner_is(m map<string>) { m.owner == 'alice' }
definition user {}
definition team { relation member: user | user with quota }
definition doc {
    relation team: team
    relation reader: user | user with same_tenant | user with quota | user with before | user with owner_is | team#member
    permission view = reader + team->member
}
"""


def _client_writes(mod):
    T0 = "2023-11-14T22:13:20Z"  # NOW
    r = mod.must_from_triple
    return [
        r("doc:d1", "reader", "user:u1").with_caveat("same_tenant", {"edge_tenant": "acme"}),
        # stored context wins over the query's
        r("doc:d2", "reader", "user:u1").with_caveat("same_tenant", {"edge_tenant": "acme", "tier": 0}),
        r("doc:d3", "reader", "user:u2").with_caveat("quota", {"limit": 10}),
        r("doc:d4", "reader", "user:u2").with_caveat("before", {"until": "2024-01-01T00:00:00Z"}),
        r("doc:d5", "reader", "user:u3").with_caveat("owner_is", {"m": {"owner": "alice"}}),
        r("doc:d6", "reader", "user:u3"),
        r("team:t1", "member", "user:u4").with_caveat("quota", {"used": 1}),
        r("doc:d7", "team", "team:t1"),
        r("doc:d8", "reader", "team:t1#member"),
        r("doc:d9", "reader", "user:u5").with_caveat("before", {"at": T0, "until": "2020-01-01T00:00:00Z"}),
    ]


def _client_checks(mod):
    r = mod.must_from_triple
    out = []
    for d in range(1, 10):
        for u in range(1, 6):
            base = r(f"doc:d{d}", "view", f"user:u{u}")
            out.append(base)
            out.append(base.with_caveat("", {"tenant": "acme", "tier": 2, "used": 2,
                                             "limit": 10, "at": "2023-06-01T00:00:00Z"}))
            out.append(base.with_caveat("", {"tenant": "other", "tier": 2, "used": 9,
                                             "at": "2025-06-01T00:00:00Z"}))
    return out


def _pair(schema, writes, cfg):
    pc = new_evaluator(with_engine_config(EngineConfig(**cfg)), device="cpu")
    jc = jclient.new_tpu_evaluator()
    revs = []
    for c, mod, ctx in ((pc, prel, background()), (jc, jrel, j_background())):
        c.write_schema(ctx, schema)
        txn = mod.Txn()
        for w in writes(mod):
            txn.create(w)
        revs.append(c.write(ctx, txn))
    return pc, jc, revs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_declared_caveat_without_caveated_rows_answers(layout):
    """A schema that declares a caveat, with only uncaveated
    relationships: check and both lookups answer, as the reference's."""
    def writes(mod):
        return [mod.must_from_triple("doc:d1", "reader", "user:u1")]

    pc, jc, _revs = _pair(FAULT1_SCHEMA, writes, LAYOUTS[layout])
    p_checks = [prel.must_from_triple(d, "view", u) for d in ("doc:d1", "doc:d2")
                for u in ("user:u1", "user:u2")]
    j_checks = [jrel.must_from_triple(d, "view", u) for d in ("doc:d1", "doc:d2")
                for u in ("user:u1", "user:u2")]
    got = pc.check(background(), pcons.full(), *p_checks)
    assert got == jc.check(j_background(), jcons.full(), *j_checks) == [True, False, False, False]
    assert list(pc.lookup_resources(background(), pcons.full(), "doc#view", "user:u1")) == ["d1"]
    assert list(pc.lookup_subjects(background(), pcons.full(), "doc:d1", "view", "user")) == ["u1"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_caveated_client_matches_reference_client(layout):
    """String, int, timestamp and host-only caveats; checks with and
    without request context, a stored context that wins over the
    query's, a caveated membership and the lookups: the port's answers
    are the reference client's."""
    pc, jc, _revs = _pair(CLIENT_SCHEMA, _client_writes, LAYOUTS[layout])
    p_checks, j_checks = _client_checks(prel), _client_checks(jrel)
    got = pc.check(background(), pcons.full(), *p_checks)
    want = jc.check(j_background(), jcons.full(), *j_checks)
    assert got == want
    assert any(got) and not all(got)
    # the stored tier 0 beats the query's tier 2: d2 stays denied
    assert not got[(2 - 1) * 15 + 1]
    engine = pc._engine
    assert engine.caveat_plan.host_only.tolist() == [
        False, *[n == "owner_is" for n in sorted(engine.compiled.caveat_ids,
                                                  key=engine.compiled.caveat_ids.get)]]
    for u in range(1, 6):
        assert (list(pc.lookup_resources(background(), pcons.full(), "doc#view", f"user:u{u}"))
                == list(jc.lookup_resources(j_background(), jcons.full(), "doc#view", f"user:u{u}")))
    for d in range(1, 10):
        assert (list(pc.lookup_subjects(background(), pcons.full(), f"doc:d{d}", "view", "user"))
                == list(jc.lookup_subjects(j_background(), jcons.full(), f"doc:d{d}", "view", "user")))
