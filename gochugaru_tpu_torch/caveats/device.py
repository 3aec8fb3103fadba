"""On-device CEL caveat evaluation (BASELINE config 4).

The host compiler (``cel.py``) gives each caveat a typed AST.  This module
lowers the *device-eligible* subset to straight-line torch ops so caveated
edges resolve to definite permissionship inside the flat check instead of
falling back to the host oracle.  SpiceDB evaluates caveats in its
server-side CEL interpreter (context travels in the CheckBulkPermissions
items, client/client.go:241-259); here the "server" is the card, so the
predicate itself must vectorize.  The host halves (the plan, the interval
analysis, the context encoding) are gochugaru_tpu/caveats/device.py's;
the lowering and ``make_tri_fn`` are rewritten on torch tensors, with
every constant a tensor of an explicit dtype so results are the
reference's bit for bit.

Design:

- **Static typing.**  CEL is dynamically typed, but caveat declarations
  carry parameter types (``caveat c(a int, b string)``), so the whole tree
  types statically: int/uint → i32, bool → tri-state i32, double → f32,
  string → interned i32 id, timestamp/duration → a two-limb i32 pair of
  epoch/signed microseconds (see below).  Anything outside that (lists,
  maps, ``any``, member access, dynamic ``timestamp(x)`` construction)
  marks the caveat host-only.

- **Time as i32 limb pairs.**  The host evaluates the CEL time algebra
  in exact integer microseconds (cel.py Timestamp/Duration); the year
  9999 is ≈2^57.8 µs, far outside i32, and the VM stays in 32-bit
  integers.  So a time value rides in TWO i32 lanes:
  ``us = hi·2^30 + lo`` with ``lo ∈ [0, 2^30)`` canonical.  Add/sub
  work limb-wise with one arithmetic-shift carry normalization
  (``lo >> 30`` floors for negatives, so the pair stays canonical);
  ordered compares are lexicographic on (hi, lo), exact because lo is
  non-negative.  Every operation is integer-exact — no f64 round-trip —
  so device results are bitwise the host's.  The same interval analysis
  that bounds int arithmetic bounds the time algebra: every
  intermediate must stay under 2^58 µs (canonical ``|hi| ≤ 2^28``, so a
  limb-wise add can never overflow i32), with a per-caveat bound ladder
  and encode-time eviction to the host flag beyond it.

- **Tri-state Kleene logic.**  Results are 0=FALSE, 1=UNKNOWN, 2=TRUE in
  i32; ``or``=max, ``and``=min, ``not``=2-x — the same encoding the host
  oracle uses (engine/oracle.py).  A missing context parameter is UNKNOWN,
  which the caller maps to CONDITIONAL → host resolution.

- **Exactness over coverage.**  The device only evaluates what it can
  evaluate *bit-exactly* against the host oracle: int arithmetic is bounded
  by interval analysis so i32 can never overflow (rows with larger values
  get a per-(row, caveat) host flag); doubles must round-trip through f32;
  unknown-at-build strings get fresh negative ids so they compare equal
  only to themselves.  Rows that violate a bound fall back to the host —
  coverage shrinks, correctness never does.

- **Merge semantics.**  Stored (edge) context wins over query context
  per-parameter, exactly as the oracle merges (oracle.py:120-122).
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.consts import scalar as _scalar
from ..schema.compiler import CompiledSchema
from .cel import (
    CelCompileError,
    CelProgram,
    Duration,
    Timestamp,
    _TimeValue,
    compile_cel,
    parse_duration,
    parse_timestamp,
)

F, U, T = 0, 1, 2
I32_MAX = 2**31 - 1
#: ints exactly representable in f32
F32_EXACT_INT = 2**24

#: time limb split: us = hi * 2^30 + lo with lo ∈ [0, 2^30) canonical.
#: 30 bits keeps a limb-wise add of two canonical los < 2^31 (no i32
#: wrap) while hi spans ±2^28 at the 2^58-µs intermediate ceiling.
TIME_RADIX_BITS = 30
TIME_LO_MASK = (1 << TIME_RADIX_BITS) - 1
#: max |µs| any intermediate time value may reach on device: canonical
#: |hi| ≤ 2^28, so one un-normalized add stays far inside i32
TIME_MAX_US = 1 << 58
_TIMED_KINDS = ("timestamp", "duration")


class _HostOnly(Exception):
    """Raised during lowering when a construct can't run on device."""


# device value representation:
#   bool  → tri i32 (0/1/2)
#   int   → (i32 value, bool known)
#   double→ (f32 value, bool known)
#   string→ (i32 id, bool known)
#   timestamp/duration → ((i32 hi, i32 lo), bool known) µs limb pair
_VALUE_KINDS = ("int", "double", "string")


@dataclass
class ContextTable:
    """Encoded context rows: [N, P] typed values + per-(row, caveat) host
    flags.  N is always ≥ 1 so clipped gathers on index -1 stay in range."""

    vi: np.ndarray  # int32[N, P] int/bool/string-id values
    vf: np.ndarray  # float32[N, P] double values
    present: np.ndarray  # bool[N, P]
    host: np.ndarray  # bool[N, C+1] needs-host flag per caveat id


@dataclass
class CaveatDevicePlan:
    """Static, schema-derived caveat lowering shared by every snapshot."""

    num_params: int  # P: global param slots across caveats
    num_caveats: int  # C (ids are 1-based; 0 = no caveat)
    #: (caveat_name, param_name) → global slot
    slot_of: Dict[Tuple[str, str], int]
    #: per slot: declared device type ('int' | 'double' | 'bool' | 'string')
    slot_type: List[str]
    #: param name → [(caveat_id, slot)] for query-context fan-out
    slots_of_param: Dict[str, List[Tuple[int, int]]]
    #: per caveat id: True → always host-evaluated
    host_only: np.ndarray  # bool[C+1]
    #: per caveat id: max |int| context value evaluable on device
    int_bound: np.ndarray  # int64[C+1]
    #: per caveat id: max |µs| context time value evaluable on device
    time_bound: np.ndarray  # int64[C+1]
    #: caveat id → traced (vi, vf, present) → tri; operates on [..., P]
    programs: Dict[int, Callable]
    #: string literal pool (extended by snapshot contexts)
    base_strings: Dict[str, int]
    caveat_params: Dict[str, Mapping[str, str]]  # name → declared params
    name_of_id: Dict[int, str]

    @property
    def has_device_programs(self) -> bool:
        return bool(self.programs)


_DEVICE_PARAM_TYPES = {"int": "int", "uint": "int", "double": "double",
                       "bool": "bool", "string": "string",
                       "timestamp": "timestamp", "duration": "duration"}


def _base_type(ptype: str) -> str:
    return ptype.split("<", 1)[0].strip()


# ---------------------------------------------------------------------------
# interval analysis: can i32 arithmetic overflow with |var| ≤ B?
# ---------------------------------------------------------------------------


def _int_extent(node, types: Dict[str, str], bound: int, state: Dict[str, bool]) -> int:
    """Max |value| of an int-typed node with every int context value bounded
    by ``bound`` in magnitude; 0 for non-value nodes.  Sets ``state['ovf']``
    when any int arithmetic node can exceed i32."""
    op = node[0]
    if op == "lit":
        v = node[1]
        return abs(v) if isinstance(v, int) and not isinstance(v, bool) else 0
    if op == "var":
        return bound if types.get(node[1]) == "int" else 0
    if op == "neg":
        return _int_extent(node[1], types, bound, state)
    if op == "arith":
        a = _int_extent(node[2], types, bound, state)
        b = _int_extent(node[3], types, bound, state)
        o = node[1]
        if o in ("+", "-"):
            m = a + b
        elif o == "*":
            m = a * b
        elif o == "/":
            m = a  # |a / b| ≤ |a| for truncated division
        else:  # %: truncated remainder has |r| < |b| and |r| ≤ |a|
            m = min(a, b)
        if m >= I32_MAX:
            state["ovf"] = True
        return m
    if op == "cond":
        _int_extent(node[1], types, bound, state)
        return max(
            _int_extent(node[2], types, bound, state),
            _int_extent(node[3], types, bound, state),
        )
    if op in ("not",):
        _int_extent(node[1], types, bound, state)
        return 0
    if op in ("or", "and", "in"):
        _int_extent(node[1], types, bound, state)
        _int_extent(node[2], types, bound, state)
        return 0
    if op == "cmp":
        _int_extent(node[2], types, bound, state)
        _int_extent(node[3], types, bound, state)
        return 0
    if op == "list":
        for it in node[1]:
            _int_extent(it, types, bound, state)
        return 0
    return 0


def _arith_safe(ast, types: Dict[str, str], bound: int) -> bool:
    """True if no int-typed arithmetic node can exceed i32 with every int
    context value bounded by ``bound`` in magnitude."""
    state = {"ovf": False}
    _int_extent(ast, types, bound, state)
    return not state["ovf"]


def _time_extent(node, types: Dict[str, str], bound: int,
                 state: Dict[str, bool]) -> int:
    """Max |µs| of a time-typed node with every timed context value
    bounded by ``bound`` µs in magnitude; 0 for non-time nodes.  Sets
    ``state['tovf']`` when any time arithmetic node can exceed the 2^58
    intermediate ceiling, and ``state['tarith']`` when the tree does any
    time arithmetic at all (no arithmetic ⇒ compares only ⇒ no bound
    needed beyond the limb representation itself)."""
    op = node[0]
    if op == "lit":
        v = node[1]
        return abs(v.us) if isinstance(v, _TimeValue) else 0
    if op == "var":
        return bound if types.get(node[1]) in _TIMED_KINDS else 0
    if op == "neg":
        return _time_extent(node[1], types, bound, state)
    if op == "arith":
        a = _time_extent(node[2], types, bound, state)
        b = _time_extent(node[3], types, bound, state)
        if a == 0 and b == 0:
            return 0
        state["tarith"] = True
        m = a + b  # only ± reach the device lowering for timed operands
        if m >= TIME_MAX_US:
            state["tovf"] = True
        return m
    if op == "cond":
        _time_extent(node[1], types, bound, state)
        return max(
            _time_extent(node[2], types, bound, state),
            _time_extent(node[3], types, bound, state),
        )
    if op == "not":
        _time_extent(node[1], types, bound, state)
        return 0
    if op in ("or", "and", "in"):
        _time_extent(node[1], types, bound, state)
        _time_extent(node[2], types, bound, state)
        return 0
    if op == "cmp":
        _time_extent(node[2], types, bound, state)
        _time_extent(node[3], types, bound, state)
        return 0
    if op == "list":
        for it in node[1]:
            _time_extent(it, types, bound, state)
        return 0
    return 0


def _time_safe(ast, types: Dict[str, str], bound: int) -> bool:
    state: Dict[str, bool] = {"tovf": False}
    _time_extent(ast, types, bound, state)
    return not state["tovf"]


# ---------------------------------------------------------------------------
# AST → torch lowering
# ---------------------------------------------------------------------------


def _time_norm(hi, lo):
    """Re-canonicalize a µs limb pair after a limb-wise ±: the shift is
    arithmetic on int32 tensors, so the carry floors and lo lands back in
    [0, 2^30) for negative sums too."""
    carry = lo >> TIME_RADIX_BITS
    return hi + carry, lo & _const(TIME_LO_MASK, torch.int32, lo)


def _const(v, dtype, like):
    """A VM constant: a 0-dim tensor of an explicit dtype on ``like``'s
    device, so no operation promotes through a Python scalar; built once
    per device (engine/consts.py)."""
    return _scalar(v, dtype, like.device)


def _tri(cond_t, known, vi):
    """TRUE/FALSE by ``cond_t`` where ``known``, else UNKNOWN (int32)."""
    return torch.where(
        known,
        torch.where(cond_t, _const(T, torch.int32, vi), _const(F, torch.int32, vi)),
        _const(U, torch.int32, vi),
    )


def _lower_program(
    prog: CelProgram,
    slot_of: Dict[Tuple[str, str], int],
    strings: Dict[str, int],
) -> Callable:
    """Lower one caveat AST to ``fn(vi, vf, present) → tri`` over [..., P]
    tensors.  Raises _HostOnly for unsupported constructs.  String
    literals intern into ``strings`` in the order the tree is walked
    (operands left to right), so the pool's ids are fixed by the schema."""
    types: Dict[str, str] = {}
    for pname, ptype in prog.params.items():
        dt = _DEVICE_PARAM_TYPES.get(_base_type(ptype))
        if dt is None:
            raise _HostOnly(f"param type {ptype}")
        types[pname] = dt

    def intern(s: str) -> int:
        if s not in strings:
            strings[s] = len(strings) + 1
        return strings[s]

    # int-typed subtrees that get promoted to f32 in a double comparison;
    # build_caveat_plan must prove their interval max ≤ F32_EXACT_INT under
    # the chosen int bound, or evict the caveat to the host (compound int
    # expressions can exceed 2^24 while still passing the i32 overflow
    # check — e.g. 'a + 99999999 > lim' rounds in f32)
    promoted_int: List[Any] = []
    I32, F32, BOOL = torch.int32, torch.float32, torch.bool

    # Each lowered node is (kind, emit).  For kind 'bool', emit(vi,vf,pr)
    # returns tri; for value kinds it returns (value, known).
    def lower(node):
        op = node[0]
        if op == "lit":
            v = node[1]
            if isinstance(v, bool):
                return "bool", lambda vi, vf, pr, t=(T if v else F): _const(t, I32, vi)
            if isinstance(v, _TimeValue):
                # timestamp("...")/duration("...") literals folded at parse
                # time; split into canonical µs limbs here
                if abs(v.us) >= TIME_MAX_US:
                    raise _HostOnly("time literal out of device range")
                hi, lo = v.us >> TIME_RADIX_BITS, v.us & TIME_LO_MASK
                kind = "timestamp" if isinstance(v, Timestamp) else "duration"
                return kind, lambda vi, vf, pr, h=hi, l=lo: (
                    (_const(h, I32, vi), _const(l, I32, vi)), _const(True, BOOL, vi))
            if isinstance(v, int):
                if abs(v) >= I32_MAX:
                    raise _HostOnly("int literal out of i32 range")
                return "int", lambda vi, vf, pr, c=v: (
                    _const(c, I32, vi), _const(True, BOOL, vi))
            if isinstance(v, float):
                if float(np.float32(v)) != v:
                    raise _HostOnly("double literal not f32-exact")
                return "double", lambda vi, vf, pr, c=v: (
                    _const(c, F32, vi), _const(True, BOOL, vi))
            if isinstance(v, str):
                return "string", lambda vi, vf, pr, c=intern(v): (
                    _const(c, I32, vi), _const(True, BOOL, vi))
            raise _HostOnly(f"literal {v!r}")
        if op == "var":
            name = node[1]
            kind = types[name]
            s = slot_of[(prog.name, name)]
            if kind == "bool":
                def emit_b(vi, vf, pr, s=s):
                    return _tri(vi[..., s] != 0, pr[..., s], vi)
                return "bool", emit_b
            if kind == "double":
                return "double", lambda vi, vf, pr, s=s: (vf[..., s], pr[..., s])
            if kind in _TIMED_KINDS:
                # two consecutive i32 slots: hi at s, lo at s + 1
                return kind, lambda vi, vf, pr, s=s: (
                    (vi[..., s], vi[..., s + 1]), pr[..., s])
            return kind, lambda vi, vf, pr, s=s: (vi[..., s], pr[..., s])
        if op == "not":
            k, e = lower(node[1])
            if k != "bool":
                raise _HostOnly("! on non-bool")
            return "bool", lambda vi, vf, pr: _const(2, I32, vi) - e(vi, vf, pr)
        if op == "neg":
            k, e = lower(node[1])
            if k in ("int", "double"):
                def emit_n(vi, vf, pr):
                    v, kn = e(vi, vf, pr)
                    return -v, kn
                return k, emit_n
            if k == "duration":
                def emit_nd(vi, vf, pr):
                    (hi, lo), kn = e(vi, vf, pr)
                    return _time_norm(-hi, -lo), kn
                return "duration", emit_nd
            # -timestamp is a host TypeError too
            raise _HostOnly("unary - on non-numeric")
        if op in ("or", "and"):
            ka, ea = lower(node[1])
            kb, eb = lower(node[2])
            if ka != "bool" or kb != "bool":
                raise _HostOnly(f"{op} on non-bool")
            red = torch.maximum if op == "or" else torch.minimum
            return "bool", lambda vi, vf, pr: red(ea(vi, vf, pr), eb(vi, vf, pr))
        if op == "cond":
            kc, ec = lower(node[1])
            if kc != "bool":
                raise _HostOnly("?: condition not bool")
            kt, et = lower(node[2])
            kf, ef = lower(node[3])
            if kt != kf:
                raise _HostOnly("?: branches differ in type")
            if kt == "bool":
                def emit_cb(vi, vf, pr):
                    c = ec(vi, vf, pr)
                    return torch.where(
                        c == U, _const(U, I32, vi),
                        torch.where(c == T, et(vi, vf, pr), ef(vi, vf, pr)),
                    )
                return "bool", emit_cb

            def emit_cv(vi, vf, pr):
                c = ec(vi, vf, pr)
                tv, tk = et(vi, vf, pr)
                fv, fk = ef(vi, vf, pr)
                if isinstance(tv, tuple):  # timed: select per limb
                    val = (torch.where(c == T, tv[0], fv[0]),
                           torch.where(c == T, tv[1], fv[1]))
                else:
                    val = torch.where(c == T, tv, fv)
                known = (c != U) & torch.where(c == T, tk, fk)
                return val, known
            return kt, emit_cv
        if op == "cmp":
            o = node[1]
            ka, ea = lower(node[2])
            kb, eb = lower(node[3])
            if ka == "bool" and kb == "bool":
                if o not in ("==", "!="):
                    raise _HostOnly("ordered comparison on bools")

                def emit_bb(vi, vf, pr, neq=(o == "!=")):
                    a = ea(vi, vf, pr)
                    b = eb(vi, vf, pr)
                    eq = (a == b) ^ neq
                    unknown = (a == U) | (b == U)
                    return _tri(eq, ~unknown, vi)
                return "bool", emit_bb
            if ka == "bool" or kb == "bool":
                raise _HostOnly("comparison mixes bool and value")
            if ka in _TIMED_KINDS or kb in _TIMED_KINDS:
                if ka != kb:
                    # cross-kind == is a constant False on the host and
                    # ordered compares are a host TypeError; neither is
                    # worth a device lowering
                    raise _HostOnly("comparison mixes time and non-time")

                def emit_tc(vi, vf, pr, o=o):
                    (ah, al), akn = ea(vi, vf, pr)
                    (bh, bl), bkn = eb(vi, vf, pr)
                    # canonical lo ≥ 0, so (hi, lo) orders lexicographically
                    if o == "==":
                        raw = (ah == bh) & (al == bl)
                    elif o == "!=":
                        raw = (ah != bh) | (al != bl)
                    elif o in ("<", "<="):
                        tie = (al < bl) if o == "<" else (al <= bl)
                        raw = (ah < bh) | ((ah == bh) & tie)
                    else:
                        tie = (al > bl) if o == ">" else (al >= bl)
                        raw = (ah > bh) | ((ah == bh) & tie)
                    return _tri(raw, akn & bkn, vi)
                return "bool", emit_tc
            if ka == "string" or kb == "string":
                if ka != kb:
                    raise _HostOnly("comparison mixes string and numeric")
                if o not in ("==", "!="):
                    raise _HostOnly("ordered comparison on strings")
            promote = "double" if "double" in (ka, kb) else ka
            if promote == "double":
                if ka == "int":
                    promoted_int.append(node[2])
                if kb == "int":
                    promoted_int.append(node[3])

            def emit_cmp(vi, vf, pr, o=o, promote=promote):
                av, akn = ea(vi, vf, pr)
                bv, bkn = eb(vi, vf, pr)
                if promote == "double":
                    # an int operand compares as f32, as the reference does
                    av, bv = av.to(F32), bv.to(F32)
                if o == "==":
                    raw = av == bv
                elif o == "!=":
                    raw = av != bv
                elif o == "<":
                    raw = av < bv
                elif o == "<=":
                    raw = av <= bv
                elif o == ">":
                    raw = av > bv
                else:
                    raw = av >= bv
                return _tri(raw, akn & bkn, vi)
            return "bool", emit_cmp
        if op == "arith":
            o = node[1]
            ka, ea = lower(node[2])
            kb, eb = lower(node[3])
            if ka in _TIMED_KINDS or kb in _TIMED_KINDS:
                # the CEL time algebra: ts − ts = dur, ts ± dur = ts,
                # dur ± dur = dur.  Everything else (ts + ts, *, /, %,
                # time mixed with numerics) is a host TypeError.
                if o == "+" and (ka, kb) in (
                    ("timestamp", "duration"), ("duration", "timestamp")
                ):
                    res = "timestamp"
                elif o == "-" and (ka, kb) == ("timestamp", "timestamp"):
                    res = "duration"
                elif o == "-" and (ka, kb) == ("timestamp", "duration"):
                    res = "timestamp"
                elif o in ("+", "-") and (ka, kb) == ("duration", "duration"):
                    res = "duration"
                else:
                    raise _HostOnly("time arithmetic outside the CEL algebra")

                def emit_ta(vi, vf, pr, sub=(o == "-")):
                    (ah, al), akn = ea(vi, vf, pr)
                    (bh, bl), bkn = eb(vi, vf, pr)
                    if sub:
                        bh, bl = -bh, -bl
                    return _time_norm(ah + bh, al + bl), akn & bkn
                return res, emit_ta
            if ka != "int" or kb != "int":
                # device arithmetic is int-only; float arithmetic would
                # round differently from the host's f64
                raise _HostOnly("non-int arithmetic")

            def emit_ar(vi, vf, pr, o=o):
                av, akn = ea(vi, vf, pr)
                bv, bkn = eb(vi, vf, pr)
                known = akn & bkn
                if o == "+":
                    return av + bv, known
                if o == "-":
                    return av - bv, known
                if o == "*":
                    return av * bv, known
                # CEL integer / and % truncate toward zero; divide-by-zero
                # is a host-side error → UNKNOWN here.  The quotient's
                # magnitude is the floor of the magnitudes' quotient.
                bz = bv == 0
                safe_b = torch.where(bz, _const(1, I32, vi), bv)
                q = torch.sign(av) * torch.sign(safe_b) * torch.div(
                    av.abs(), safe_b.abs(), rounding_mode="floor")
                known = known & ~bz
                if o == "/":
                    return q, known
                return av - q * bv, known
            return "int", emit_ar
        if op == "in":
            ka, ea = lower(node[1])
            if ka not in _VALUE_KINDS + _TIMED_KINDS:
                raise _HostOnly("'in' on non-value")
            if node[2][0] != "list":
                raise _HostOnly("'in' target not a list literal")
            elems = [lower(it) for it in node[2][1]]
            for it, (ke, _) in zip(node[2][1], elems):
                if ke != ka and not (ka == "double" and ke == "int"):
                    raise _HostOnly("'in' list element type mismatch")
                if ka == "double" and ke == "int":
                    promoted_int.append(it)

            def emit_in(vi, vf, pr):
                av, akn = ea(vi, vf, pr)
                hit = _const(False, BOOL, vi)
                kn = akn
                for _, ee in elems:
                    ev, ekn = ee(vi, vf, pr)
                    if isinstance(av, tuple):  # timed: equal limb pairs
                        hit = hit | ((av[0] == ev[0]) & (av[1] == ev[1]))
                    else:
                        if ka == "double":
                            ev = ev.to(F32)
                        hit = hit | (av == ev)
                    kn = kn & ekn
                return _tri(hit, kn, vi)
            return "bool", emit_in
        raise _HostOnly(f"construct {op!r}")

    kind, emit = lower(prog.ast)
    if kind != "bool":
        raise _HostOnly("caveat does not evaluate to bool")

    def run(vi, vf, pr):
        out = emit(vi, vf, pr)
        if out.dtype != I32:
            raise TypeError(f"caveat {prog.name}: VM result is {out.dtype}")
        return torch.broadcast_to(out, vi.shape[:-1])

    return run, types, promoted_int


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------

_INT_BOUNDS = (2**30, 2**20, 2**16, 2**12, 2**8, 2**4)
#: time context-value bound ladder (µs): 2^57 keeps `ts ± dur` chains of
#: two inside the 2^58 intermediate ceiling while covering year 9999
#: contexts (≈2^57.8) via the no-arithmetic fast path above the ladder
_TIME_BOUNDS = (2**57, 2**52, 2**46, 2**40)


def build_caveat_plan(compiled: CompiledSchema) -> CaveatDevicePlan:
    """Assign global param slots and lower every device-eligible caveat.
    Caveats that fail lowering stay host-only — same behavior as before
    this module existed, just scoped per-caveat instead of per-schema."""
    caveats = compiled.schema.caveats
    C = len(compiled.caveat_ids)
    slot_of: Dict[Tuple[str, str], int] = {}
    slot_type: List[str] = []
    slots_of_param: Dict[str, List[Tuple[int, int]]] = {}
    caveat_params: Dict[str, Mapping[str, str]] = {}
    name_of_id = {cid: name for name, cid in compiled.caveat_ids.items()}

    for name in sorted(caveats):
        decl = caveats[name]
        cid = compiled.caveat_ids[name]
        caveat_params[name] = dict(decl.params)
        for pname in sorted(decl.params):
            dt = _DEVICE_PARAM_TYPES.get(_base_type(decl.params[pname]), "int")
            slot = len(slot_type)
            slot_of[(name, pname)] = slot
            slot_type.append(dt)
            if dt in _TIMED_KINDS:
                # companion lo limb rides in the next slot; it is never
                # listed in slots_of_param — the encoder fills both limbs
                # when it visits the primary slot
                slot_type.append("time_lo")
            slots_of_param.setdefault(pname, []).append((cid, slot))

    host_only = np.zeros(C + 1, bool)
    int_bound = np.full(C + 1, I32_MAX - 1, np.int64)
    time_bound = np.full(C + 1, TIME_MAX_US - 1, np.int64)
    programs: Dict[int, Callable] = {}
    base_strings: Dict[str, int] = {}

    for name in sorted(caveats):
        decl = caveats[name]
        cid = compiled.caveat_ids[name]
        try:
            prog = compile_cel(name, decl.params, decl.expression)
            fn, types, promoted = _lower_program(prog, slot_of, base_strings)
        except (_HostOnly, CelCompileError):
            host_only[cid] = True
            continue

        # pick the largest int bound under which (a) no int arithmetic can
        # overflow i32 and (b) every int subtree promoted to f32 in a double
        # comparison stays within F32_EXACT_INT, so the promotion is exact
        def bound_ok(b: int) -> bool:
            if not _arith_safe(prog.ast, types, b):
                return False
            st = {"ovf": False}
            return all(
                _int_extent(sub, types, b, st) <= F32_EXACT_INT
                for sub in promoted
            )

        chosen = next((b for b in _INT_BOUNDS if bound_ok(b)), None)
        if chosen is None:
            host_only[cid] = True
            continue
        if not _ast_has_arith(prog.ast) and not promoted:
            chosen = I32_MAX - 1
        int_bound[cid] = chosen

        # same ladder for time values: pick the largest µs bound under
        # which no ± chain can exceed the 2^58 intermediate ceiling.
        # Compares alone can't overflow, so keep the full range then.
        tstate: Dict[str, bool] = {"tovf": False}
        _time_extent(prog.ast, types, _TIME_BOUNDS[0], tstate)
        if tstate.get("tarith"):
            tchosen = next(
                (b for b in _TIME_BOUNDS if _time_safe(prog.ast, types, b)),
                None,
            )
            if tchosen is None:
                host_only[cid] = True
                continue
            time_bound[cid] = tchosen
        programs[cid] = fn

    return CaveatDevicePlan(
        num_params=len(slot_type),
        num_caveats=C,
        slot_of=slot_of,
        slot_type=slot_type,
        slots_of_param=slots_of_param,
        host_only=host_only,
        int_bound=int_bound,
        time_bound=time_bound,
        programs=programs,
        base_strings=base_strings,
        caveat_params=caveat_params,
        name_of_id=name_of_id,
    )


def _ast_has_arith(ast) -> bool:
    if ast[0] == "arith":
        return True
    return any(
        _ast_has_arith(c)
        for c in ast[1:]
        if isinstance(c, tuple)
    ) or (ast[0] == "list" and any(_ast_has_arith(it) for it in ast[1]))


# ---------------------------------------------------------------------------
# context encoding
# ---------------------------------------------------------------------------


def _time_us(base: str, v: Any) -> Optional[int]:
    """Mirror of CelProgram._coerced for one value: µs for anything the
    host would coerce into the declared timestamp/duration type, None
    for anything it would reject (the caller sets the host flag, and the
    host path raises exactly as before this lowering existed)."""
    if isinstance(v, bool):
        return None
    if base == "timestamp":
        if isinstance(v, Timestamp):
            return v.us
        if isinstance(v, _dt.datetime):
            return round(v.timestamp() * 1_000_000)
        if isinstance(v, str):
            try:
                return parse_timestamp(v).us
            except CelCompileError:
                return None
        if isinstance(v, (int, float)):
            return round(v * 1_000_000)
        return None
    if isinstance(v, Duration):
        return v.us
    if isinstance(v, _dt.timedelta):
        return round(v.total_seconds() * 1_000_000)
    if isinstance(v, str):
        try:
            return parse_duration(v).us
        except CelCompileError:
            return None
    if isinstance(v, (int, float)):
        return round(v * 1_000_000)
    return None


def encode_contexts(
    plan: CaveatDevicePlan,
    rows: Sequence[Mapping[str, Any]],
    strings: Dict[str, int],
    *,
    extra_strings: Optional[Dict[str, int]] = None,
) -> ContextTable:
    """Encode context maps into typed [N, P] columns.

    ``strings`` is the shared pool (literals + snapshot strings); when
    ``extra_strings`` is given (query-time), unknown strings get fresh
    *negative* ids there instead of growing the pool — equal unknown
    strings still compare equal, but never collide with stored ids.

    A value a slot can't hold exactly (wrong type, out of the caveat's int
    bound, not f32-exact) sets the (row, caveat) host flag; that caveat's
    probes on the row fall back to the host oracle.
    """
    N = max(len(rows), 1)
    P = max(plan.num_params, 1)
    vi = np.zeros((N, P), np.int32)
    vf = np.zeros((N, P), np.float32)
    present = np.zeros((N, P), bool)
    host = np.zeros((N, plan.num_caveats + 1), bool)

    def string_id(s: str) -> int:
        sid = strings.get(s)
        if sid is not None:
            return sid
        if extra_strings is None:
            sid = len(strings) + 1
            strings[s] = sid
            return sid
        sid = extra_strings.get(s)
        if sid is None:
            sid = -2 - len(extra_strings)
            extra_strings[s] = sid
        return sid

    for i, ctx in enumerate(rows):
        for pname, value in ctx.items():
            for cid, slot in plan.slots_of_param.get(pname, ()):  # noqa: B905
                st = plan.slot_type[slot]
                if st == "int":
                    if isinstance(value, bool) or not isinstance(value, int):
                        host[i, cid] = True
                        continue
                    if abs(value) > plan.int_bound[cid]:
                        host[i, cid] = True
                        continue
                    vi[i, slot] = value
                elif st == "double":
                    if isinstance(value, bool) or not isinstance(value, (int, float)):
                        host[i, cid] = True
                        continue
                    f = float(value)
                    if float(np.float32(f)) != f:
                        host[i, cid] = True
                        continue
                    vf[i, slot] = f
                elif st in _TIMED_KINDS:
                    us = _time_us(st, value)
                    if us is None or abs(us) > plan.time_bound[cid]:
                        host[i, cid] = True
                        continue
                    vi[i, slot] = us >> TIME_RADIX_BITS
                    vi[i, slot + 1] = us & TIME_LO_MASK
                    present[i, slot + 1] = True
                elif st == "bool":
                    if not isinstance(value, bool):
                        host[i, cid] = True
                        continue
                    vi[i, slot] = int(value)
                else:  # string
                    if not isinstance(value, str):
                        host[i, cid] = True
                        continue
                    vi[i, slot] = string_id(value)
                present[i, slot] = True
    return ContextTable(vi=vi, vf=vf, present=present, host=host)


def make_tri_fn(plan: CaveatDevicePlan):
    """Build the tri-state gate:

    ``tri(cav, ctx_idx, qctx_idx, tables) → int32`` over any batch shape,
    where ``tables`` holds the ectx_* / qctx_* tensors.  Caveat 0 → TRUE;
    host-only caveats and host-flagged rows → UNKNOWN.  Plain torch ops on
    the tensors' device: the reference runs this VM as XLA ops outside any
    kernel.  Indices clamp into their tables, as the reference's gathers
    do."""
    host_only = torch.from_numpy(np.asarray(plan.host_only, bool))
    on_device: Dict[torch.device, torch.Tensor] = {}

    def tri(cav, ctx_idx, qctx_idx, tables):
        dev = cav.device
        ho = on_device.get(dev)
        if ho is None:
            ho = on_device[dev] = host_only.to(dev)
        e = ctx_idx.clamp(0, tables["ectx_vi"].shape[0] - 1).long()
        has_e = ctx_idx >= 0
        q = qctx_idx.clamp(0, tables["qctx_vi"].shape[0] - 1).long()
        has_q = qctx_idx >= 0
        ep = tables["ectx_pr"][e] & has_e.unsqueeze(-1)
        qp = tables["qctx_pr"][q] & has_q.unsqueeze(-1)
        vi = torch.where(ep, tables["ectx_vi"][e], tables["qctx_vi"][q])
        vf = torch.where(ep, tables["ectx_vf"][e], tables["qctx_vf"][q])
        pr = ep | qp
        cavc = cav.clamp(0, plan.num_caveats).long()
        row_host = (
            (tables["ectx_host"][e, cavc] & has_e)
            | (tables["qctx_host"][q, cavc] & has_q)
        )
        unknown = _scalar(U, torch.int32, dev)
        out = unknown.expand(cav.shape)
        for cid, fn in plan.programs.items():
            out = torch.where(cav == cid, fn(vi, vf, pr), out)
        out = torch.where(ho[cavc] | row_host, unknown, out)
        return torch.where(cav == 0, _scalar(T, torch.int32, dev), out)

    return tri
