"""A CEL-subset compiler and tri-state host evaluator.

Supported subset (the fragment that covers typical authorization caveats and
vectorizes onto TPU):

- literals: int, float, string, bool, null
- identifiers and dotted member access into the context map
- operators: ``?:``, ``||``, ``&&``, ``!``, comparisons
  (``== != < <= > >=``), arithmetic (``+ - * / %``, unary ``-``), ``in``
  (membership in a list literal or list-valued context value)
- parentheses
- ``timestamp("<RFC 3339>")`` and ``duration("1h30m")`` constructors
  (host evaluation): timestamps and durations compare and do the CEL
  arithmetic (ts − ts = dur, ts ± dur = ts, dur ± dur = dur); context
  parameters DECLARED as ``timestamp``/``duration`` coerce from RFC 3339
  / CEL duration strings (or datetimes / numeric seconds) at evaluation
  time.  Params DECLARED timestamp/duration and folded time literals
  also lower onto the device as exact-µs i32 limb pairs
  (caveats/device.py); only the dynamic constructor form
  (``timestamp(x)`` over a non-literal) stays host-only

Evaluation is three-valued: a missing context parameter makes the result
UNKNOWN rather than an error — SpiceDB's CONDITIONAL permissionship — and
UNKNOWN propagates through Kleene logic (``T || U = T``, ``F && U = F``,
comparisons with UNKNOWN are UNKNOWN).  The engine collapses UNKNOWN to
"no permission" at the API boundary, where the reference client also
collapses permissionship to bool (client/client.go:277).
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, List, Mapping, Optional, Tuple


class CelCompileError(ValueError):
    pass


class _Unknown:
    """The UNKNOWN truth value (missing context)."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "UNKNOWN"


UNKNOWN = _Unknown()


class CelType:
    """CEL caveat parameter types we accept in declarations."""

    KNOWN = {
        "int", "uint", "double", "bool", "string", "timestamp", "duration",
        "any", "list", "map",
    }


class _TimeValue:
    """Shared microsecond scalar: construction + the ordered
    comparisons (strictly same-typed, like CEL).  The subclasses own
    equality, hashing, and the time algebra."""

    __slots__ = ("us",)
    _kind = "time"

    def __init__(self, us: int) -> None:
        self.us = int(us)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self._kind}({self.us}us)"

    def _cmp(self, other: Any):
        if type(other) is not type(self):
            raise TypeError(
                f"{self._kind} compared with non-{self._kind}"
            )
        return self.us, other.us

    def __lt__(self, other):
        a, b = self._cmp(other)
        return a < b

    def __le__(self, other):
        a, b = self._cmp(other)
        return a <= b

    def __gt__(self, other):
        a, b = self._cmp(other)
        return a > b

    def __ge__(self, other):
        a, b = self._cmp(other)
        return a >= b


class Timestamp(_TimeValue):
    """A CEL timestamp: microseconds since the Unix epoch.  Orders
    against other timestamps; ``ts - ts`` is a Duration, ``ts ± dur``
    a Timestamp — the CEL time algebra the host evaluator computes."""

    __slots__ = ()
    _kind = "timestamp"

    def __eq__(self, other: Any) -> Any:
        return isinstance(other, Timestamp) and self.us == other.us

    def __hash__(self) -> int:
        return hash(("ts", self.us))

    def __sub__(self, other):
        if isinstance(other, Timestamp):
            return Duration(self.us - other.us)
        if isinstance(other, Duration):
            return Timestamp(self.us - other.us)
        raise TypeError("timestamp - non-time")

    def __add__(self, other):
        if isinstance(other, Duration):
            return Timestamp(self.us + other.us)
        raise TypeError("timestamp + non-duration")


class Duration(_TimeValue):
    """A CEL duration: signed microseconds."""

    __slots__ = ()
    _kind = "duration"

    def __eq__(self, other: Any) -> Any:
        return isinstance(other, Duration) and self.us == other.us

    def __hash__(self) -> int:
        return hash(("dur", self.us))

    def __add__(self, other):
        if isinstance(other, Duration):
            return Duration(self.us + other.us)
        if isinstance(other, Timestamp):
            return Timestamp(self.us + other.us)
        raise TypeError("duration + non-time")

    def __sub__(self, other):
        if isinstance(other, Duration):
            return Duration(self.us - other.us)
        raise TypeError("duration - non-duration")

    def __neg__(self):
        return Duration(-self.us)


#: parts are UNSIGNED — like Go's time.ParseDuration, only ONE leading
#: sign is legal ("1h-30m" and a bare "-" are rejected, not summed)
_DUR_PART = re.compile(r"(\d+(?:\.\d+)?)(h|ms|us|ns|m|s)")
_DUR_SCALE = {
    "h": 3_600_000_000, "m": 60_000_000, "s": 1_000_000,
    "ms": 1_000, "us": 1, "ns": 1e-3,
}


def parse_duration(s: str) -> Duration:
    """CEL/Go duration literal: "1h30m", "300s", "1.5s", "-2m" ..."""
    body = s.strip()
    neg = body.startswith("-")
    if neg or body.startswith("+"):
        body = body[1:]
    if not body:
        raise CelCompileError(f"empty duration literal {s!r}")
    if body == "0":  # Go accepts the bare zero without a unit
        return Duration(0)
    pos = 0
    total = 0.0
    while pos < len(body):
        m = _DUR_PART.match(body, pos)
        if m is None:
            raise CelCompileError(f"bad duration literal {s!r}")
        total += float(m.group(1)) * _DUR_SCALE[m.group(2)]
        pos = m.end()
    return Duration(round(-total if neg else total))


def parse_timestamp(s: str) -> Timestamp:
    """RFC 3339 timestamp ("2024-01-02T03:04:05Z", offsets allowed)."""
    body = s.strip()
    try:
        dt = _dt.datetime.fromisoformat(body.replace("Z", "+00:00"))
    except ValueError as e:
        raise CelCompileError(f"bad timestamp literal {s!r}") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return Timestamp(round(dt.timestamp() * 1_000_000))


#: host-evaluable builtin constructors (the device VM declines these)
_CEL_FUNCS = {"timestamp", "duration"}


_CEL_TOKEN = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<float>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
    | (?P<int>\d+u?)
    | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>\|\||&&|==|!=|<=|>=|[-+*/%!<>()?:,.\[\]])
    """,
    re.VERBOSE,
)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    toks = []
    pos = 0
    while pos < len(src):
        m = _CEL_TOKEN.match(src, pos)
        if m is None:
            raise CelCompileError(f"unexpected character {src[pos]!r} in caveat expression")
        kind = m.lastgroup
        if kind != "ws":
            toks.append((kind, m.group()))
        pos = m.end()
    toks.append(("eof", ""))
    return toks


# AST: tuples (op, ...)
#   ("lit", value) ("var", name) ("member", base, name)
#   ("not", x) ("neg", x) ("or", a, b) ("and", a, b) ("cond", c, t, f)
#   ("cmp", op, a, b) ("arith", op, a, b) ("in", a, b) ("list", [items])
#   ("call", fname, [args])  — timestamp()/duration() constructors


class _CelParser:
    def __init__(self, src: str) -> None:
        self.toks = _tokenize(src)
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        k, t = self.next()
        if t != text:
            raise CelCompileError(f"expected {text!r}, got {t!r}")

    def parse(self):
        e = self.parse_ternary()
        if self.peek()[0] != "eof":
            raise CelCompileError(f"trailing tokens at {self.peek()[1]!r}")
        return e

    def parse_ternary(self):
        cond = self.parse_or()
        if self.peek()[1] == "?":
            self.next()
            t = self.parse_ternary()
            self.expect(":")
            f = self.parse_ternary()
            return ("cond", cond, t, f)
        return cond

    def parse_or(self):
        left = self.parse_and()
        while self.peek()[1] == "||":
            self.next()
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_rel()
        while self.peek()[1] == "&&":
            self.next()
            left = ("and", left, self.parse_rel())
        return left

    _CMP = {"==", "!=", "<", "<=", ">", ">="}

    def parse_rel(self):
        left = self.parse_add()
        while True:
            t = self.peek()[1]
            if t in self._CMP:
                self.next()
                left = ("cmp", t, left, self.parse_add())
            elif t == "in":
                self.next()
                left = ("in", left, self.parse_add())
            else:
                return left

    def parse_add(self):
        left = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            left = ("arith", op, left, self.parse_mul())
        return left

    def parse_mul(self):
        left = self.parse_unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            left = ("arith", op, left, self.parse_unary())
        return left

    def parse_unary(self):
        t = self.peek()[1]
        if t == "!":
            self.next()
            return ("not", self.parse_unary())
        if t == "-":
            self.next()
            return ("neg", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while self.peek()[1] == ".":
            self.next()
            k, name = self.next()
            if k != "ident":
                raise CelCompileError(f"expected member name after '.', got {name!r}")
            e = ("member", e, name)
        return e

    def parse_primary(self):
        kind, text = self.next()
        if text == "(":
            e = self.parse_ternary()
            self.expect(")")
            return e
        if text == "[":
            items = []
            while self.peek()[1] != "]":
                items.append(self.parse_ternary())
                if self.peek()[1] == ",":
                    self.next()
            self.expect("]")
            return ("list", items)
        if kind == "int":
            return ("lit", int(text.rstrip("u")))
        if kind == "float":
            return ("lit", float(text))
        if kind == "string":
            return ("lit", _unescape(text[1:-1]))
        if kind == "ident":
            if text == "true":
                return ("lit", True)
            if text == "false":
                return ("lit", False)
            if text == "null":
                return ("lit", None)
            if text == "in":
                raise CelCompileError("misplaced 'in'")
            if self.peek()[1] == "(":
                if text not in _CEL_FUNCS:
                    raise CelCompileError(f"unknown function {text!r}")
                self.next()
                args = []
                while self.peek()[1] != ")":
                    args.append(self.parse_ternary())
                    if self.peek()[1] not in (",", ")"):
                        raise CelCompileError(
                            f"expected ',' or ')' in {text}() arguments"
                        )
                    if self.peek()[1] == ",":
                        self.next()
                self.expect(")")
                # arity/shape checked at COMPILE time; a literal argument
                # parses eagerly (bad literals are schema-write errors,
                # not first-check errors) and folds to its host value —
                # the device lowering declines the folded literal the
                # same way it declines the call
                if len(args) != 1:
                    raise CelCompileError(
                        f"{text}() takes one string argument"
                    )
                if args[0][0] == "lit":
                    v = args[0][1]
                    if not isinstance(v, str):
                        raise CelCompileError(
                            f"{text}() takes one string argument"
                        )
                    return ("lit", (
                        parse_timestamp(v) if text == "timestamp"
                        else parse_duration(v)
                    ))
                return ("call", text, args)
            return ("var", text)
        raise CelCompileError(f"unexpected token {text!r}")


_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "v": "\v",
    "0": "\0", "\\": "\\", '"': '"', "'": "'", "`": "`", "?": "?",
}


def _unescape(body: str) -> str:
    """Decode CEL string escapes (\\n, \\t, \\uXXXX, \\xXX, ...)."""
    out = []
    i = 0
    n = len(body)
    while i < n:
        ch = body[i]
        if ch != "\\" or i + 1 >= n:
            out.append(ch)
            i += 1
            continue
        esc = body[i + 1]
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc == "u" and i + 5 < n + 1:
            out.append(chr(int(body[i + 2 : i + 6], 16)))
            i += 6
        elif esc == "x" and i + 3 < n + 1:
            out.append(chr(int(body[i + 2 : i + 4], 16)))
            i += 4
        else:
            raise CelCompileError(f"unsupported string escape \\{esc}")
    return "".join(out)


def _is_unknown(v: Any) -> bool:
    return v is UNKNOWN


def _truthy(v: Any):
    if _is_unknown(v):
        return UNKNOWN
    if isinstance(v, bool):
        return v
    raise CelCompileError(f"non-boolean used as condition: {v!r}")


@dataclass(frozen=True)
class CelProgram:
    """A compiled caveat expression: AST + declared params."""

    name: str
    params: Mapping[str, str]
    ast: Any
    source: str

    def referenced_vars(self) -> List[str]:
        out: List[str] = []

        def walk(node) -> None:
            op = node[0]
            if op == "var":
                out.append(node[1])
            elif op == "lit":
                pass
            elif op == "member":
                walk(node[1])
            elif op in ("not", "neg"):
                walk(node[1])
            elif op in ("or", "and", "in"):
                walk(node[1]); walk(node[2])
            elif op == "cmp" or op == "arith":
                walk(node[2]); walk(node[3])
            elif op == "cond":
                walk(node[1]); walk(node[2]); walk(node[3])
            elif op == "list":
                for it in node[1]:
                    walk(it)
            elif op == "call":
                for a in node[2]:
                    walk(a)

        walk(self.ast)
        return out

    # -- host evaluation ---------------------------------------------------
    @cached_property
    def _timed_params(self) -> Mapping[str, str]:
        """Params declared timestamp/duration, computed once per program
        (host evaluation runs per caveated edge per check)."""
        return {
            n: t.split("<", 1)[0] for n, t in self.params.items()
            if t.split("<", 1)[0] in ("timestamp", "duration")
        }

    def _coerced(self, context: Mapping[str, Any]) -> Mapping[str, Any]:
        """Coerce context values of params DECLARED timestamp/duration
        into the comparable host types: RFC 3339 / Go-duration strings,
        datetimes, or numeric seconds."""
        timed = self._timed_params
        need = [
            n for n in timed
            if context.get(n) is not None
            and not isinstance(context[n], _TimeValue)
        ]
        if not need:
            return context
        out = dict(context)
        for n in need:
            base = timed[n]
            v = out[n]
            if base == "timestamp":
                if isinstance(v, _dt.datetime):
                    out[n] = Timestamp(round(v.timestamp() * 1_000_000))
                elif isinstance(v, str):
                    out[n] = parse_timestamp(v)
                # bool is an int subtype but a True/False "timestamp"
                # is garbage — ERROR, never coerce to a grantable epoch
                elif isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[n] = Timestamp(round(v * 1_000_000))
                else:
                    raise CelCompileError(
                        f"caveat {self.name!r}: cannot coerce {v!r} to"
                        " timestamp"
                    )
            else:
                if isinstance(v, _dt.timedelta):
                    out[n] = Duration(round(v.total_seconds() * 1_000_000))
                elif isinstance(v, str):
                    out[n] = parse_duration(v)
                elif isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[n] = Duration(round(v * 1_000_000))
                else:
                    raise CelCompileError(
                        f"caveat {self.name!r}: cannot coerce {v!r} to"
                        " duration"
                    )
        return out

    def evaluate(self, context: Mapping[str, Any]):
        """Evaluate against a merged context.  Returns True / False /
        UNKNOWN (missing context parameter somewhere it mattered)."""
        result = self._eval(self.ast, self._coerced(context))
        if _is_unknown(result):
            return UNKNOWN
        if not isinstance(result, bool):
            raise CelCompileError(
                f"caveat {self.name!r} evaluated to non-boolean {result!r}"
            )
        return result

    def _eval(self, node, ctx: Mapping[str, Any]):
        op = node[0]
        if op == "lit":
            return node[1]
        if op == "var":
            if node[1] in ctx:
                return ctx[node[1]]
            return UNKNOWN
        if op == "member":
            base = self._eval(node[1], ctx)
            if _is_unknown(base):
                return UNKNOWN
            if isinstance(base, Mapping) and node[2] in base:
                return base[node[2]]
            return UNKNOWN
        if op == "list":
            items = [self._eval(it, ctx) for it in node[1]]
            return UNKNOWN if any(_is_unknown(i) for i in items) else items
        if op == "not":
            v = _truthy(self._eval(node[1], ctx))
            return UNKNOWN if _is_unknown(v) else (not v)
        if op == "neg":
            v = self._eval(node[1], ctx)
            return UNKNOWN if _is_unknown(v) else -v
        if op == "or":
            a = _truthy(self._eval(node[1], ctx))
            if a is True:
                return True
            b = _truthy(self._eval(node[2], ctx))
            if b is True:
                return True
            if _is_unknown(a) or _is_unknown(b):
                return UNKNOWN
            return False
        if op == "and":
            a = _truthy(self._eval(node[1], ctx))
            if a is False:
                return False
            b = _truthy(self._eval(node[2], ctx))
            if b is False:
                return False
            if _is_unknown(a) or _is_unknown(b):
                return UNKNOWN
            return True
        if op == "cond":
            c = _truthy(self._eval(node[1], ctx))
            if _is_unknown(c):
                return UNKNOWN
            return self._eval(node[2] if c else node[3], ctx)
        if op == "cmp":
            a = self._eval(node[2], ctx)
            b = self._eval(node[3], ctx)
            if _is_unknown(a) or _is_unknown(b):
                return UNKNOWN
            o = node[1]
            try:
                if o == "==":
                    return a == b
                if o == "!=":
                    return a != b
                if o == "<":
                    return a < b
                if o == "<=":
                    return a <= b
                if o == ">":
                    return a > b
                return a >= b
            except TypeError as e:
                raise CelCompileError(f"type error in caveat {self.name!r}: {e}") from e
        if op == "arith":
            a = self._eval(node[2], ctx)
            b = self._eval(node[3], ctx)
            if _is_unknown(a) or _is_unknown(b):
                return UNKNOWN
            o = node[1]
            try:
                if o == "+":
                    return a + b
                if o == "-":
                    return a - b
                if o == "*":
                    return a * b
                if o == "/":
                    # CEL int division truncates toward zero
                    if isinstance(a, int) and isinstance(b, int):
                        q = abs(a) // abs(b)
                        return q if (a >= 0) == (b >= 0) else -q
                    return a / b
                # CEL '%' is the truncated remainder (sign of the dividend),
                # not Python's floored remainder — must match the device
                # lowering (device.py emit_ar) for negative operands
                if isinstance(a, int) and isinstance(b, int):
                    q = abs(a) // abs(b)
                    q = q if (a >= 0) == (b >= 0) else -q
                    return a - q * b
                return a % b
            except (TypeError, ZeroDivisionError) as e:
                raise CelCompileError(f"arithmetic error in caveat {self.name!r}: {e}") from e
        if op == "in":
            a = self._eval(node[1], ctx)
            b = self._eval(node[2], ctx)
            if _is_unknown(a) or _is_unknown(b):
                return UNKNOWN
            if not isinstance(b, (list, tuple, set, frozenset, str, Mapping)):
                raise CelCompileError(f"'in' target not a collection in {self.name!r}")
            return a in b
        if op == "call":
            args = [self._eval(a, ctx) for a in node[2]]
            if any(_is_unknown(a) for a in args):
                return UNKNOWN
            if len(args) != 1 or not isinstance(args[0], str):
                raise CelCompileError(
                    f"{node[1]}() takes one string argument in {self.name!r}"
                )
            return (
                parse_timestamp(args[0]) if node[1] == "timestamp"
                else parse_duration(args[0])
            )
        raise CelCompileError(f"unknown node {op!r}")


def compile_cel(name: str, params: Mapping[str, str], source: str) -> CelProgram:
    """Compile a caveat body.  Unknown parameter types and references to
    undeclared identifiers are rejected at schema-write time."""
    for pname, ptype in params.items():
        base = ptype.split("<", 1)[0]
        if base not in CelType.KNOWN:
            raise CelCompileError(f"caveat {name!r}: unknown parameter type {ptype!r}")
    ast = _CelParser(source).parse()
    prog = CelProgram(name=name, params=dict(params), ast=ast, source=source)
    for var in prog.referenced_vars():
        if var not in params:
            raise CelCompileError(
                f"caveat {name!r} references undeclared identifier {var!r}"
            )
    return prog
