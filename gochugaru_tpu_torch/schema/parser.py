"""Recursive-descent parser for the SpiceDB schema language subset.

Grammar (whitespace/comments insignificant; ``//`` and ``/* */`` comments):

    schema      := (use | caveat | definition)*
    use         := 'use' identifier
    caveat      := 'caveat' qname '(' [param (',' param)*] ')' '{' cel '}'
    param       := identifier type_name
    definition  := 'definition' qname '{' (relation | permission)* '}'
    relation    := 'relation' identifier ':' allowed ('|' allowed)*
    allowed     := qname (':*' | '#' identifier)? ('with' trait ('and' trait)*)?
    trait       := 'expiration' | qname           -- caveat name
    permission  := 'permission' identifier '=' expr
    expr        := term (op term)*                -- op ∈ {+, -, &}, left-assoc,
                                                     equal precedence
    term        := '(' expr ')' | 'nil' | operand
    operand     := identifier ('->' identifier)?  -- single arrow, LHS a relation

Chained arrows (``a->b->c``) are rejected, as SpiceDB requires an
intermediate permission.  ``use`` statements (e.g. ``use expiration``) are
accepted and ignored.  Caveat bodies are raw CEL text captured between
balanced braces and compiled separately by ``gochugaru_tpu.caveats``.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple

from .ast import (
    AllowedSubject,
    Arrow,
    CaveatDecl,
    Definition,
    Exclusion,
    Expr,
    Intersection,
    Nil,
    Permission,
    Relation,
    RelationRef,
    Schema,
    Union,
)


class SchemaParseError(ValueError):
    def __init__(self, message: str, line: int = 0) -> None:
        super().__init__(f"schema parse error at line {line}: {message}" if line else message)
        self.line = line


class _Tok(NamedTuple):
    kind: str  # ident, punct, other, eof
    text: str
    line: int
    offset: int


_TOKEN_RE = re.compile(
    r"""
      (?P<comment>//[^\n]*|/\*.*?\*/)
    | (?P<ws>\s+)
    | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:/[A-Za-z_][A-Za-z0-9_]*)*)
    | (?P<punct>->|:\*|[{}():#|+\-&=,])
    | (?P<other>.)
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str) -> List[_Tok]:
    """Tokenize schema source.  Characters outside the schema grammar (CEL
    numbers, comparison operators, strings…) become ``other`` tokens — legal
    only inside caveat bodies, which are re-scanned raw by offset."""
    toks: List[_Tok] = []
    pos = 0
    line = 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        assert m is not None  # the 'other' branch matches any character
        tok_line = line
        line += text[pos : m.end()].count("\n")
        kind = m.lastgroup
        if kind in ("ident", "punct"):
            toks.append(_Tok(kind, m.group(), tok_line, pos))
        elif kind in ("string", "other"):
            toks.append(_Tok("other", m.group(), tok_line, pos))
        pos = m.end()
    return toks


class _Parser:
    def __init__(self, text: str) -> None:
        self.text = text
        self.toks = _tokenize(text)
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self) -> _Tok:
        if self.i < len(self.toks):
            return self.toks[self.i]
        return _Tok("eof", "", self.toks[-1].line if self.toks else 0, len(self.text))

    def next(self) -> _Tok:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, text: str) -> _Tok:
        t = self.next()
        if t.text != text:
            raise SchemaParseError(f"expected {text!r}, got {t.text!r}", t.line)
        return t

    def expect_ident(self, what: str = "identifier") -> _Tok:
        t = self.next()
        if t.kind != "ident":
            raise SchemaParseError(f"expected {what}, got {t.text!r}", t.line)
        return t

    # -- grammar -----------------------------------------------------------
    def parse(self) -> Schema:
        schema = Schema(text=self.text)
        while self.peek().kind != "eof":
            t = self.peek()
            if t.text == "definition":
                d = self.parse_definition()
                if d.name in schema.definitions:
                    raise SchemaParseError(f"duplicate definition {d.name!r}", t.line)
                schema.definitions[d.name] = d
            elif t.text == "caveat":
                c = self.parse_caveat()
                if c.name in schema.caveats:
                    raise SchemaParseError(f"duplicate caveat {c.name!r}", t.line)
                schema.caveats[c.name] = c
            elif t.text == "use":
                self.next()
                self.expect_ident("feature name")
            else:
                raise SchemaParseError(
                    f"expected 'definition', 'caveat', or 'use', got {t.text!r}", t.line
                )
        return schema

    def parse_definition(self) -> Definition:
        self.expect("definition")
        name = self.expect_ident("definition name").text
        d = Definition(name=name)
        self.expect("{")
        while self.peek().text != "}":
            t = self.peek()
            if t.text == "relation":
                r = self.parse_relation()
                if d.item(r.name) is not None:
                    raise SchemaParseError(f"duplicate item {r.name!r} in {name}", t.line)
                d.relations[r.name] = r
            elif t.text == "permission":
                p = self.parse_permission()
                if d.item(p.name) is not None:
                    raise SchemaParseError(f"duplicate item {p.name!r} in {name}", t.line)
                d.permissions[p.name] = p
            else:
                raise SchemaParseError(
                    f"expected 'relation' or 'permission', got {t.text!r}", t.line
                )
        self.expect("}")
        return d

    def parse_relation(self) -> Relation:
        self.expect("relation")
        name = self.expect_ident("relation name").text
        self.expect(":")
        allowed = [self.parse_allowed()]
        while self.peek().text == "|":
            self.next()
            allowed.append(self.parse_allowed())
        return Relation(name=name, allowed=allowed)

    def parse_allowed(self) -> AllowedSubject:
        typ = self.expect_ident("subject type").text
        relation = ""
        wildcard = False
        if self.peek().text == ":*":
            self.next()
            wildcard = True
        elif self.peek().text == "#":
            self.next()
            relation = self.expect_ident("subject relation").text
        caveat = ""
        expiration = False
        if self.peek().text == "with":
            self.next()
            while True:
                trait = self.expect_ident("caveat name or 'expiration'").text
                if trait == "expiration":
                    expiration = True
                else:
                    if caveat:
                        raise SchemaParseError(
                            f"multiple caveats on one allowed subject: {caveat!r}, {trait!r}",
                            self.peek().line,
                        )
                    caveat = trait
                if self.peek().text == "and":
                    self.next()
                    continue
                break
        return AllowedSubject(
            type=typ, relation=relation, wildcard=wildcard, caveat=caveat, expiration=expiration
        )

    def parse_permission(self) -> Permission:
        self.expect("permission")
        name = self.expect_ident("permission name").text
        self.expect("=")
        return Permission(name=name, expr=self.parse_expr())

    def parse_expr(self) -> Expr:
        left = self.parse_term()
        while True:
            op = self.peek().text
            if op == "+":
                self.next()
                right = self.parse_term()
                if isinstance(left, Union):
                    left = Union(left.children + (right,))
                else:
                    left = Union((left, right))
            elif op == "&":
                self.next()
                right = self.parse_term()
                if isinstance(left, Intersection):
                    left = Intersection(left.children + (right,))
                else:
                    left = Intersection((left, right))
            elif op == "-":
                self.next()
                left = Exclusion(base=left, subtracted=self.parse_term())
            else:
                return left

    def parse_term(self) -> Expr:
        t = self.peek()
        if t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.text == "nil":
            self.next()
            return Nil()
        ident = self.expect_ident("relation or permission name").text
        if self.peek().text == "->":
            self.next()
            right = self.expect_ident("arrow target").text
            if self.peek().text == "->":
                raise SchemaParseError(
                    "chained arrows are not supported; introduce an intermediate permission",
                    self.peek().line,
                )
            return Arrow(left=ident, right=right)
        return RelationRef(name=ident)

    # -- caveats -----------------------------------------------------------
    def parse_caveat(self) -> CaveatDecl:
        self.expect("caveat")
        name = self.expect_ident("caveat name").text
        self.expect("(")
        params = {}
        while self.peek().text != ")":
            pname = self.expect_ident("parameter name").text
            ptype = self.expect_ident("parameter type").text
            # generic types: list<int>, map<string>, nested generics
            if self.peek().text == "<":
                depth = 0
                while True:
                    t = self.next()
                    ptype += t.text
                    if t.text == "<":
                        depth += 1
                    elif t.text == ">":
                        depth -= 1
                        if depth == 0:
                            break
                    if t.kind == "eof":
                        raise SchemaParseError(
                            f"unterminated generic type for parameter {pname!r}",
                            t.line,
                        )
            if pname in params:
                raise SchemaParseError(f"duplicate caveat parameter {pname!r}", self.peek().line)
            params[pname] = ptype
            if self.peek().text == ",":
                self.next()
        self.expect(")")
        body = self._raw_braced_body()
        return CaveatDecl(name=name, params=params, expression=body.strip())

    def _raw_braced_body(self) -> str:
        """Capture the raw source between balanced braces starting at the
        next token (which must be '{'), and advance the token index past the
        closing '}'.  Used for caveat bodies, whose CEL content is outside
        the schema token set."""
        open_tok = self.expect("{")
        start = open_tok.offset
        depth = 0
        j = start
        n = len(self.text)
        while j < n:
            ch = self.text[j]
            if ch in "\"'":
                # skip string literals — braces inside them don't count
                quote = ch
                j += 1
                while j < n and self.text[j] != quote:
                    j += 2 if self.text[j] == "\\" else 1
                if j >= n:
                    raise SchemaParseError("unterminated string in caveat body", open_tok.line)
            elif ch == "/" and j + 1 < n and self.text[j + 1] == "/":
                while j < n and self.text[j] != "\n":
                    j += 1
                continue
            elif ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    body = self.text[start + 1 : j]
                    while self.i < len(self.toks) and self.toks[self.i].offset <= j:
                        self.i += 1
                    return body
            j += 1
        raise SchemaParseError("unterminated caveat body", open_tok.line)


def parse_schema(text: str) -> Schema:
    """Parse schema source text into an AST.

    Raises SchemaParseError on malformed input — the local analogue of the
    server rejecting WriteSchema (client/client.go:424-434).
    """
    return _Parser(text).parse()
