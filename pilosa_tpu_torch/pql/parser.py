"""Recursive-descent PQL parser.

Implements the grammar in the reference's pql/pql.peg (84 lines) without a
parser generator. Ordered-choice semantics are kept where they matter:
special call forms (Set/SetRowAttrs/.../Range) are tried first and fall
back to the generic ``IDENT(allargs)`` rule, exactly like PEG backtracking.
"""

from __future__ import annotations

import re
from typing import Any, Callable, NoReturn

from pilosa_tpu_torch.pql.ast import (
    BETWEEN, EQ, GT, GTE, LT, LTE, NEQ, Call, Condition, Query,
)


class ParseError(Exception):
    def __init__(self, msg: str, pos: int = -1) -> None:
        super().__init__(f"parse error at {pos}: {msg}" if pos >= 0 else msg)
        self.pos = pos


class SemanticError(ParseError):
    """A definitive error (e.g. duplicate argument) that backtracking must
    not swallow — PEG ordered choice only retries on *syntax* failure."""


_IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")
_FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_RESERVED_RE = re.compile(r"_row|_col|_start|_end|_timestamp|_field")
_UINT_RE = re.compile(r"0|[1-9][0-9]*")
_INT_RE = re.compile(r"-?(?:0|[1-9][0-9]*)")
_NUM_RE = re.compile(r"-?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)")
_TIMESTAMP_RE = re.compile(r"[0-9]{4}-[01][0-9]-[0-3][0-9]T[0-9]{2}:[0-9]{2}")
_BARESTR_RE = re.compile(r"[A-Za-z0-9\-_:]+")
_COND_RE = re.compile(r"><|<=|>=|==|!=|<|>")
_COND_OPS = {"><": BETWEEN, "<=": LTE, ">=": GTE, "==": EQ, "!=": NEQ,
             "<": LT, ">": GT}

DUPLICATE_ARG_ERROR = "duplicate argument provided"


class _Parser:
    def __init__(self, src: str) -> None:
        self.src = src
        self.pos = 0

    # -- low-level ---------------------------------------------------------

    def error(self, msg: str) -> NoReturn:
        raise ParseError(msg, self.pos)

    def eof(self) -> bool:
        return self.pos >= len(self.src)

    def peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def sp(self) -> None:
        while self.pos < len(self.src) and self.src[self.pos] in " \t\n\r":
            self.pos += 1

    def lit(self, s: str) -> bool:
        if self.src.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def expect(self, s: str) -> None:
        if not self.lit(s):
            self.error(f"expected {s!r}")

    def rx(self, pattern: re.Pattern[str]) -> str | None:
        m = pattern.match(self.src, self.pos)
        if m is None:
            return None
        self.pos = m.end()
        return m.group(0)

    def comma(self) -> bool:
        save = self.pos
        self.sp()
        if self.lit(","):
            self.sp()
            return True
        self.pos = save
        return False

    def open(self) -> None:
        self.expect("(")
        self.sp()

    def close(self) -> None:
        self.sp()
        self.expect(")")

    def _quoted(self, quote: str) -> str:
        """Body of a quoted string with backslash escapes."""
        out = []
        while True:
            c = self.peek()
            if c == "":
                self.error("unterminated string")
            if c == "\\":
                nxt = self.src[self.pos + 1 : self.pos + 2]
                if nxt in (quote, "\\"):
                    out.append(nxt)
                    self.pos += 2
                    continue
            if c == quote:
                self.pos += 1
                return "".join(out)
            out.append(c)
            self.pos += 1

    # -- grammar -----------------------------------------------------------

    def parse(self) -> Query:
        q = Query()
        self.sp()
        while not self.eof():
            q.calls.append(self.call())
            self.sp()
        return q

    def call(self) -> Call:
        save = self.pos
        name = self.rx(_IDENT_RE)
        if name is None:
            self.error("expected call name")
        special: Callable[[], Call] | None = getattr(
            self, f"_call_{name}", None)
        if special is not None:
            try:
                return special()
            except SemanticError:
                raise
            except ParseError:
                self.pos = save + len(name)  # fall back to generic form
        return self._call_generic(name)

    def _call_generic(self, name: str) -> Call:
        call = Call(name)
        self.open()
        self.allargs(call)
        self.comma()  # optional trailing comma
        self.close()
        return call

    # - special forms (ordered before generic, as in the PEG) -

    def _call_Set(self) -> Call:
        call = Call("Set")
        self.open()
        self._pos_col(call)
        if not self.comma():
            self.error("expected ','")
        self.args(call)
        if self.comma():
            ts = self._timestampfmt()
            if ts is None:
                self.error("expected timestamp")
            call.args["_timestamp"] = ts
        self.close()
        return call

    def _call_SetRowAttrs(self) -> Call:
        call = Call("SetRowAttrs")
        self.open()
        f = self.rx(_FIELD_RE)
        if f is None:
            self.error("expected field")
        call.args["_field"] = f
        if not self.comma():
            self.error("expected ','")
        self._pos_row(call)
        if not self.comma():
            self.error("expected ','")
        self.args(call)
        self.close()
        return call

    def _call_SetColumnAttrs(self) -> Call:
        call = Call("SetColumnAttrs")
        self.open()
        self._pos_col(call)
        if not self.comma():
            self.error("expected ','")
        self.args(call)
        self.close()
        return call

    def _call_Clear(self) -> Call:
        call = Call("Clear")
        self.open()
        self._pos_col(call)
        if not self.comma():
            self.error("expected ','")
        self.args(call)
        self.close()
        return call

    def _call_ClearRow(self) -> Call:
        call = Call("ClearRow")
        self.open()
        self.arg(call)
        self.close()
        return call

    def _call_Store(self) -> Call:
        call = Call("Store")
        self.open()
        call.children.append(self.call())
        if not self.comma():
            self.error("expected ','")
        self.arg(call)
        self.close()
        return call

    def _call_TopN(self) -> Call:
        return self._posfield_call("TopN")

    def _call_SimilarTopN(self) -> Call:
        return self._posfield_call("SimilarTopN")

    def _call_Rows(self) -> Call:
        return self._posfield_call("Rows")

    def _posfield_call(self, name: str) -> Call:
        call = Call(name)
        self.open()
        f = self.rx(_FIELD_RE)
        if f is None:
            self.error("expected field")
        call.args["_field"] = f
        if self.comma():
            self.allargs(call)
        self.close()
        return call

    def _call_Range(self) -> Call:
        """Time-range form: Range(f=1, from=ts, to=ts). The condition form
        Range(f > 5) backtracks to the generic rule."""
        call = Call("Range")
        self.open()
        f = self.rx(_FIELD_RE) or self.rx(_RESERVED_RE)
        if f is None:
            self.error("expected field")
        self.sp()
        self.expect("=")
        self.sp()
        call.args[f] = self.value()
        if not self.comma():
            self.error("expected ','")
        self.lit("from=")
        ts = self._timestampfmt()
        if ts is None:
            self.error("expected timestamp")
        call.args["from"] = ts
        if not self.comma():
            self.error("expected ','")
        self.lit("to=")
        self.sp()
        ts = self._timestampfmt()
        if ts is None:
            self.error("expected timestamp")
        call.args["to"] = ts
        self.close()
        return call

    # - positional helpers -

    def _pos_col(self, call: Call) -> None:
        self._pos_arg(call, "_col")

    def _pos_row(self, call: Call) -> None:
        self._pos_arg(call, "_row")

    def _pos_arg(self, call: Call, key: str) -> None:
        u = self.rx(_UINT_RE)
        if u is not None:
            call.args[key] = int(u)
            return
        if self.lit("'"):
            call.args[key] = self._quoted("'")
            return
        if self.lit('"'):
            call.args[key] = self._quoted('"')
            return
        self.error(f"expected {key}")

    def _timestampfmt(self) -> str | None:
        save = self.pos
        if self.lit('"'):
            ts = self.rx(_TIMESTAMP_RE)
            if ts is not None and self.lit('"'):
                return ts
            self.pos = save
            return None
        if self.lit("'"):
            ts = self.rx(_TIMESTAMP_RE)
            if ts is not None and self.lit("'"):
                return ts
            self.pos = save
            return None
        return self.rx(_TIMESTAMP_RE)

    # - args -

    def allargs(self, call: Call) -> None:
        """allargs <- Call (comma Call)* (comma args)? / args / sp"""
        save = self.pos
        m = _IDENT_RE.match(self.src, self.pos)
        if m is not None:
            # A child call iff the ident is followed by '(' — otherwise it's
            # an arg key (e.g. `field=...`) or bare value.
            after = self.src[m.end() : m.end() + 1]
            look = m.end()
            while after in (" ", "\t", "\n"):
                look += 1
                after = self.src[look : look + 1]
            if after == "(":
                call.children.append(self.call())
                while True:
                    save2 = self.pos
                    if not self.comma():
                        return
                    m2 = _IDENT_RE.match(self.src, self.pos)
                    is_call = False
                    if m2 is not None:
                        look = m2.end()
                        nxt = self.src[look : look + 1]
                        while nxt in (" ", "\t", "\n"):
                            look += 1
                            nxt = self.src[look : look + 1]
                        is_call = nxt == "("
                    if is_call:
                        call.children.append(self.call())
                    else:
                        self.pos = save2
                        if self.comma():
                            self.sp()
                            if self.peek() in (")", ""):
                                self.pos = save2  # trailing comma: caller's
                            else:
                                self.args(call)
                        return
        self.pos = save
        self.sp()
        if self.peek() not in (")", ""):
            self.args(call)

    def args(self, call: Call) -> None:
        """args <- arg (comma args)? sp"""
        self.arg(call)
        while True:
            save = self.pos
            if not self.comma():
                break
            self.sp()
            if self.peek() in (")", ""):
                self.pos = save
                break
            # Trailing comma before close is handled by caller.
            try:
                self.arg(call)
            except SemanticError:
                raise
            except ParseError:
                self.pos = save
                break
        self.sp()

    def arg(self, call: Call) -> None:
        # conditional: int <(=) field <(=) int
        save = self.pos
        cond = self._try_conditional()
        if cond is not None:
            field, c = cond
            self._set_arg(call, field, c)
            return
        self.pos = save
        field = self.rx(_FIELD_RE) or self.rx(_RESERVED_RE)
        if field is None:
            self.error("expected argument")
        self.sp()
        if self.lit("="):
            # Guard against '==' which is a COND.
            if self.peek() == "=":
                self.pos -= 1
            else:
                self.sp()
                self._set_arg(call, field, self.value())
                return
        op = self.rx(_COND_RE)
        if op is None:
            self.error("expected '=' or comparison operator")
        self.sp()
        val = self.value()
        self._set_arg(call, field, Condition(_COND_OPS[op], val))

    def _try_conditional(self) -> tuple[str, Condition] | None:
        """conditional <- condint condLT condfield condLT condint
        e.g. ``4 < f <= 10`` → f: BETWEEN [5, 10] (bounds normalized
        inclusive, reference ast.go endConditional)."""
        lo_s = self.rx(_INT_RE)
        if lo_s is None:
            return None
        self.sp()
        op1 = "<=" if self.lit("<=") else ("<" if self.lit("<") else None)
        if op1 is None:
            return None
        self.sp()
        field = self.rx(_FIELD_RE)
        if field is None:
            return None
        self.sp()
        op2 = "<=" if self.lit("<=") else ("<" if self.lit("<") else None)
        if op2 is None:
            return None
        self.sp()
        hi_s = self.rx(_INT_RE)
        if hi_s is None:
            return None
        self.sp()
        low, high = int(lo_s), int(hi_s)
        if op1 == "<":
            low += 1
        if op2 == "<":
            high -= 1
        return field, Condition(BETWEEN, [low, high])

    def _set_arg(self, call: Call, key: str, value: Any) -> None:
        if key in call.args:
            raise SemanticError(f"{DUPLICATE_ARG_ERROR}: {key}", self.pos)
        call.args[key] = value

    # - values -

    def value(self) -> Any:
        if self.lit("["):
            self.sp()
            items: list[Any] = []
            self.sp()
            if not self.src.startswith("]", self.pos):
                items.append(self.item())
                while self.comma():
                    items.append(self.item())
            self.sp()
            self.expect("]")
            self.sp()
            return items
        return self.item()

    def _at_item_boundary(self) -> bool:
        save = self.pos
        self.sp()
        c = self.peek()
        self.pos = save
        return c in (",", ")", "]", "")

    def item(self) -> Any:
        # Keyword literals, only when followed by a boundary.
        for kw, val in (("null", None), ("true", True), ("false", False)):
            if self.src.startswith(kw, self.pos):
                save = self.pos
                self.pos += len(kw)
                if self._at_item_boundary():
                    return val
                self.pos = save
        ts = self._timestampfmt()
        if ts is not None:
            return ts
        num = self.rx(_NUM_RE)
        if num is not None:
            # Bare strings like 1-2-3 must not half-match as a number.
            if self.peek() not in "" and _BARESTR_RE.match(self.peek()):
                self.pos -= len(num)
            else:
                return float(num) if "." in num else int(num)
        # Nested call?
        m = _IDENT_RE.match(self.src, self.pos)
        if m is not None:
            look = m.end()
            nxt = self.src[look : look + 1]
            while nxt in (" ", "\t", "\n"):
                look += 1
                nxt = self.src[look : look + 1]
            if nxt == "(":
                return self.call()
        bare = self.rx(_BARESTR_RE)
        if bare is not None:
            return bare
        if self.lit('"'):
            return self._quoted('"')
        if self.lit("'"):
            return self._quoted("'")
        self.error("expected value")  # noqa: RET503 - error() is NoReturn


def parse(src: str) -> Query:
    """Parse a PQL string into a Query (reference pql.NewParser(...).Parse())."""
    return _Parser(src).parse()
