"""PQL AST: Query → Call tree with typed args.

Reference: pql/ast.go (Query :27, Call :263, Condition :482, token ops
pql/token.go). Values in ``Call.args`` are Python natives: int, float,
bool, None, str, list, nested ``Call``, or ``Condition``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Condition operator tokens (reference pql/token.go ILLEGAL..BETWEEN).
EQ = "=="
NEQ = "!="
LT = "<"
LTE = "<="
GT = ">"
GTE = ">="
BETWEEN = "><"

#: the reference's writeCallN set (ast.go) — kept for its exact parity.
_WRITE_CALLS = frozenset({"Set", "Clear", "SetRowAttrs", "SetColumnAttrs"})
#: every call that mutates state, for cacheability decisions.
WRITE_CALLS = frozenset({"Set", "Clear", "ClearRow", "Store",
                         "SetRowAttrs", "SetColumnAttrs"})


def is_reserved_arg(name: str) -> bool:
    """Reference IsReservedArg (ast.go:283): leading '_' or from/to."""
    return name.startswith("_") or name in ("from", "to")


@dataclass
class Condition:
    """A comparison bound to an arg: ``field >< [1, 10]`` etc.
    Reference: pql/ast.go:482."""

    op: str
    value: Any

    def int_slice_value(self) -> list[int]:
        if not isinstance(self.value, list):
            raise ValueError(f"unexpected condition value {self.value!r}")
        return [int(v) for v in self.value]

    def __str__(self) -> str:
        return f"{self.op} {format_value(self.value)}"


@dataclass
class Call:
    """One function call. Reference: pql/ast.go:263."""

    name: str
    args: dict[str, Any] = field(default_factory=dict)
    children: list["Call"] = field(default_factory=list)

    # -- typed arg accessors (reference ast.go:270-460) --------------------

    def field_arg(self) -> str:
        """The single non-reserved arg key, e.g. the f in Set(1, f=2)."""
        for k in self.args:
            if not is_reserved_arg(k):
                return k
        raise ValueError("no field argument specified")

    def bool_arg(self, key: str) -> tuple[bool, bool]:
        if key not in self.args:
            return False, False
        v = self.args[key]
        if not isinstance(v, bool):
            raise ValueError(f"could not convert {v!r} to bool")
        return v, True

    def uint_arg(self, key: str) -> tuple[int, bool]:
        if key not in self.args:
            return 0, False
        v = self.args[key]
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"could not convert {v!r} to uint64")
        if v < 0:
            raise ValueError(f"value for '{key}' must be positive, but got {v}")
        return v, True

    def int_arg(self, key: str) -> tuple[int, bool]:
        if key not in self.args:
            return 0, False
        v = self.args[key]
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"could not convert {v!r} to int64")
        return v, True

    def uint_slice_arg(self, key: str) -> tuple[list[int] | None, bool]:
        if key not in self.args:
            return None, False
        v = self.args[key]
        if not isinstance(v, list):
            raise ValueError(f"unexpected type in uint_slice_arg: {v!r}")
        return [int(x) for x in v], True

    def call_arg(self, key: str) -> tuple["Call | None", bool]:
        if key not in self.args:
            return None, False
        v = self.args[key]
        if not isinstance(v, Call):
            raise ValueError(f"could not convert {v!r} to Call")
        return v, True

    def string_arg(self, key: str) -> tuple[str | None, bool]:
        if key not in self.args:
            return None, False
        v = self.args[key]
        if not isinstance(v, str):
            raise ValueError(f"could not convert {v!r} to string")
        return v, True

    def has_condition_arg(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def clone(self) -> "Call":
        # Deep-clone Call-valued args (and Calls nested inside list args):
        # translation rewrites arg values in place, so a shallow copy would
        # let one index's translated ids leak into the parse-cached tree.
        def _clone_val(v: Any) -> Any:
            if isinstance(v, Call):
                return v.clone()
            if isinstance(v, list):
                return [_clone_val(x) for x in v]
            if isinstance(v, Condition):
                return Condition(op=v.op, value=_clone_val(v.value))
            return v

        return Call(
            name=self.name,
            args={k: _clone_val(v) for k, v in self.args.items()},
            children=[c.clone() for c in self.children],
        )

    def __str__(self) -> str:
        parts = [str(c) for c in self.children]
        for key in sorted(self.args):
            v = self.args[key]
            if isinstance(v, Condition):
                parts.append(f"{key} {v}")
            else:
                parts.append(f"{key}={format_value(v)}")
        return f"{self.name or '!UNNAMED'}({', '.join(parts)})"


@dataclass
class Query:
    """A parsed PQL query: one or more top-level calls (ast.go:27)."""

    calls: list[Call] = field(default_factory=list)

    def write_call_n(self) -> int:
        return sum(1 for c in self.calls if c.name in _WRITE_CALLS)

    def has_writes(self) -> bool:
        """True if ANY call anywhere in the tree mutates state (writes
        can hide under wrappers like Options(...))."""
        def walk(c: "Call") -> bool:
            return c.name in WRITE_CALLS or any(walk(ch)
                                                for ch in c.children)
        return any(walk(c) for c in self.calls)

    def __str__(self) -> str:
        return "\n".join(str(c) for c in self.calls)


def format_value(v: Any) -> str:
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, list):
        return "[" + ",".join(format_value(x) for x in v) + "]"
    return str(v)
