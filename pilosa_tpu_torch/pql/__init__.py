"""PQL — the Pilosa Query Language.

Reference: pql/ (grammar pql/pql.peg, AST pql/ast.go, generated PEG parser
pql/pql.peg.go). Here the grammar is implemented as a hand-written
tokenizer + recursive-descent parser (parser.py) producing the same Call
tree shape (ast.py); there is no code generation step.
"""

from pilosa_tpu_torch.pql.ast import (
    BETWEEN,
    EQ,
    GT,
    GTE,
    LT,
    LTE,
    NEQ,
    Call,
    Condition,
    Query,
    is_reserved_arg,
)
from pilosa_tpu_torch.pql.parser import ParseError, parse

__all__ = [
    "BETWEEN", "EQ", "GT", "GTE", "LT", "LTE", "NEQ",
    "Call", "Condition", "Query", "is_reserved_arg",
    "ParseError", "parse",
]
