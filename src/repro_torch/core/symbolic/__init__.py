"""Mirrors ``src/repro/core/symbolic/__init__.py`` (unchanged)."""

from .terms import (  # noqa: F401
    Atom,
    BoolConst,
    BoolExpr,
    BoolOp,
    Cmp,
    FALSE,
    Sym,
    Term,
    TRUE,
    UF,
    bool_and,
    bool_not,
    bool_or,
    bool_xor,
    to_signed,
)
from .solver import AssumptionSet, may_alias, solve_shift  # noqa: F401
