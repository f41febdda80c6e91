"""Mirrors ``src/repro/core/ptx/__init__.py`` (only the imports differ)."""

from .ir import (  # noqa: F401
    Imm,
    Instr,
    Kernel,
    Label,
    LabelRef,
    MemRef,
    Module,
    Reg,
    SPECIAL_REGS,
    TYPE_WIDTH,
)
from .parser import parse, parse_instr, parse_kernel  # noqa: F401
from .printer import print_kernel, print_module  # noqa: F401
