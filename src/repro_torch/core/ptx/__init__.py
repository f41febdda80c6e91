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
