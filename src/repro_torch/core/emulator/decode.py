"""Mirrors ``src/repro/core/emulator/decode.py`` (only the imports differ).

One-shot instruction pre-decoding shared by both emulators.

``Instr`` stores its opcode as a dotted string; historically every
emulator step re-split it (``instr.parts``), re-scanned for the type
suffix, and re-derived modifier sets — per flow per step in the symbolic
emulator and per thread per step in the concrete one.  ``decode_kernel``
does that work exactly once per kernel: each statement becomes a slotted
:class:`Decoded` micro-op carrying an integer opcode kind plus every
derived field the hot loops need (operand layout, width, memory space,
comparison modifiers, branch target), so the interpreters dispatch on an
int and read attributes instead of parsing strings.

The ``kind`` classification mirrors the symbolic emulator's dispatch
order; the concrete emulator consumes the same decoded fields but keeps
its own (slightly different) float/int split, so it reads ``base``/
``tsuf`` off the micro-op rather than re-deriving them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..ptx.ir import Instr, Kernel, Label, LabelRef, TYPE_WIDTH

# opcode kinds, in the symbolic emulator's historical dispatch order
K_LABEL = 0
K_BRA = 1
K_RET = 2          # ret / exit
K_LD = 3
K_ST = 4
K_MOV = 5
K_SETP = 6
K_SELP = 7
K_CVTA = 8
K_CVT = 9
K_PREDLOGIC = 10   # and/or/xor/not over .pred registers
K_FLOAT = 11
K_INT = 12
K_SHFL = 13
K_ACTIVEMASK = 14
K_BARRIER = 15     # bar / membar / fence
K_OTHER = 16

INT_TYPES = {"b8", "b16", "b32", "b64", "s8", "s16", "s32", "s64",
             "u8", "u16", "u32", "u64"}
FLOAT_TYPES = {"f16", "f32", "f64"}

CMP_MAP = {
    # signed / generic
    "eq": ("eq", True), "ne": ("ne", True),
    "lt": ("lt", True), "le": ("le", True),
    "gt": ("gt", True), "ge": ("ge", True),
    # unsigned
    "lo": ("lt", False), "ls": ("le", False),
    "hi": ("gt", False), "hs": ("ge", False),
    "ltu": ("lt", False), "leu": ("le", False),
    "gtu": ("gt", False), "geu": ("ge", False),
    "equ": ("eq", False), "neu": ("ne", False),
}

_FLOAT_BASES = {"add", "sub", "mul", "div", "fma", "mad", "neg", "abs",
                "min", "max", "sqrt", "rsqrt", "rcp", "sin", "cos", "lg2",
                "ex2", "tanh", "copysign"}
_INT_BASES = {"add", "sub", "mul", "mad", "div", "rem", "min", "max",
              "neg", "abs", "shl", "shr", "and", "or", "xor", "not",
              "popc", "clz", "brev", "bfind"}
_INT_UNARY = {"neg", "abs", "not", "popc", "clz", "brev", "bfind"}
_LD_SPACES = ("param", "global", "shared", "local", "const")
_ST_SPACES = ("global", "shared", "local")
_SHFL_MODES = ("up", "down", "bfly", "idx")


class Decoded:
    """One pre-decoded statement (micro-op)."""

    __slots__ = (
        "kind", "instr", "uid", "base", "parts", "tsuf", "width", "pred",
        "operands",
        # labels
        "label_uid",
        # branches
        "target",
        # memory ops
        "space", "nc",
        # setp
        "rel", "cmp_signed", "cmp_op", "float_cmp",
        # cvt
        "to_t", "from_t",
        # int ops
        "signed", "wide", "hi", "unary",
        # float ops
        "fname", "commutative",
        # shfl
        "mode", "plain_ops",
    )

    def __init__(self) -> None:
        for name in self.__slots__:
            setattr(self, name, None)


def _decode_label(stmt: Label) -> Decoded:
    d = Decoded()
    d.kind = K_LABEL
    d.uid = stmt.uid
    d.label_uid = stmt.uid
    return d


def decode_instr(instr: Instr, labels: Dict[str, int]) -> Decoded:
    d = Decoded()
    d.instr = instr
    d.uid = instr.uid
    d.operands = instr.operands
    d.pred = instr.pred
    parts = instr.opcode.split(".")
    d.parts = parts
    base = parts[0]
    d.base = base
    tsuf = None
    for p in reversed(parts):
        if p in TYPE_WIDTH:
            tsuf = p
            break
    d.tsuf = tsuf
    d.width = TYPE_WIDTH.get(tsuf, 32)

    if base == "bra":
        d.kind = K_BRA
        target_op = instr.operands[0]
        if isinstance(target_op, LabelRef):
            d.target = labels.get(target_op.name)
        return d
    if base in ("ret", "exit"):
        d.kind = K_RET
        return d
    if base == "ld":
        d.kind = K_LD
        d.space = "global"
        for p in parts[1:]:
            if p in _LD_SPACES:
                d.space = p
        d.nc = "nc" in parts
        return d
    if base == "st":
        d.kind = K_ST
        d.space = "global"
        for p in parts[1:]:
            if p in _ST_SPACES:
                d.space = p
        return d
    if base == "mov":
        d.kind = K_MOV
        return d
    if base == "setp":
        d.kind = K_SETP
        d.cmp_op = parts[1] if len(parts) > 1 else "eq"
        rel, signed = CMP_MAP.get(d.cmp_op, ("eq", True))
        d.float_cmp = not (tsuf in INT_TYPES or tsuf is None)
        if tsuf and (tsuf.startswith("u") or tsuf.startswith("b")):
            signed = signed and rel in ("eq", "ne")
        d.rel = rel
        d.cmp_signed = signed
        return d
    if base == "selp":
        d.kind = K_SELP
        return d
    if base == "cvta":
        d.kind = K_CVTA
        return d
    if base == "cvt":
        d.kind = K_CVT
        types = [p for p in parts[1:] if p in TYPE_WIDTH]
        if len(types) < 2:
            types = ["b32", "b32"]
        d.to_t, d.from_t = types[0], types[1]
        return d
    if base in ("and", "or", "xor", "not") and tsuf == "pred":
        d.kind = K_PREDLOGIC
        return d
    if tsuf in FLOAT_TYPES and base in _FLOAT_BASES:
        d.kind = K_FLOAT
        d.fname = f"f{base}.{tsuf}"
        d.commutative = base in ("add", "mul", "min", "max")
        return d
    if base in _INT_BASES:
        d.kind = K_INT
        d.signed = bool(tsuf) and tsuf.startswith("s")
        d.wide = "wide" in parts
        d.hi = "hi" in parts
        d.unary = base in _INT_UNARY
        return d
    if base == "shfl":
        d.kind = K_SHFL
        d.mode = next((p for p in parts[1:] if p in _SHFL_MODES), "idx")
        d.plain_ops = 4 if "sync" in parts else 3
        return d
    if base == "activemask":
        d.kind = K_ACTIVEMASK
        return d
    if base in ("bar", "membar", "fence"):
        d.kind = K_BARRIER
        return d
    d.kind = K_OTHER
    return d


def decode_kernel(kernel: Kernel,
                  labels: Optional[Dict[str, int]] = None) -> List[Decoded]:
    """Decode every statement of ``kernel.body`` (requires renumbered
    uids; call ``kernel.renumber()`` first)."""
    if labels is None:
        labels = kernel.labels()
    out: List[Decoded] = []
    for stmt in kernel.body:
        if isinstance(stmt, Label):
            out.append(_decode_label(stmt))
        else:
            out.append(decode_instr(stmt, labels))
    return out
