"""Mirrors ``src/repro/core/ptx/ir.py`` (only the imports differ).

PTX-subset intermediate representation.

Covers the documented PTX fragment that NVHPC/NVCC emit for the paper's
benchmark class (Listing 2): parameter loads, integer/float arithmetic,
predicates + branches, global/shared memory ops, special registers, and the
warp-level ``shfl.sync`` / ``activemask`` instructions that shuffle
synthesis inserts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

# "%r12" -> prefix "r" (matches a `.reg .u32 %r<N>` family declaration)
_REG_NAME_RE = re.compile(r"%([A-Za-z_]+)(\d+)$")

TYPE_WIDTH = {
    "pred": 1,
    "b8": 8, "s8": 8, "u8": 8,
    "b16": 16, "s16": 16, "u16": 16, "f16": 16,
    "b32": 32, "s32": 32, "u32": 32, "f32": 32,
    "b64": 64, "s64": 64, "u64": 64, "f64": 64,
}

SPECIAL_REGS = (
    "%tid.x", "%tid.y", "%tid.z",
    "%ntid.x", "%ntid.y", "%ntid.z",
    "%ctaid.x", "%ctaid.y", "%ctaid.z",
    "%nctaid.x", "%nctaid.y", "%nctaid.z",
    "%laneid", "WARP_SZ",
)


@dataclass(frozen=True)
class Reg:
    name: str

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Imm:
    value: int          # raw bits for float immediates (0f... / 0d...)
    is_float: bool = False
    width: int = 32
    hex: bool = False   # print as 0x... (e.g. shfl.sync membermasks)

    def __str__(self) -> str:
        if self.is_float:
            prefix = "0f" if self.width == 32 else "0d"
            return prefix + format(self.value, "08X" if self.width == 32 else "016X")
        if self.hex and self.value >= 0:
            return f"0x{self.value:x}"
        return str(self.value)


@dataclass(frozen=True)
class MemRef:
    base: str           # register name or kernel-parameter name
    offset: int = 0

    def __str__(self) -> str:
        if self.offset:
            return f"[{self.base}+{self.offset}]"
        return f"[{self.base}]"


@dataclass(frozen=True)
class LabelRef:
    name: str

    def __str__(self) -> str:
        return self.name


Operand = Union[Reg, Imm, MemRef, LabelRef]


@dataclass
class Instr:
    opcode: str                       # dotted, e.g. "ld.global.f32"
    operands: List[Operand]
    pred: Optional[Tuple[bool, str]] = None   # (negated, predicate register)
    uid: int = -1                     # statement index within kernel body

    @property
    def parts(self) -> List[str]:
        return self.opcode.split(".")

    @property
    def base(self) -> str:
        return self.parts[0]

    def type_suffix(self) -> Optional[str]:
        for p in reversed(self.parts):
            if p in TYPE_WIDTH:
                return p
        return None

    def __str__(self) -> str:
        ops = ", ".join(str(o) for o in self.operands)
        body = f"{self.opcode} {ops};" if self.operands else f"{self.opcode};"
        if self.pred is not None:
            neg, reg = self.pred
            return f"@{'!' if neg else ''}{reg} {body}"
        return body


@dataclass
class Label:
    name: str
    uid: int = -1

    def __str__(self) -> str:
        return f"{self.name}:"


Statement = Union[Instr, Label]


@dataclass
class Kernel:
    name: str
    params: List[Tuple[str, str]]                 # (name, type)
    decls: List[Tuple[str, str, int]] = field(default_factory=list)  # (type, prefix, count)
    body: List[Statement] = field(default_factory=list)
    _fresh: int = 0

    def renumber(self) -> None:
        for i, stmt in enumerate(self.body):
            stmt.uid = i

    def labels(self) -> Dict[str, int]:
        return {s.name: i for i, s in enumerate(self.body) if isinstance(s, Label)}

    def param_type(self, name: str) -> Optional[str]:
        for n, t in self.params:
            if n == name:
                return t
        return None

    def new_reg(self, ptype: str, hint: str = "sfl") -> str:
        """Allocate a fresh register of PTX type ``ptype`` (adds a decl)."""
        name = f"%{hint}{self._fresh}"
        self._fresh += 1
        self.decls.append((ptype, name, 0))  # count 0 => single register decl
        return name

    def _reg_lookup(self, reg: str) -> Optional[str]:
        """Declared PTX type of ``reg``, via a per-kernel declaration
        map (rebuilt whenever ``decls`` grows, e.g. via ``new_reg``):
        single declarations by exact name, family declarations
        (``.reg .u32 %r<6>``) by letters-only prefix — the same two
        shapes the old per-call regex scan accepted."""
        cache = getattr(self, "_reg_cache", None)
        if cache is None or cache[0] != len(self.decls):
            singles: Dict[str, str] = {}
            families: Dict[str, str] = {}
            for ptype, prefix, count in self.decls:
                if count == 0:
                    singles.setdefault(prefix, ptype)
                elif _REG_NAME_RE.match(f"%{prefix}0"):
                    families.setdefault(prefix, ptype)
            cache = (len(self.decls), singles, families, {})
            self._reg_cache = cache
        memo = cache[3]
        if reg in memo:
            return memo[reg]
        out = cache[1].get(reg)
        if out is None and reg.startswith("%"):
            body = reg[1:]
            j = len(body)
            while j > 0 and body[j - 1].isdigit():
                j -= 1
            if j < len(body):
                out = cache[2].get(body[:j])
        memo[reg] = out
        return out

    def reg_width(self, reg: str) -> int:
        if reg in SPECIAL_REGS:
            return 32
        ptype = self._reg_lookup(reg)
        return TYPE_WIDTH[ptype] if ptype is not None else 32

    def reg_type(self, reg: str) -> Optional[str]:
        return self._reg_lookup(reg)


@dataclass
class Module:
    kernels: List[Kernel] = field(default_factory=list)
    # module-level directives as parsed from the source (None = the
    # source declared none; the printer then falls back to defaults)
    version: Optional[str] = None
    target: Optional[str] = None
    address_size: Optional[str] = None

    def kernel(self, name: str) -> Kernel:
        for k in self.kernels:
            if k.name == name:
                return k
        raise KeyError(name)
