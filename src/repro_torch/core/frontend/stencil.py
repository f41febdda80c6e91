"""Mirrors ``src/repro/core/frontend/stencil.py`` (only the imports differ).

Directive-style loop-nest DSL and its PTX lowering.

Stand-in for the paper's OpenACC frontend (NVHPC): programs are loop nests
over arrays annotated with parallel dims, exactly like the KernelGen suite
(Listing 4).  ``lower_to_ptx`` emits the PTX subset with NVHPC-like
conventions: innermost parallel dim -> ``%tid.x`` (vector), outer parallel
dims -> ``%ctaid.y/z`` (gang), per-row base-address registers with loads
scheduled in ascending address order, read-only arrays loaded via
``ld.global.nc``.

The same ``Program`` is lowered to a Pallas TPU kernel by
:mod:`repro.core.frontend.pallas_lower`, where PTXASW's detected deltas
drive in-register (VMEM tile) reuse instead of ``shfl`` instructions.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..ptx.ir import Imm, Instr, Kernel, Label, LabelRef, MemRef, Reg
from ..emulator.concrete import f32_bits

PARALLEL_VARS = ("i", "j", "k")


# ---------------------------------------------------------------------------
# index expressions:  affine over {i, j, k, loop vars} + const
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Index:
    coeffs: Tuple[Tuple[str, int], ...] = ()
    const: int = 0

    @staticmethod
    def of(var: str, offset: int = 0) -> "Index":
        return Index(coeffs=((var, 1),), const=offset)

    @staticmethod
    def const_(c: int) -> "Index":
        return Index(const=c)

    def shift(self, d: int) -> "Index":
        return Index(self.coeffs, self.const + d)

    def coeff(self, var: str) -> int:
        for v, c in self.coeffs:
            if v == var:
                return c
        return 0

    def vars(self) -> List[str]:
        return [v for v, _ in self.coeffs]

    def __repr__(self) -> str:
        parts = [f"{'' if c == 1 else c}{v}" for v, c in self.coeffs]
        if self.const or not parts:
            parts.append(f"{self.const:+d}" if parts else str(self.const))
        return "".join(parts)


def I(offset: int = 0) -> Index:  # noqa: E743
    return Index.of("i", offset)


def J(offset: int = 0) -> Index:
    return Index.of("j", offset)


def K(offset: int = 0) -> Index:
    return Index.of("k", offset)


# ---------------------------------------------------------------------------
# expression tree
# ---------------------------------------------------------------------------

class Expr:
    def __add__(self, o): return Bin("+", self, _wrap(o))
    def __radd__(self, o): return Bin("+", _wrap(o), self)
    def __sub__(self, o): return Bin("-", self, _wrap(o))
    def __rsub__(self, o): return Bin("-", _wrap(o), self)
    def __mul__(self, o): return Bin("*", self, _wrap(o))
    def __rmul__(self, o): return Bin("*", _wrap(o), self)
    def __truediv__(self, o): return Bin("/", self, _wrap(o))


def _wrap(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    return Const(float(v))


@dataclass
class Const(Expr):
    value: float


@dataclass
class Scalar(Expr):
    """A runtime scalar kernel parameter (f32)."""
    name: str


@dataclass
class Load(Expr):
    array: str
    idx: Tuple[Index, ...]
    tag: int = 0     # loads with different tags are never CSE'd (models
                     # separate pointer chains the real compiler misses)


@dataclass
class Bin(Expr):
    op: str
    a: Expr
    b: Expr


@dataclass
class Call(Expr):
    fn: str      # sin | cos | sqrt | ex2 | lg2
    arg: Expr


@dataclass
class Reduce(Expr):
    """Sequential reduction loop: sum over var in [0, count)."""
    var: str
    count: Union[int, str]      # trip count (const or u32 param name)
    body: Expr
    unroll: int = 1


class Array:
    """Sugar: ``w0[I(-1), J(1)]`` -> Load."""

    def __init__(self, name: str):
        self.name = name

    def __getitem__(self, idx) -> Load:
        if not isinstance(idx, tuple):
            idx = (idx,)
        norm = tuple(ix if isinstance(ix, Index) else Index.const_(ix)
                     for ix in idx)
        return Load(self.name, norm)


@dataclass
class Program:
    """A parallel loop nest writing one output element per thread."""

    name: str
    ndim: int                      # parallel dims (1..3)
    out: Load                      # output array reference (usually [I(),J(),K()])
    expr: Expr
    arrays: Dict[str, int] = field(default_factory=dict)   # name -> ndim
    scalars: List[str] = field(default_factory=list)
    halo: Tuple[int, ...] = ()     # per-dim halo (lo==hi), derived if empty
    lang: str = "C"

    def __post_init__(self) -> None:
        if not self.arrays:
            arrs: Dict[str, int] = {self.out.array: len(self.out.idx)}
            for ld in collect_loads(self.expr):
                arrs.setdefault(ld.array, len(ld.idx))
            self.arrays = arrs
        if not self.halo:
            h = [0] * self.ndim
            for ld in collect_loads(self.expr):
                for d, ix in enumerate(ld.idx[: self.ndim]):
                    for v, c in ix.coeffs:
                        if v in PARALLEL_VARS[: self.ndim]:
                            h[PARALLEL_VARS.index(v)] = max(
                                h[PARALLEL_VARS.index(v)], abs(ix.const))
            self.halo = tuple(h)


def collect_loads(expr: Expr) -> List[Load]:
    out: List[Load] = []

    def walk(e: Expr) -> None:
        if isinstance(e, Load):
            out.append(e)
        elif isinstance(e, Bin):
            walk(e.a)
            walk(e.b)
        elif isinstance(e, Call):
            walk(e.arg)
        elif isinstance(e, Reduce):
            walk(e.body)

    walk(expr)
    return out


# ---------------------------------------------------------------------------
# PTX lowering
# ---------------------------------------------------------------------------

class _Emitter:
    def __init__(self, prog: Program, block_x: int):
        self.prog = prog
        self.block_x = block_x
        self.body: List[object] = []
        self.counters = {"r": 1, "rd": 1, "f": 1, "p": 1}
        self.dim_regs: Dict[str, str] = {}      # i/j/k/loop var -> s32 reg
        self.size_regs: Dict[str, str] = {}     # n0/n1/n2 -> u32 reg
        self.row_regs: Dict[Tuple, str] = {}    # row key -> 64-bit addr reg
        self.load_regs: Dict[int, str] = {}     # id(Load) -> f32 reg
        self.labels = itertools.count()

    # -- register allocation ------------------------------------------------
    def reg(self, cls: str) -> str:
        n = self.counters[cls]
        self.counters[cls] = n + 1
        return f"%{cls}{n}"

    def emit(self, opcode: str, *ops) -> None:
        self.body.append(Instr(opcode, list(ops)))

    # -- prologue: params, thread indices, bounds guard ----------------------
    def prologue(self) -> None:
        p = self.prog
        # array base pointers
        self.base_regs: Dict[str, str] = {}
        for name in sorted(p.arrays):
            r = self.reg("rd")
            self.emit("ld.param.u64", Reg(r), MemRef(name))
            g = self.reg("rd")
            self.emit("cvta.to.global.u64", Reg(g), Reg(r))
            self.base_regs[name] = g
        # sizes
        for d in range(max(p.arrays.values())):
            r = self.reg("r")
            self.emit("ld.param.u32", Reg(r), MemRef(f"n{d}"))
            self.size_regs[f"n{d}"] = r
        # i = tid.x + ctaid.x * ntid.x + halo
        ntid = self.reg("r")
        ctaid = self.reg("r")
        tid = self.reg("r")
        self.emit("mov.u32", Reg(ntid), Reg("%ntid.x"))
        self.emit("mov.u32", Reg(ctaid), Reg("%ctaid.x"))
        self.emit("mov.u32", Reg(tid), Reg("%tid.x"))
        gi = self.reg("r")
        self.emit("mad.lo.s32", Reg(gi), Reg(ctaid), Reg(ntid), Reg(tid))
        i = self.reg("r")
        self.emit("add.s32", Reg(i), Reg(gi), Imm(p.halo[0]))
        self.dim_regs["i"] = i
        names = ["i", "j", "k"]
        cta_dims = ["y", "z"]
        for d in range(1, p.ndim):
            r = self.reg("r")
            self.emit("mov.u32", Reg(r), Reg(f"%ctaid.{cta_dims[d - 1]}"))
            rr = self.reg("r")
            self.emit("add.s32", Reg(rr), Reg(r), Imm(p.halo[d]))
            self.dim_regs[names[d]] = rr
        # guard: exit when dim >= n - halo
        for d in range(p.ndim):
            lim = self.reg("r")
            self.emit("add.s32", Reg(lim), Reg(self.size_regs[f"n{d}"]),
                      Imm(-p.halo[d]))
            pr = self.reg("p")
            self.emit("setp.ge.s32", Reg(pr), Reg(self.dim_regs[names[d]]),
                      Reg(lim))
            self.body.append(Instr("bra", [LabelRef("$EXIT")],
                                   pred=(False, pr)))

    # -- address computation -------------------------------------------------
    def index_value(self, ix: Index) -> str:
        """Materialize an Index into an s32 register."""
        acc: Optional[str] = None
        for v, c in ix.coeffs:
            vr = self.dim_regs[v]
            if c != 1:
                t = self.reg("r")
                self.emit("mul.lo.s32", Reg(t), Reg(vr), Imm(c))
                vr = t
            if acc is None:
                acc = vr
            else:
                t = self.reg("r")
                self.emit("add.s32", Reg(t), Reg(acc), Reg(vr))
                acc = t
        if acc is None:
            t = self.reg("r")
            self.emit("mov.u32", Reg(t), Imm(ix.const))
            return t
        if ix.const:
            t = self.reg("r")
            self.emit("add.s32", Reg(t), Reg(acc), Imm(ix.const))
            acc = t
        return acc

    def row_addr(self, array: str, idx: Tuple[Index, ...]) -> Tuple[str, int]:
        """Address register for a row: base + 4*(i + n0*idx1 + n0*n1*idx2);
        returns (reg, byte offset) so in-row taps become constant offsets —
        the pattern shuffle detection keys on (Listing 6)."""
        lead = idx[0]
        di = lead.const if lead.coeff("i") == 1 else None
        if di is None:
            # leading index does not follow the thread dim; fully dynamic
            key = (array, idx)
            off = 0
        else:
            key = (array, Index(lead.coeffs, 0), idx[1:])
            off = 4 * di
        if key in self.row_regs:
            return self.row_regs[key], off
        # linear element index
        lin: Optional[str] = None
        base_lead = Index(lead.coeffs, 0) if di is not None else lead
        lin = self.index_value(base_lead)
        stride = None
        for d, ix in enumerate(idx[1:], start=1):
            if stride is None:
                stride = self.size_regs["n0"]
            else:
                t = self.reg("r")
                self.emit("mul.lo.s32", Reg(t), Reg(stride),
                          Reg(self.size_regs[f"n{d - 1}"]))
                stride = t
            if not ix.coeffs and ix.const == 0:
                continue
            iv = self.index_value(ix)
            t = self.reg("r")
            self.emit("mad.lo.s32", Reg(t), Reg(iv), Reg(stride), Reg(lin))
            lin = t
        wide = self.reg("rd")
        self.emit("mul.wide.s32", Reg(wide), Reg(lin), Imm(4))
        addr = self.reg("rd")
        self.emit("add.s64", Reg(addr), Reg(self.base_regs[array]), Reg(wide))
        self.row_regs[key] = addr
        return addr, off

    # -- load scheduling (ascending address order, per region) ---------------
    def emit_region_loads(self, loads: Sequence[Load], readonly: bool) -> None:
        def ix_key(ix: Index):
            return (ix.coeffs, ix.const)

        def sort_key(ld: Load):
            rev = tuple(ix_key(ix) for ix in reversed(ld.idx[1:]))
            return (ld.array, rev, ld.idx[0].const, ix_key(ld.idx[0]), ld.tag)

        def cse_key(ld: Load):
            return (ld.array, tuple(ix_key(ix) for ix in ld.idx), ld.tag)

        emitted: Dict[Tuple, str] = {}
        for ld in sorted(loads, key=sort_key):
            key = cse_key(ld)
            if key not in emitted:      # -O3-style load CSE within a region
                addr, off = self.row_addr(ld.array, ld.idx)
                r = self.reg("f")
                op = "ld.global.nc.f32" if readonly else "ld.global.f32"
                self.emit(op, Reg(r), MemRef(addr, off))
                emitted[key] = r
            self.load_regs[id(ld)] = emitted[key]

    # -- expression evaluation ------------------------------------------------
    def eval_expr(self, e: Expr) -> str:
        if isinstance(e, Load):
            return self.load_regs[id(e)]
        if isinstance(e, Const):
            r = self.reg("f")
            self.emit("mov.f32", Reg(r), Imm(f32_bits(e.value), is_float=True))
            return r
        if isinstance(e, Scalar):
            r = self.reg("f")
            self.emit("ld.param.f32", Reg(r), MemRef(e.name))
            return r
        if isinstance(e, Bin):
            a = self.eval_expr(e.a)
            b = self.eval_expr(e.b)
            r = self.reg("f")
            op = {"+": "add.f32", "-": "sub.f32", "*": "mul.f32",
                  "/": "div.rn.f32"}[e.op]
            self.emit(op, Reg(r), Reg(a), Reg(b))
            return r
        if isinstance(e, Call):
            a = self.eval_expr(e.arg)
            r = self.reg("f")
            fn = {"sin": "sin.approx.f32", "cos": "cos.approx.f32",
                  "sqrt": "sqrt.rn.f32", "ex2": "ex2.approx.f32",
                  "lg2": "lg2.approx.f32"}[e.fn]
            self.emit(fn, Reg(r), Reg(a))
            return r
        if isinstance(e, Reduce):
            return self.eval_reduce(e)
        raise TypeError(e)

    def eval_reduce(self, e: Reduce) -> str:
        acc = self.reg("f")
        self.emit("mov.f32", Reg(acc), Imm(f32_bits(0.0), is_float=True))
        ctr = self.reg("r")
        self.emit("mov.u32", Reg(ctr), Imm(0))
        self.dim_regs[e.var] = ctr
        if isinstance(e.count, str):
            trip = self.size_regs.get(e.count)
            if trip is None:
                trip = self.reg("r")
                self.emit("ld.param.u32", Reg(trip), MemRef(e.count))
                self.size_regs[e.count] = trip
        lbl = f"$LOOP{next(self.labels)}"
        saved_loads = dict(self.load_regs)
        self.body.append(Label(lbl))
        for u in range(e.unroll):
            if u > 0:
                t = self.reg("r")
                self.emit("add.s32", Reg(t), Reg(ctr), Imm(u))
                self.dim_regs[e.var] = t
            saved_rows = dict(self.row_regs)
            self.load_regs = dict(saved_loads)
            body_loads = collect_loads(e.body)
            self.emit_region_loads(body_loads, readonly=True)
            v = self.eval_expr(e.body)
            r = self.reg("f")
            self.emit("add.f32", Reg(r), Reg(acc), Reg(v))
            self.emit("mov.f32", Reg(acc), Reg(r))
            self.row_regs = saved_rows
        self.load_regs = saved_loads
        self.dim_regs[e.var] = ctr
        self.emit("add.s32", Reg(ctr), Reg(ctr), Imm(e.unroll))
        pr = self.reg("p")
        if isinstance(e.count, str):
            self.emit("setp.lt.s32", Reg(pr), Reg(ctr),
                      Reg(self.size_regs[e.count]))
        else:
            self.emit("setp.lt.s32", Reg(pr), Reg(ctr), Imm(e.count))
        self.body.append(Instr("bra", [LabelRef(lbl)], pred=(False, pr)))
        return acc


def lower_to_ptx(prog: Program, block_x: int = 512) -> Kernel:
    em = _Emitter(prog, block_x)
    em.prologue()
    # top-level region: loads outside any Reduce
    top_loads = [ld for ld in collect_loads(prog.expr)
                 if not _inside_reduce(prog.expr, ld)]
    em.emit_region_loads(top_loads, readonly=True)
    result = em.eval_expr(prog.expr)
    out_addr, out_off = em.row_addr(prog.out.array, prog.out.idx)
    em.emit("st.global.f32", MemRef(out_addr, out_off), Reg(result))
    em.body.append(Label("$EXIT"))
    em.emit("ret")

    params: List[Tuple[str, str]] = [(a, "u64") for a in sorted(prog.arrays)]
    params += [(f"n{d}", "u32") for d in range(max(prog.arrays.values()))]
    params += [(s, "f32") for s in prog.scalars]
    kernel = Kernel(name=prog.name, params=params)
    kernel.decls = [("pred", "p", em.counters["p"] + 1),
                    ("f32", "f", em.counters["f"] + 1),
                    ("b32", "r", em.counters["r"] + 1),
                    ("b64", "rd", em.counters["rd"] + 1)]
    kernel.body = em.body
    kernel.renumber()
    return kernel


def _inside_reduce(root: Expr, target: Load) -> bool:
    found = [False]

    def walk(e: Expr, inside: bool) -> None:
        if e is target and inside:
            found[0] = True
        if isinstance(e, Bin):
            walk(e.a, inside)
            walk(e.b, inside)
        elif isinstance(e, Call):
            walk(e.arg, inside)
        elif isinstance(e, Reduce):
            walk(e.body, True)

    walk(root, False)
    return found[0]
