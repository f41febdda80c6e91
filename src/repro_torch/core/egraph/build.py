"""Mirrors ``src/repro/core/egraph/build.py`` (only the imports differ).

Lower per-block PTX dataflow into e-graphs.

One e-graph per basic block (the CFG analysis already computed block
boundaries): straight-line dataflow keeps extraction trivially sound —
every equality the graph stores holds at every program point of the
block, so a representative register computed earlier in the block can
stand in for any later recomputation without dominance reasoning.

Each instruction is classified:

* **eligible** — unpredicated integer ALU ops in renderable forms
  (``add``/``sub``/``mul.lo``/``mad.lo``/``shl``/``shr``/logic/…) become
  structural e-nodes the rule engine can rewrite, plus a symbolic
  :class:`~repro.core.symbolic.terms.Term` value number: two defs whose
  affine normal forms collide are unioned on the spot, which catches
  reassociation/strength-reduction equalities without any rule search.
* **opaque** — pure ops we will not rewrite (floats, ``cvt``/``cvta``,
  ``mul.wide``, bit tricks) become ``op:<opcode>`` e-nodes: they still
  CSE by structural congruence but are never rendered as alternatives,
  so float rounding is never perturbed.
* **load-cse** — ``ld.param`` and non-coherent ``ld.global.nc`` results
  are safe to reuse (read-only data); ``ld.param [x]`` hashconses on the
  param name, ``ld.global.nc`` seeds a per-site class that the
  saturation driver may union cross-flow from the symbolic traces.
* **anchor** — side-effecting or divergence-dependent defs (coherent
  loads, ``selp``, ``shfl``, ``activemask``, any predicated write):
  kept verbatim, their dst seeds a fresh class (and can still *hold* a
  value other reads are remapped to).

Predicate registers are never tracked — the shuffle detector owns
control flow — and an unknown opcode (``K_OTHER``) conservatively
kills all tracked state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..emulator.decode import (
    Decoded,
    K_ACTIVEMASK,
    K_BRA,
    K_BARRIER,
    K_CVT,
    K_CVTA,
    K_FLOAT,
    K_INT,
    K_LABEL,
    K_LD,
    K_MOV,
    K_OTHER,
    K_PREDLOGIC,
    K_RET,
    K_SELP,
    K_SETP,
    K_SHFL,
    K_ST,
    decode_kernel,
)
from ..ptx.ir import Imm, Instr, Kernel, Label, MemRef, Reg, SPECIAL_REGS
from ..symbolic.terms import Term
from .egraph import EGraph, ENode

# int bases the extractor knows how to render back to PTX
RENDERABLE = {"add", "sub", "mul", "mad", "shl", "shr", "and", "or",
              "xor", "not", "neg", "min", "max", "div", "rem"}
# bases whose op key carries signedness (semantics differ)
_SIGN_SENSITIVE = {"shr", "div", "rem", "min", "max"}
_INT_WIDTHS = (16, 32, 64)


def op_key(d: Decoded) -> str:
    """Semantic e-node operator for a renderable ``K_INT`` micro-op."""
    if d.base in _SIGN_SENSITIVE:
        return f"{d.base}.{'s' if d.signed else 'u'}"
    return d.base


@dataclass
class Read:
    """One remappable register read: ``operands[idx]`` (or its MemRef
    base when ``mem``) held e-class ``cid`` at this point."""
    idx: int
    mem: bool
    cid: int


@dataclass
class InstrInfo:
    """Extraction-facing record for one instruction statement."""
    uid: int
    d: Decoded
    category: str                       # eligible|opaque|copy|load-cse|anchor|plain|barrier
    dst: Optional[str] = None
    dst_class: Optional[int] = None
    reads: List[Read] = field(default_factory=list)

    @property
    def pure(self) -> bool:
        """Deletable when the dst register is never read again."""
        return self.category in ("eligible", "opaque", "copy", "load-cse")


@dataclass
class BlockGraph:
    bid: int
    start: int
    end: int
    eg: EGraph
    infos: List[InstrInfo]
    entry: Dict[str, int]               # reg read before written -> class
    load_classes: Dict[int, int]        # nc-load uid -> dst class
    vn_unions: int = 0


class _BlockBuilder:
    def __init__(self, kernel: Kernel, bid: int, start: int, end: int) -> None:
        self.kernel = kernel
        self.bg = BlockGraph(bid, start, end, EGraph(), [], {}, {})
        self.cur: Dict[str, int] = {}       # reg -> current class
        self.term: Dict[str, Term] = {}     # reg -> current value term
        self.term_map: Dict[Term, int] = {} # value number -> class

    # -- leaves ---------------------------------------------------------
    def _class_term(self, cid: int, width: int) -> Term:
        return Term.sym(f"@c{cid}", width)

    def _seed(self, reg: str, cid: int, width: int) -> None:
        self.cur[reg] = cid
        self.term[reg] = self._class_term(cid, width)

    def _entry(self, reg: str) -> int:
        cid = self.cur.get(reg)
        if cid is None:
            width = self.kernel.reg_width(reg)
            cid = self.bg.eg.add(ENode("sym", width, (), ("in", reg)))
            self.bg.entry[reg] = cid
            self._seed(reg, cid, width)
        return cid

    def _operand(self, op, width: int) -> Tuple[Optional[int], Optional[Term]]:
        """(class, term) of one value operand; (None, None) if untrackable."""
        eg = self.bg.eg
        if isinstance(op, Imm):
            if op.is_float:
                return eg.add(ENode("sym", width, (), ("fimm", op.value))), None
            value = op.value & ((1 << width) - 1)
            return eg.add(ENode("const", width, (), value)), \
                Term.const_(value, width)
        if isinstance(op, Reg):
            name = op.name
            if name == "WARP_SZ":
                return eg.add(ENode("const", width, (), 32)), \
                    Term.const_(32, width)
            if name in SPECIAL_REGS:
                cid = eg.add(ENode("sym", 32, (), ("sp", name)))
                return cid, self._class_term(cid, 32)
            if self.kernel.reg_type(name) == "pred":
                return None, None
            cid = self._entry(name)
            return cid, self.term.get(name)
        return None, None

    # -- defs -----------------------------------------------------------
    def _kill(self, reg: str) -> None:
        self.cur.pop(reg, None)
        self.term.pop(reg, None)

    def _define(self, info: InstrInfo, reg: str, cid: int, width: int,
                term: Optional[Term]) -> None:
        self.cur[reg] = cid
        self.term[reg] = term if term is not None \
            else self._class_term(cid, width)
        info.dst = reg
        info.dst_class = cid

    def _value_number(self, cid: int, term: Optional[Term],
                      width: int) -> int:
        """Union ``cid`` with any class already holding the same value
        number (or the folded constant); returns the canonical class."""
        eg = self.bg.eg
        if term is None or getattr(term, "width", width) != width:
            return cid
        prev = self.term_map.get(term)
        if prev is None:
            self.term_map[term] = cid
        elif eg.union(prev, cid):
            self.bg.vn_unions += 1
        cv = term.as_const
        if cv is not None:
            if eg.union(eg.add(ENode("const", width, (), cv)), cid):
                self.bg.vn_unions += 1
        return eg.find(cid)

    def _compute_term(self, d: Decoded,
                      terms: List[Optional[Term]]) -> Optional[Term]:
        if any(t is None or getattr(t, "width", None) != d.width
               for t in terms):
            return None
        a = terms[0]
        try:
            if d.base == "add":
                return a.add(terms[1])
            if d.base == "sub":
                return a.sub(terms[1])
            if d.base == "mul":
                return a.mul(terms[1])
            if d.base == "mad":
                return a.madd(terms[1], terms[2])
            if d.base == "shl":
                return a.shl(terms[1])
            if d.base == "shr":
                return a.shr(terms[1], d.signed)
            if d.base == "and":
                return a.and_(terms[1])
            if d.base == "or":
                return a.or_(terms[1])
            if d.base == "xor":
                return a.xor_(terms[1])
            if d.base == "not":
                return a.not_()
            if d.base == "neg":
                return a.neg()
            if d.base == "min":
                return a.min_(terms[1], d.signed)
            if d.base == "max":
                return a.max_(terms[1], d.signed)
            if d.base == "div":
                return a.div(terms[1], d.signed)
            if d.base == "rem":
                return a.rem(terms[1], d.signed)
        except (ValueError, ZeroDivisionError, OverflowError):
            return None
        return None

    # -- per-instruction ------------------------------------------------
    def visit(self, d: Decoded) -> None:
        if d.kind == K_LABEL:
            return
        instr: Instr = d.instr
        info = InstrInfo(uid=d.uid, d=d, category="plain")
        self.bg.infos.append(info)
        eg = self.bg.eg

        if d.kind in (K_BRA, K_RET, K_BARRIER, K_PREDLOGIC):
            return
        if d.kind == K_OTHER:
            # unknown opcode: assume it can write anything
            info.category = "barrier"
            self.cur.clear()
            self.term.clear()
            return

        # value reads (remappable) --------------------------------------
        def read(idx: int, op, width: int,
                 mem: bool = False) -> Tuple[Optional[int], Optional[Term]]:
            cid, term = self._operand(op, width)
            if cid is not None and isinstance(op, (Reg, MemRef)):
                name = op.base if mem else op.name
                if name not in SPECIAL_REGS:
                    info.reads.append(Read(idx, mem, cid))
            return cid, term

        ops = instr.operands
        predicated = d.pred is not None

        if d.kind == K_ST:
            for i, op in enumerate(ops):
                if isinstance(op, MemRef):
                    self._entry(op.base)
                    cid, _ = self._operand(Reg(op.base), 64)
                    if cid is not None:
                        info.reads.append(Read(i, True, cid))
                elif isinstance(op, Reg):
                    read(i, op, d.width)
            return

        dst = ops[0]
        if not isinstance(dst, Reg) or dst.name in SPECIAL_REGS:
            return
        dname = dst.name
        if self.kernel.reg_type(dname) == "pred":
            return                       # preds untracked (setp/predlogic)
        dwidth = self.kernel.reg_width(dname)

        if d.kind == K_LD:
            ref = next((o for o in ops if isinstance(o, MemRef)), None)
            if ref is None:
                self._kill(dname)
                info.category = "anchor"
                info.dst = dname
                return
            if d.space == "param":
                cid = eg.add(ENode("sym", d.width, (), ("param", ref.base)))
            else:
                self._entry(ref.base)
                acid, _ = self._operand(Reg(ref.base), 64)
                if acid is not None:
                    info.reads.append(
                        Read(ops.index(ref), True, acid))
                cid = eg.add(ENode("sym", d.width, (), ("load", d.uid)))
            if predicated:
                self._kill(dname)
                info.category = "anchor"
                info.dst = dname
                return
            reusable = d.space == "param" or (d.space == "global" and d.nc)
            self._define(info, dname, cid, dwidth, None)
            info.category = "load-cse" if reusable else "anchor"
            if reusable and d.space == "global":
                self.bg.load_classes[d.uid] = cid
            return

        # remaining kinds read plain value operands after the dst
        srcs: List[Optional[int]] = []
        terms: List[Optional[Term]] = []
        src_ops = ops[1:]
        if d.kind == K_SELP:
            src_ops = ops[1:3]          # last operand is the predicate
        for i, op in enumerate(src_ops, start=1):
            cid, term = read(i, op, d.width)
            srcs.append(cid)
            terms.append(term)

        if predicated:
            self._kill(dname)           # may or may not write: unknown
            info.category = "anchor"
            info.dst = dname
            return

        if d.kind == K_MOV:
            cid, term = (srcs[0], terms[0]) if srcs else (None, None)
            if cid is None:
                self._kill(dname)
                info.category = "anchor"
                info.dst = dname
                return
            self._define(info, dname, cid, dwidth, term)
            if term is None:
                self.term[dname] = self._class_term(cid, dwidth)
            info.category = "copy"
            return

        if d.kind in (K_SELP, K_SHFL, K_ACTIVEMASK):
            cid = eg.add(ENode("sym", dwidth, (), ("def", d.uid)))
            self._define(info, dname, cid, dwidth, None)
            info.category = "anchor"
            return

        if d.kind == K_INT and d.base in RENDERABLE \
                and not d.wide and not d.hi \
                and d.width in _INT_WIDTHS and all(c is not None for c in srcs):
            node = ENode(op_key(d), d.width, tuple(srcs))
            cid = eg.add(node)
            term = self._compute_term(d, terms)
            cid = self._value_number(cid, term, d.width)
            self._define(info, dname, cid, dwidth, term)
            info.category = "eligible"
            return

        if d.kind in (K_FLOAT, K_CVT, K_CVTA, K_INT) \
                and all(c is not None for c in srcs) and srcs:
            cid = eg.add(ENode(f"op:{instr.opcode}", dwidth, tuple(srcs)))
            self._define(info, dname, cid, dwidth, None)
            info.category = "opaque"
            return

        # untrackable def
        self._kill(dname)
        info.category = "anchor"
        info.dst = dname


def build_blocks(kernel: Kernel, cfg, decoded=None) -> List[BlockGraph]:
    """One :class:`BlockGraph` per CFG block, in block order."""
    if decoded is None:
        decoded = decode_kernel(kernel)
    out: List[BlockGraph] = []
    for block in cfg.blocks:
        bb = _BlockBuilder(kernel, block.bid, block.start, block.end)
        for uid in range(block.start, block.end + 1):
            bb.visit(decoded[uid])
        bb.bg.eg.rebuild()
        out.append(bb.bg)
    return out
