"""Mirrors ``src/repro/core/egraph/extract.py`` (only the imports differ).

Cost-guided extraction: choose representatives, rebuild PTX.

The extractor turns each saturated block e-graph back into
straight-line PTX, picking the cheapest way to realize every value
under the *target profile's* static instruction costs
(:func:`repro.core.targets.cost.static_instr_cost`) — so a Kepler
compile and a Hopper compile of the same kernel can extract different
code (integer multiplies are 4x ALU pre-Volta, 2x after).

Per block it tracks **holders**: which registers currently contain each
e-class's value (entry registers seed the map; any redefinition evicts
the old binding).  Extraction then makes two kinds of local decisions,
both trivially sound because holders are killed on redefinition:

* every remappable register *read* is redirected to the earliest
  surviving holder of its class — the hook that makes later CSE'd
  definitions dead;
* every pure *definition* picks the cheapest of: drop (dst already
  holds the value), ``mov`` from an immediate or an existing holder,
  re-render a cheaper e-node from its class (``shl`` for ``mul.lo`` by
  a power of two, fused ``mad``, folded constant), or keep the original
  instruction.  Anchors (coherent loads, ``selp``, ``shfl``, predicated
  writes) are never replaced, only remapped and registered as holders.

A final kernel-wide dead-code sweep deletes pure definitions whose
register is never read again, iterated to fixpoint; the summed static
cost of deletions plus def-site savings is the reported
``sat_cycle_delta_milli`` (positive = predicted cycles saved).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..emulator.decode import (
    K_BARRIER, K_BRA, K_OTHER, K_RET, K_ST,
)
from ..ptx.ir import Imm, Instr, Kernel, Label, MemRef, Reg, TYPE_WIDTH
from ..targets.cost import static_instr_cost
from ..targets.profile import TargetProfile
from .build import BlockGraph, InstrInfo
from .egraph import EGraph, ENode

# e-node op key -> PTX opcode template ({w} = operand width)
_RENDER = {
    "add": "add.s{w}", "sub": "sub.s{w}",
    "mul": "mul.lo.s{w}", "mad": "mad.lo.s{w}",
    "shl": "shl.b{w}", "shr.s": "shr.s{w}", "shr.u": "shr.u{w}",
    "and": "and.b{w}", "or": "or.b{w}", "xor": "xor.b{w}",
    "not": "not.b{w}", "neg": "neg.s{w}",
    "min.s": "min.s{w}", "min.u": "min.u{w}",
    "max.s": "max.s{w}", "max.u": "max.u{w}",
    "div.s": "div.s{w}", "div.u": "div.u{w}",
    "rem.s": "rem.s{w}", "rem.u": "rem.u{w}",
}

_SPACES = ("param", "global", "shared", "local", "const")


def instr_cost(profile: TargetProfile, opcode: str) -> float:
    """Static cost of one instruction, from its opcode string alone."""
    parts = opcode.split(".")
    tsuf = next((p for p in reversed(parts) if p in TYPE_WIDTH), None)
    space = next((p for p in parts[1:] if p in _SPACES), None)
    return static_instr_cost(profile, parts[0], tsuf=tsuf, space=space,
                             nc="nc" in parts, parts=tuple(parts))


@dataclass
class ExtractionResult:
    kernel: Kernel
    rewrites: int
    deleted: int
    cycle_delta: float      # predicted cycles saved (positive = better)


class _Holders:
    """canonical e-class -> registers currently containing its value."""

    def __init__(self, eg: EGraph) -> None:
        self.eg = eg
        self.by_class: Dict[int, List[str]] = {}
        self.held: Dict[str, int] = {}

    def kill(self, reg: str) -> None:
        cid = self.held.pop(reg, None)
        if cid is not None:
            self.by_class[cid].remove(reg)

    def register(self, reg: str, cid: int) -> None:
        cid = self.eg.find(cid)
        if self.held.get(reg) == cid:
            return
        self.kill(reg)
        self.held[reg] = cid
        self.by_class.setdefault(cid, []).append(reg)

    def holding(self, cid: int) -> List[str]:
        return self.by_class.get(self.eg.find(cid), [])

    def clear(self) -> None:
        self.by_class.clear()
        self.held.clear()


def _reg_kind(kernel: Kernel, name: str) -> Optional[Tuple[str, int]]:
    """(type class, width) for holder compatibility; None = untouchable."""
    t = kernel.reg_type(name)
    if t is None or t == "pred":
        return None
    return ("f" if t.startswith("f") else "i", kernel.reg_width(name))


class _BlockExtractor:
    def __init__(self, kernel: Kernel, bg: BlockGraph,
                 profile: TargetProfile) -> None:
        self.kernel = kernel
        self.bg = bg
        self.eg = bg.eg
        self.profile = profile
        self.holders = _Holders(bg.eg)
        for reg, cid in bg.entry.items():
            if _reg_kind(kernel, reg) is not None:
                self.holders.register(reg, cid)
        self.rewrites = 0
        self.delta = 0.0

    # -- operand remapping ---------------------------------------------
    def _remap(self, info: InstrInfo,
               operands: List[object]) -> List[object]:
        out = list(operands)
        for rd in info.reads:
            op = out[rd.idx]
            name = op.base if rd.mem else op.name
            kind = _reg_kind(self.kernel, name)
            if kind is None:
                continue
            for holder in self.holders.holding(rd.cid):
                if holder == name:
                    break               # already reads the earliest holder
                if _reg_kind(self.kernel, holder) == kind:
                    out[rd.idx] = MemRef(holder, op.offset) if rd.mem \
                        else Reg(holder)
                    break
        return out

    # -- def-site choice -----------------------------------------------
    def _mov(self, dst: str, src: object, width: int, fl: bool) -> Instr:
        t = f"f{width}" if fl else f"u{width}"
        return Instr(opcode=f"mov.{t}", operands=[Reg(dst), src], uid=-1)

    def _render_node(self, node: ENode, dst: str) -> Optional[Instr]:
        opcode = _RENDER.get(node.op)
        if opcode is None:
            return None
        ops: List[object] = [Reg(dst)]
        for child in node.children:
            cv = self.eg.const_of(child)
            if cv is not None:
                ops.append(Imm(cv, width=node.width))
                continue
            holder = next(
                (h for h in self.holders.holding(child)
                 if _reg_kind(self.kernel, h) == ("i", node.width)), None)
            if holder is None:
                return None
            ops.append(Reg(holder))
        # canonical operand order: ptxas prefers the register first, and
        # commutativity makes the swap free
        if node.op in ("add", "mul", "and", "or", "xor", "mad") \
                and len(ops) >= 3 \
                and isinstance(ops[1], Imm) and isinstance(ops[2], Reg):
            ops[1], ops[2] = ops[2], ops[1]
        return Instr(opcode=opcode.format(w=node.width), operands=ops, uid=-1)

    def _choose_def(self, info: InstrInfo, instr: Instr,
                    operands: List[object]) -> Optional[Instr]:
        """Cheapest realization of a pure def; ``None`` = drop it."""
        dst = info.dst
        cid = self.eg.find(info.dst_class)
        kind = _reg_kind(self.kernel, dst)
        orig = Instr(opcode=instr.opcode, operands=operands, uid=-1)
        orig_cost = instr_cost(self.profile, instr.opcode)
        # (cost, priority, instr-or-None); priority breaks ties stably
        cands: List[Tuple[float, int, Optional[Instr]]] = [
            (orig_cost, 1, orig)]
        if kind is not None:
            fl = kind[0] == "f"
            if self.holders.held.get(dst) == cid:
                cands.append((0.0, 0, None))        # value already in dst
            cv = self.eg.const_of(cid)
            if cv is not None and not fl:
                imm = Imm(cv, width=kind[1])
                mov = self._mov(dst, imm, kind[1], fl)
                cands.append((instr_cost(self.profile, mov.opcode), 2, mov))
            holder = next((h for h in self.holders.holding(cid)
                           if h != dst and _reg_kind(self.kernel, h) == kind),
                          None)
            if holder is not None:
                mov = self._mov(dst, Reg(holder), kind[1], fl)
                cands.append((instr_cost(self.profile, mov.opcode), 3, mov))
            if not fl:
                for j, node in enumerate(self.eg.nodes_of(cid)):
                    if node.width != kind[1]:
                        continue
                    alt = self._render_node(node, dst)
                    if alt is not None:
                        cands.append(
                            (instr_cost(self.profile, alt.opcode), 4 + j, alt))
        cost, _prio, chosen = min(cands, key=lambda c: (c[0], c[1]))
        if chosen is not orig:
            self.rewrites += 1
            self.delta += orig_cost - cost
        return chosen

    # -- main walk ------------------------------------------------------
    def emit(self, info: InstrInfo) -> Optional[Instr]:
        instr: Instr = info.d.instr
        if info.category == "barrier":
            self.holders.clear()
            return Instr(opcode=instr.opcode,
                         operands=list(instr.operands),
                         pred=instr.pred, uid=-1)
        operands = self._remap(info, instr.operands)
        if info.pure and info.dst_class is not None and instr.pred is None:
            chosen = self._choose_def(info, instr, operands)
            self.holders.register(info.dst, info.dst_class)
            return chosen
        out = Instr(opcode=instr.opcode, operands=operands,
                    pred=instr.pred, uid=-1)
        if info.dst is not None:
            if info.dst_class is not None and instr.pred is None:
                self.holders.register(info.dst, info.dst_class)
            else:
                self.holders.kill(info.dst)     # predicated/untracked write
        return out


def extract_kernel(kernel: Kernel, blocks: List[BlockGraph],
                   profile: TargetProfile,
                   frozen: frozenset = frozenset()) -> ExtractionResult:
    """Rebuild ``kernel``'s body from the saturated block e-graphs.

    Blocks whose ``bid`` is in ``frozen`` (JOIN-divergent regions, per
    the uniformity analysis) are emitted verbatim: holder-based CSE
    assumes every lane executes every dominating definition, which a
    divergent region does not guarantee.  Their statements carry no
    :class:`InstrInfo`, so the dead-code sweep treats them as opaque —
    reads inside still keep outside defs alive, defs inside are never
    deleted.
    """
    new_body: List[object] = []
    entries: List[Tuple[Optional[object], Optional[InstrInfo]]] = []
    rewrites = 0
    delta = 0.0
    for bg in blocks:
        if bg.bid in frozen:
            for uid in range(bg.start, bg.end + 1):
                stmt = kernel.body[uid]
                if isinstance(stmt, Label):
                    entries.append((Label(name=stmt.name, uid=-1), None))
                else:
                    entries.append((Instr(opcode=stmt.opcode,
                                          operands=list(stmt.operands),
                                          pred=stmt.pred, uid=-1), None))
            continue
        ex = _BlockExtractor(kernel, bg, profile)
        infos = iter(bg.infos)
        for uid in range(bg.start, bg.end + 1):
            stmt = kernel.body[uid]
            if isinstance(stmt, Label):
                entries.append((Label(name=stmt.name, uid=-1), None))
                continue
            info = next(infos)
            entries.append((ex.emit(info), info))
        rewrites += ex.rewrites
        delta += ex.delta

    # kernel-wide dead-code sweep over pure defs, to fixpoint
    deleted = 0
    while True:
        counts: Dict[str, int] = {}
        for stmt, info in entries:
            if not isinstance(stmt, Instr):
                continue
            if stmt.pred is not None:
                counts[stmt.pred[1]] = counts.get(stmt.pred[1], 0) + 1
            has_dst = info is None or info.d.kind not in (
                K_ST, K_BRA, K_RET, K_BARRIER, K_OTHER)
            for i, op in enumerate(stmt.operands):
                if isinstance(op, MemRef):
                    counts[op.base] = counts.get(op.base, 0) + 1
                elif isinstance(op, Reg) and not (i == 0 and has_dst):
                    counts[op.name] = counts.get(op.name, 0) + 1
        dead = False
        for i, (stmt, info) in enumerate(entries):
            if stmt is None or info is None or not info.pure:
                continue
            if not isinstance(stmt, Instr) or stmt.pred is not None:
                continue
            if counts.get(stmt.operands[0].name, 0) == 0:
                delta += instr_cost(profile, stmt.opcode)
                deleted += 1
                entries[i] = (None, info)
                dead = True
        if not dead:
            break

    for stmt, _info in entries:
        if stmt is not None:
            new_body.append(stmt)
    # count dropped def-sites (emit() returned None) as deletions too
    dropped = sum(1 for stmt, info in entries
                  if stmt is None and info is not None and info.pure) - deleted
    new_kernel = copy.copy(kernel)
    new_kernel.body = new_body
    new_kernel.renumber()
    return ExtractionResult(kernel=new_kernel, rewrites=rewrites,
                            deleted=deleted + max(0, dropped),
                            cycle_delta=delta)


def run_extract(ctx) -> None:
    """Body of the ``extract`` pass (see ``passes/stages.py``)."""
    from ..targets.registry import resolve_target
    from .verify import differential_check

    blocks = ctx.products.pop("_egraph_state", None)
    counters = ctx.products.setdefault("saturation_counters", {})
    for key in ("sat_rewrites", "sat_deleted_instrs",
                "sat_soundness_failures", "sat_cycle_delta_milli",
                "sat_divergent_blocks_frozen"):
        counters.setdefault(key, 0)
    if not blocks:
        return
    from ..analysis.uniformity import frozen_block_ids
    frozen, unfrozen = frozen_block_ids(ctx)
    counters["sat_divergent_blocks_frozen"] += len(frozen)
    if unfrozen:
        # survivor proofs released raw-JOIN blocks for extraction
        # (config.widen only); the differential gate below still
        # validates whatever the extractor does with them
        lint = ctx.products.setdefault("lint_counters", {})
        lint["lint_widened_blocks"] = \
            lint.get("lint_widened_blocks", 0) + unfrozen
    profile = resolve_target(ctx.config.target)
    result = extract_kernel(ctx.kernel, blocks, profile, frozen=frozen)
    if result.rewrites == 0 and result.deleted == 0:
        return                      # nothing changed: keep memoized analyses
    reason = differential_check(ctx.kernel, result.kernel)
    if reason is not None:
        counters["sat_soundness_failures"] += 1
        return                      # drop the rewrite, keep the original
    counters["sat_rewrites"] += result.rewrites
    counters["sat_deleted_instrs"] += result.deleted
    counters["sat_cycle_delta_milli"] += int(round(result.cycle_delta * 1000))
    ctx.replace_kernel(result.kernel)
