"""Mirrors ``src/repro/core/passes/analyses.py`` (only the imports differ).

Built-in kernel analyses for the pass-manager middle-end.

Each analysis is a pure function of the current kernel (plus the
pipeline config) registered under a stable name:

=============  ==========================================================
``cfg``        basic blocks + successor/predecessor edges
``dominators`` per-block dominator sets (iterative dataflow over ``cfg``)
``flows``      symbolic execution flows from the Section-4 emulator
``alias``      per-flow may-alias facts between stores and earlier loads
``detection``  shuffle pairs (Section 5.1) over ``flows``
=============  ==========================================================

Transform passes invalidate these through
:meth:`~repro.core.passes.context.KernelContext.replace_kernel`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from ..emulator.machine import emulate
from ..emulator.trace import FlowResult, LoadEvent, StoreEvent
from ..ptx.ir import Instr, Label, LabelRef
from ..symbolic.solver import may_alias
from .context import KernelContext, register_analysis


# ---------------------------------------------------------------------------
# control-flow graph
# ---------------------------------------------------------------------------

@dataclass
class BasicBlock:
    bid: int
    start: int                      # first statement uid (inclusive)
    end: int                        # last statement uid (inclusive)
    succs: List[int] = field(default_factory=list)
    preds: List[int] = field(default_factory=list)


@dataclass
class CFG:
    blocks: List[BasicBlock]
    block_of: List[int]             # statement uid -> block id

    @property
    def entry(self) -> int:
        return 0


@register_analysis("decoded")
def _compute_decoded(ctx: KernelContext):
    """The pre-decoded micro-op stream (uids == body indices), shared by
    the symbolic emulator, the e-graph construction, and the static
    analyzers — ``Decoded`` is never mutated after decode."""
    from ..emulator.decode import decode_kernel
    ctx.kernel.renumber()
    return decode_kernel(ctx.kernel)


@register_analysis("cfg")
def _compute_cfg(ctx: KernelContext) -> CFG:
    kernel = ctx.kernel
    kernel.renumber()
    body = kernel.body
    labels = kernel.labels()

    # block boundaries: a block starts at every label and after every
    # terminator (bra/ret/exit) — same partition the emulator uses.
    block_of: List[int] = []
    bid = 0
    for stmt in body:
        if isinstance(stmt, Label) and block_of and block_of[-1] == bid:
            # label opens a new block unless we are already at a boundary
            bid += 1
        block_of.append(bid)
        if isinstance(stmt, Instr) and stmt.base in ("bra", "ret", "exit"):
            bid += 1

    n_blocks = (max(block_of) + 1) if block_of else 0
    blocks = [BasicBlock(bid=i, start=-1, end=-1) for i in range(n_blocks)]
    for uid, b in enumerate(block_of):
        if blocks[b].start < 0:
            blocks[b].start = uid
        blocks[b].end = uid

    # edges
    for blk in blocks:
        last = body[blk.end]
        fallthrough = blk.bid + 1 if blk.bid + 1 < n_blocks else None
        if isinstance(last, Instr) and last.base == "bra":
            target_op = last.operands[0]
            if isinstance(target_op, LabelRef) and target_op.name in labels:
                blk.succs.append(block_of[labels[target_op.name]])
            if last.pred is not None and fallthrough is not None:
                blk.succs.append(fallthrough)      # conditional: both edges
        elif isinstance(last, Instr) and last.base in ("ret", "exit"):
            # predicated ret/exit falls through when the guard is false
            if last.pred is not None and fallthrough is not None:
                blk.succs.append(fallthrough)
        elif fallthrough is not None:
            blk.succs.append(fallthrough)
    for blk in blocks:
        for s in blk.succs:
            if blk.bid not in blocks[s].preds:
                blocks[s].preds.append(blk.bid)
    return CFG(blocks=blocks, block_of=block_of)


@register_analysis("dominators")
def _compute_dominators(ctx: KernelContext) -> Dict[int, Set[int]]:
    """Classic iterative dominator sets: dom(b) = {b} ∪ ⋂ dom(preds)."""
    cfg: CFG = ctx.get("cfg")
    n = len(cfg.blocks)
    if n == 0:
        return {}
    full = set(range(n))
    dom: Dict[int, Set[int]] = {b: set(full) for b in range(n)}
    dom[cfg.entry] = {cfg.entry}
    changed = True
    while changed:
        changed = False
        for blk in cfg.blocks[1:]:
            preds = [p for p in blk.preds if p != blk.bid]
            new = set(full)
            for p in preds:
                new &= dom[p]
            if not preds:
                new = set()
            new |= {blk.bid}
            if new != dom[blk.bid]:
                dom[blk.bid] = new
                changed = True
    return dom


# ---------------------------------------------------------------------------
# symbolic flows + alias facts
# ---------------------------------------------------------------------------

@register_analysis("flows")
def _compute_flows(ctx: KernelContext) -> List[FlowResult]:
    cfg = ctx.config
    # counters are published as a product: they are a historical fact
    # about this run (they survive kernel replacement) and feed the
    # compile-result observability surface + benchmark snapshots
    return emulate(ctx.kernel,
                   counters=ctx.products.setdefault("emulator_counters", {}),
                   max_flows=cfg.max_flows, max_steps=cfg.max_steps,
                   prune_flows=cfg.prune_flows,
                   ops=ctx.get("decoded"))


@dataclass
class AliasFacts:
    """Per-flow may-alias relations between stores and earlier loads.

    ``clobbers[flow_id]`` maps a load's trace order to the trace orders
    of later same-space stores that :func:`may_alias` its address — the
    facts :func:`repro.core.synthesis.detect._store_between` consults
    when rejecting shuffle pairs.
    """

    clobbers: Dict[int, Dict[int, Tuple[int, ...]]]

    def clobbered(self, flow_id: int, load_order: int) -> Tuple[int, ...]:
        return self.clobbers.get(flow_id, {}).get(load_order, ())


@register_analysis("alias")
def _compute_alias(ctx: KernelContext) -> AliasFacts:
    clobbers: Dict[int, Dict[int, Tuple[int, ...]]] = {}
    for fr in ctx.get("flows"):
        per_load: Dict[int, Tuple[int, ...]] = {}
        loads = [e for e in fr.trace if isinstance(e, LoadEvent)]
        stores = [e for e in fr.trace if isinstance(e, StoreEvent)]
        for ld in loads:
            hits = tuple(st.order for st in stores
                         if st.order > ld.order and st.space == ld.space
                         and may_alias(st.addr, ld.addr))
            if hits:
                per_load[ld.order] = hits
        clobbers[fr.flow_id] = per_load
    return AliasFacts(clobbers=clobbers)


@register_analysis("detection")
def _compute_detection(ctx: KernelContext):
    # late import: repro.core.synthesis.__init__ imports the legacy
    # pipeline wrapper, which imports this package
    from ..synthesis.detect import detect
    return detect(ctx.kernel, ctx.get("flows"), lane=ctx.config.lane,
                  max_delta=ctx.config.max_delta)
