"""Mirrors ``src/repro/core/analysis/uniformity.py`` (only the imports differ).

Warp-uniformity / divergence analysis.

A forward dataflow propagates *divergence* — "may this register hold
different values in different lanes of one warp?" — from the lane-
varying special registers (``%tid.*``, ``%laneid``) through arithmetic,
moves, predicates, and loads.  Parameter loads and grid-shape specials
(``%ntid.*``, ``%ctaid.*`` …) are warp-uniform; non-parameter loads and
``shfl`` results are conservatively divergent.  An unpredicated
redefinition from uniform sources *kills* divergence (the transfer is
the classic gen/kill form, so the fixpoint stays monotone); a
predicated definition under a divergent guard stays divergent even with
uniform sources (some lanes keep the old value).

Each conditional branch whose predicate is divergent is then classified
on the three-point lattice ``UNIFORM < EXIT_GUARD < JOIN``:

* **EXIT_GUARD** — at least one successor is a *pure exit*: every path
  from it reaches ``ret`` without touching memory, shuffles, or
  barriers.  This is the ubiquitous KernelGen bounds guard
  (``setp.ge; @%p bra $EXIT``): lanes that leave do nothing observable,
  so the paper's corner-case handling (full membermask + clamp) covers
  the survivors.
* **JOIN** — both sides do observable work before re-converging.  This
  is the genuinely dangerous shape: a ``shfl`` or ``bar.sync`` inside
  reads lanes that took the other side.

The *region* a divergent branch taints is its control-dependence
region: every block reachable from a successor without passing through
a postdominator of the branch block.  Blocks inherit the maximum level
over all branches that taint them, so nested divergence composes.

``select-shuffles`` and egraph ``extract`` consult :func:`gate_pairs` /
:func:`join_block_ids`: synthesis and extraction only fire in blocks at
level ``UNIFORM`` or ``EXIT_GUARD`` — never inside a JOIN region.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from ..emulator.decode import (
    K_ACTIVEMASK, K_BRA, K_LD, K_SHFL,
)
from ..passes.context import KernelContext, register_analysis
from .ops import stmt_defs, stmt_uses

# block / branch divergence levels
UNIFORM = 0
EXIT_GUARD = 1
JOIN = 2

LEVEL_NAMES = {UNIFORM: "uniform", EXIT_GUARD: "exit-guard", JOIN: "join"}

# lane-varying vs warp-uniform special registers
_DIVERGENT_SPECIALS = frozenset(("%tid.x", "%tid.y", "%tid.z", "%laneid"))
_UNIFORM_SPECIALS = frozenset((
    "%ntid.x", "%ntid.y", "%ntid.z",
    "%ctaid.x", "%ctaid.y", "%ctaid.z",
    "%nctaid.x", "%nctaid.y", "%nctaid.z",
    "WARP_SZ",
))


@dataclass
class DefUseTable:
    """Interned per-uid def/use sets, computed once per kernel.

    The dataflow fixpoints in this module and :mod:`.defuse` re-read
    each statement many times; re-deriving operand roles per visit (and
    unioning string sets) dominates lint cost, so register names are
    interned to bit positions and every fixpoint runs on int masks.
    The name tuples are kept alongside for finding messages.
    """

    names: List[str]                 # bit position -> register name
    index: Dict[str, int]            # register name -> bit position
    defs: List[Tuple[str, ...]]      # per uid, as spelled in the source
    uses: List[Tuple[str, ...]]
    defm: List[int]                  # per uid, as bit masks
    usem: List[int]

    def mask_names(self, mask: int) -> FrozenSet[str]:
        out = []
        while mask:
            low = mask & -mask
            out.append(self.names[low.bit_length() - 1])
            mask ^= low
        return frozenset(out)


@register_analysis("defuse_table")
def _compute_defuse_table(ctx: KernelContext) -> DefUseTable:
    decoded = ctx.get("decoded")
    names: List[str] = []
    index: Dict[str, int] = {}
    defs: List[Tuple[str, ...]] = []
    uses: List[Tuple[str, ...]] = []
    defm: List[int] = []
    usem: List[int] = []
    for d in decoded:
        ds = stmt_defs(d)
        us = stmt_uses(d)
        dm = um = 0
        for r in ds:
            j = index.get(r)
            if j is None:
                j = index[r] = len(names)
                names.append(r)
            dm |= 1 << j
        for r in us:
            j = index.get(r)
            if j is None:
                j = index[r] = len(names)
                names.append(r)
            um |= 1 << j
        defs.append(ds)
        uses.append(us)
        defm.append(dm)
        usem.append(um)
    return DefUseTable(names, index, defs, uses, defm, usem)


@register_analysis("postdominators")
def _compute_postdominators(ctx: KernelContext) -> Dict[int, Set[int]]:
    """Postdominator sets over ``cfg`` with a virtual exit node ``n``
    (so kernels with several ``ret`` blocks still get a meaningful
    intersection)."""
    cfg = ctx.get("cfg")
    n = len(cfg.blocks)
    if n == 0:
        return {}
    ve = n                           # virtual exit
    succs: List[List[int]] = [list(b.succs) for b in cfg.blocks]
    for b in cfg.blocks:
        if not b.succs:
            succs[b.bid].append(ve)
    full = set(range(n + 1))
    pdom: Dict[int, Set[int]] = {b: set(full) for b in range(n)}
    pdom[ve] = {ve}
    changed = True
    while changed:
        changed = False
        for bid in range(n - 1, -1, -1):
            ss = succs[bid]
            new = set(full)
            for s in ss:
                new &= pdom[s]
            if not ss:
                new = set()
            new |= {bid}
            if new != pdom[bid]:
                pdom[bid] = new
                changed = True
    return pdom


@dataclass
class UniformityInfo:
    """Result of the uniformity analysis (see module docstring)."""

    block_level: List[int]                 # per block id: UNIFORM/.../JOIN
    branch_class: Dict[int, int]           # cond-branch uid -> level
    entry_divergent: List[FrozenSet[str]]  # per block id: regs divergent at entry
    pure_exit: List[bool]                  # per block id: observable-free to ret

    def level_of_block(self, bid: int) -> int:
        return self.block_level[bid]


def _block_stmts(cfg, decoded, bid) -> Sequence:
    blk = cfg.blocks[bid]
    return decoded[blk.start:blk.end + 1]


def _special_mask(table: DefUseTable) -> int:
    """Bit mask of the lane-varying special registers this kernel reads."""
    mask = 0
    for name in _DIVERGENT_SPECIALS:
        j = table.index.get(name)
        if j is not None:
            mask |= 1 << j
    return mask


def _divergent_def(d, divmask: int, usem: int) -> bool:
    """Is the value this statement defines lane-varying, given the mask
    of currently-divergent registers (lane-varying specials folded in)?"""
    if d.kind == K_LD:
        return d.space != "param"
    if d.kind == K_SHFL:
        return True
    if d.kind == K_ACTIVEMASK:
        return False
    return bool(usem & divmask)


def _transfer_block(cfg, decoded, bid, in_mask: int,
                    table: DefUseTable, special: int) -> int:
    cur = in_mask
    blk = cfg.blocks[bid]
    defm = table.defm
    usem = table.usem
    for i in range(blk.start, blk.end + 1):
        dm = defm[i]
        if not dm:
            continue
        d = decoded[i]
        if _divergent_def(d, cur | special, usem[i]):
            cur |= dm
        elif d.pred is None:
            cur &= ~dm               # uniform unpredicated redef kills
        # predicated uniform def: old value may survive — keep as-is
    return cur


def _compute_pure_exit(cfg, decoded) -> List[bool]:
    """Greatest fixpoint: pure[b] iff block b and everything reachable
    from it does nothing observable before ``ret``."""
    from .ops import is_observable
    n = len(cfg.blocks)
    no_obs = [not any(is_observable(d) for d in _block_stmts(cfg, decoded, b))
              for b in range(n)]
    pure = [True] * n
    changed = True
    while changed:
        changed = False
        for b in range(n):
            new = no_obs[b] and all(pure[s] for s in cfg.blocks[b].succs)
            if new != pure[b]:
                pure[b] = new
                changed = True
    return pure


def _control_region(cfg, pdom, bid: int) -> Set[int]:
    """Control-dependence region of a branch at block ``bid``: blocks
    reachable from its successors without crossing a postdominator of
    ``bid``."""
    stop = set(pdom.get(bid, ())) - {bid}
    region: Set[int] = set()
    work = [s for s in cfg.blocks[bid].succs if s not in stop]
    while work:
        b = work.pop()
        if b in region:
            continue
        region.add(b)
        for s in cfg.blocks[b].succs:
            if s not in stop and s not in region:
                work.append(s)
    return region


@register_analysis("uniformity")
def _compute_uniformity(ctx: KernelContext) -> UniformityInfo:
    cfg = ctx.get("cfg")
    decoded = ctx.get("decoded")
    pdom = ctx.get("postdominators")
    table: DefUseTable = ctx.get("defuse_table")
    special = _special_mask(table)
    n = len(cfg.blocks)
    if n == 0:
        return UniformityInfo([], {}, [], [])

    # 1. divergent-register forward dataflow (merge = union over preds);
    # per-block transfer outputs are kept so each block is transferred
    # once per iteration, not once per outgoing CFG edge
    entry: List[int] = [0] * n
    out: List[int] = [
        _transfer_block(cfg, decoded, bid, 0, table, special)
        for bid in range(n)]
    changed = True
    while changed:
        changed = False
        for bid in range(n):
            if bid == cfg.entry:
                in_mask = 0
            else:
                in_mask = 0
                for p in cfg.blocks[bid].preds:
                    in_mask |= out[p]
            if in_mask != entry[bid]:
                entry[bid] = in_mask
                changed = True
                out[bid] = _transfer_block(cfg, decoded, bid, in_mask,
                                           table, special)

    # 2. classify divergent conditional branches
    pure = _compute_pure_exit(cfg, decoded)
    branch_class: Dict[int, int] = {}
    block_level = [UNIFORM] * n
    defm = table.defm
    for bid in range(n):
        blk = cfg.blocks[bid]
        last = decoded[blk.end]
        if last.kind != K_BRA or last.pred is None or len(blk.succs) < 2:
            continue
        # predicate divergence at the branch point
        cur = entry[bid]
        for i in range(blk.start, blk.end):
            dm = defm[i]
            if dm:
                d = decoded[i]
                if _divergent_def(d, cur | special, table.usem[i]):
                    cur |= dm
                elif d.pred is None:
                    cur &= ~dm
        preg = last.pred[1]
        j = table.index.get(preg)
        if not ((j is not None and (cur >> j) & 1)
                or preg in _DIVERGENT_SPECIALS):
            branch_class[last.uid] = UNIFORM
            continue
        level = EXIT_GUARD if any(pure[s] for s in blk.succs) else JOIN
        branch_class[last.uid] = level
        for b in _control_region(cfg, pdom, bid):
            if block_level[b] < level:
                block_level[b] = level

    return UniformityInfo(block_level=block_level, branch_class=branch_class,
                          entry_divergent=[table.mask_names(m) for m in entry],
                          pure_exit=pure)


# ---------------------------------------------------------------------------
# gate surface consumed by select-shuffles and egraph extract
# ---------------------------------------------------------------------------

def level_of_uid(ctx: KernelContext, uid: int) -> int:
    cfg = ctx.get("cfg")
    info: UniformityInfo = ctx.get("uniformity")
    if uid < 0 or uid >= len(cfg.block_of):
        return JOIN                  # out of range: refuse to prove anything
    return info.block_level[cfg.block_of[uid]]


def join_block_ids(ctx: KernelContext) -> FrozenSet[int]:
    """Block ids inside a JOIN-divergent region (extraction freezes these)."""
    info: UniformityInfo = ctx.get("uniformity")
    return frozenset(b for b, lv in enumerate(info.block_level) if lv == JOIN)


def frozen_block_ids(ctx: KernelContext) -> Tuple[FrozenSet[int], int]:
    """Block ids e-graph extraction must freeze, honoring ``config.widen``.

    Returns ``(frozen, n_unfrozen)``: the raw JOIN set when widening is
    off; the survivor-refined JOIN set plus how many raw-JOIN blocks the
    relational proofs released when it is on.
    """
    raw = join_block_ids(ctx)
    if not getattr(ctx.config, "widen", False) or not raw:
        return raw, 0
    from .relational import refined_join_block_ids
    refined = refined_join_block_ids(ctx)
    return refined, len(raw - refined)


def gate_pairs(ctx: KernelContext, detection) -> Tuple[object, int, int]:
    """Drop shuffle pairs whose load sits in a JOIN-divergent region.

    Returns ``(gated_detection, n_dropped, n_widened)`` — the original
    object when nothing is dropped (the common, fully-uniform case), a
    *new* ``DetectionResult`` otherwise (the input may be shared across
    target variants and must not be mutated).  With ``config.widen`` on,
    divergence levels come from the survivor-refined classification and
    ``n_widened`` counts pairs the raw JOIN gate would have dropped but
    the relational proofs kept (callers re-validate those through the
    differential concrete-emulation gate before trusting them).
    """
    pairs = getattr(detection, "pairs", None)
    if not pairs:
        return detection, 0, 0
    level = level_of_uid
    widened = 0
    if getattr(ctx.config, "widen", False):
        from .relational import refined_level_of_uid
        level = refined_level_of_uid
        widened = sum(
            1 for p in pairs
            if (level_of_uid(ctx, p.dst_uid) == JOIN
                or level_of_uid(ctx, p.src_uid) == JOIN)
            and level(ctx, p.dst_uid) != JOIN
            and level(ctx, p.src_uid) != JOIN)
    keep = [p for p in pairs
            if level(ctx, p.dst_uid) != JOIN
            and level(ctx, p.src_uid) != JOIN]
    dropped = len(pairs) - len(keep)
    if not dropped:
        return detection, 0, widened
    import dataclasses
    return dataclasses.replace(detection, pairs=keep), dropped, widened
