"""Mirrors ``src/repro/core/analysis/relational.py`` (only the imports differ).

Relational abstract interpreter over the decoded micro-op stream.

The uniformity lattice answers *whether* a value or branch may
diverge; this module answers *which lanes* are involved.  It runs a
small relational abstract domain over the shared :class:`Decoded`
micro-ops:

* **Register environment** — per CFG block entry, a map from register
  name to an affine :class:`~repro.core.symbolic.terms.Term` over
  *execution-invariant* atoms (``%tid.x``/``%laneid``/other special
  registers, kernel parameters, and interned UF applications of those).
  A register whose value cannot be expressed that way is simply absent
  ("unknown") — absence is the top element, so the domain never claims
  a false equality for loads, shuffles, or loop-carried updates.
* **Predicate environment** — ``setp`` results as
  :class:`~repro.core.symbolic.terms.Cmp` facts (and ``and/or`` pred
  logic as :class:`BoolOp` trees) so branch conditions can be
  interpreted relationally.
* **Fixpoint with widening** — block-entry environments are the
  equality-intersection of predecessor exits *and* of the block's own
  previous entry.  Any binding that changes across a loop iteration
  therefore widens straight to unknown: each ``(block, register)``
  binding moves at most twice (unvisited -> value -> unknown), which
  both terminates and makes every surviving binding a genuine loop
  invariant.  Loop heads need no separate widening operator — the
  intersection *is* the widening.

On top of the domain sit the three consumers the verifier roadmap
names:

* :func:`lanes_may` / the **survivor-set analysis** (``survivors``):
  a forward may-analysis of which lanes of a warp can be active in
  each block, with branch edges masked by the lane sets that can
  satisfy (or refute) the relational branch condition.
* The **membermask prover** (:func:`prove_shfl_masks`): at each
  ``shfl.sync`` compare the mask operand — immediate, proven-constant
  register, or an ``activemask`` result captured in the same basic
  block — against the survivor set.  Covered -> PROVEN-OK, provably
  not covered -> ERROR, otherwise the uniformity WARNING stands.
* **Refined branch classes** (``SurvivorInfo.block_level``): a branch
  whose taken or fallthrough lane set is provably empty (a vacuous
  guard) or whose condition is lane-invariant cannot actually diverge
  a warp; re-running the control-dependence taint with those branches
  declassified yields refined block levels that ``gate_pairs`` and
  e-graph extraction consume when ``config.widen`` is on.

Lane model: the solver's lane dimension (``config.lane``, default
``tid.x``) decomposes as ``32*q + lam`` with warp index ``q >= 0``
unknown and lane ``lam`` in ``[0, 32)`` — the same contiguous-warp
layout the synthesizer's ``%wid = tid.x mod width`` prologue assumes.
Arithmetic is reasoned over the integers (the repo-wide in-range
assumption documented at ``Term.resize``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from ..emulator.decode import (
    Decoded, K_ACTIVEMASK, K_BARRIER, K_BRA, K_CVT, K_CVTA, K_INT, K_LABEL,
    K_LD, K_MOV, K_PREDLOGIC, K_RET, K_SELP, K_SETP, K_SHFL, K_ST,
)
from ..passes.context import KernelContext, register_analysis
from ..ptx.ir import Imm, MemRef, Reg, SPECIAL_REGS, TYPE_WIDTH
from ..symbolic.terms import (
    BoolConst, BoolExpr, BoolOp, Cmp, Sym, Term, UF, bool_and, bool_not,
    bool_or, bool_xor, to_signed,
)
from .ops import shfl_mask_operand, stmt_defs
from .uniformity import JOIN, UNIFORM, _control_region

WARP = 32
FULL_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# abstract environment
# ---------------------------------------------------------------------------

@dataclass
class RelEnv:
    """Abstract state at one program point.

    ``regs`` maps register name -> affine Term over execution-invariant
    atoms; a register not in the map is unknown.  ``preds`` maps
    predicate register name -> BoolExpr fact.  Absence is top.
    """
    regs: Dict[str, Term] = field(default_factory=dict)
    preds: Dict[str, BoolExpr] = field(default_factory=dict)

    def copy(self) -> "RelEnv":
        return RelEnv(dict(self.regs), dict(self.preds))

    def kill(self, name: str) -> None:
        self.regs.pop(name, None)
        self.preds.pop(name, None)


def _intersect_into(dst: RelEnv, src: RelEnv) -> bool:
    """Keep only the bindings on which ``dst`` and ``src`` agree.

    Returns True when ``dst`` changed.  This is the join of the
    equality domain (and the widening: disagreement -> unknown).
    """
    changed = False
    for name in list(dst.regs):
        if src.regs.get(name) != dst.regs[name]:
            del dst.regs[name]
            changed = True
    for name in list(dst.preds):
        if src.preds.get(name) != dst.preds[name]:
            del dst.preds[name]
            changed = True
    return changed


# ---------------------------------------------------------------------------
# operand evaluation + transfer function
# ---------------------------------------------------------------------------

_SPECIAL_CONSTS = {"WARP_SZ": WARP}


def _op_term(env: RelEnv, op, width: int) -> Optional[Term]:
    """Abstract value of one source operand, or None when unknown."""
    if isinstance(op, Imm):
        if op.is_float:
            return None
        return Term.const_(op.value, width or 32)
    if isinstance(op, Reg):
        name = op.name
        if name in _SPECIAL_CONSTS:
            return Term.const_(_SPECIAL_CONSTS[name], width or 32)
        if name in SPECIAL_REGS:
            # "%tid.x" -> Sym("tid.x") — the emulators' naming convention
            return Term.sym(name[1:], width or 32)
        return env.regs.get(name)
    return None


def _pred_fact(env: RelEnv, pred: Optional[Tuple[bool, str]]) -> Optional[bool]:
    """Constant truth value of a guard predicate, if the env proves one."""
    if pred is None:
        return None
    negated, name = pred
    fact = env.preds.get(name)
    if fact is None:
        return None
    if isinstance(fact, BoolConst):
        val: Optional[bool] = fact.value
    elif isinstance(fact, Cmp):
        val = fact.eval_const()
    else:
        val = None
    if val is None:
        return None
    return (not val) if negated else val


def _int_result(d: Decoded, ops: List[Optional[Term]]) -> Optional[Term]:
    base = d.base
    if any(t is None for t in ops):
        return None
    if d.hi:
        return None
    if d.unary:
        if len(ops) != 1:
            return None
        (a,) = ops
        if base == "neg":
            return a.neg()
        if base == "not":
            return a.not_()
        return None  # abs/popc/clz/brev/bfind: drop
    if d.wide:
        if base != "mul" or len(ops) != 2:
            return None
        w2 = (d.width or 32) * 2
        return ops[0].resize(w2, d.signed).mul(ops[1].resize(w2, d.signed))
    if base == "mad" and len(ops) == 3:
        return ops[0].mul(ops[1]).add(ops[2])
    if len(ops) != 2:
        return None
    a, b = ops
    if base == "add":
        return a.add(b)
    if base == "sub":
        return a.sub(b)
    if base == "mul":
        return a.mul(b)
    if base == "div":
        return a.div(b, d.signed)
    if base == "rem":
        return a.rem(b, d.signed)
    if base == "min":
        return a.min_(b, d.signed)
    if base == "max":
        return a.max_(b, d.signed)
    if base == "shl":
        return a.shl(b)
    if base == "shr":
        return a.shr(b, d.signed)
    if base == "and":
        return a.and_(b)
    if base == "or":
        return a.or_(b)
    if base == "xor":
        return a.xor_(b)
    return None


def transfer(env: RelEnv, d: Decoded) -> None:
    """Apply one decoded statement to ``env`` in place."""
    if d.kind in (K_LABEL, K_BRA, K_RET, K_ST, K_BARRIER):
        return
    defs = stmt_defs(d)
    if not defs:
        return
    guard = _pred_fact(env, d.pred)
    if d.pred is not None and guard is not True:
        if guard is None:
            # may or may not execute: defs become unknown
            for name in defs:
                env.kill(name)
        return  # guard is False: no-op
    ops = d.operands
    w = d.width or 32

    if d.kind == K_MOV:
        src = _op_term(env, ops[1], w) if len(ops) > 1 else None
        env.kill(defs[0])
        if src is not None:
            env.regs[defs[0]] = src
        return
    if d.kind == K_LD:
        env.kill(defs[0])
        if d.space == "param" and len(ops) > 1 and isinstance(ops[1], MemRef):
            m = ops[1]
            name = m.base if not m.offset else f"{m.base}+{m.offset}"
            env.regs[defs[0]] = Term.sym(name, w)
        return
    if d.kind == K_CVTA:
        src = _op_term(env, ops[-1], w)
        env.kill(defs[0])
        if src is not None:
            env.regs[defs[0]] = src
        return
    if d.kind == K_CVT:
        fw = TYPE_WIDTH.get(d.from_t, 32)
        src = _op_term(env, ops[1], fw) if len(ops) > 1 else None
        env.kill(defs[0])
        if src is not None and (d.to_t or "")[:1] != "f" \
                and (d.from_t or "")[:1] != "f":
            tw = TYPE_WIDTH.get(d.to_t, 32)
            signed = (d.from_t or "").startswith("s")
            env.regs[defs[0]] = src.resize(tw, signed)
        return
    if d.kind == K_SETP:
        a = _op_term(env, ops[-2], w)
        b = _op_term(env, ops[-1], w)
        for name in defs:
            env.kill(name)
        if a is not None and b is not None and not d.float_cmp:
            fact: BoolExpr = Cmp(d.rel, a, b, d.cmp_signed)
            env.preds[defs[0]] = fact
            if len(defs) > 1:  # setp %p|%q dual form: %q = !%p
                env.preds[defs[1]] = fact.negate()
        return
    if d.kind == K_SELP:
        val = _pred_fact(env, (False, ops[3].name)) \
            if len(ops) > 3 and isinstance(ops[3], Reg) else None
        env.kill(defs[0])
        if val is not None:
            src = _op_term(env, ops[1] if val else ops[2], w)
            if src is not None:
                env.regs[defs[0]] = src
        return
    if d.kind == K_PREDLOGIC:
        srcs: List[Optional[BoolExpr]] = []
        for op in ops[1:]:
            if isinstance(op, Reg):
                srcs.append(env.preds.get(op.name))
            else:
                srcs.append(None)
        env.kill(defs[0])
        if any(s is None for s in srcs):
            return
        if d.base == "not" and len(srcs) == 1:
            env.preds[defs[0]] = bool_not(srcs[0])
        elif len(srcs) == 2:
            fn = {"and": bool_and, "or": bool_or, "xor": bool_xor}.get(d.base)
            if fn is not None:
                env.preds[defs[0]] = fn(srcs[0], srcs[1])
        return
    if d.kind == K_INT:
        res = _int_result(d, [_op_term(env, o, w) for o in ops[1:]])
        env.kill(defs[0])
        if res is not None:
            env.regs[defs[0]] = res
        return
    # loads from memory, shfl, activemask, float, unknown: defs unknown
    for name in defs:
        env.kill(name)


def _run_block(env: RelEnv, cfg, decoded: List[Decoded], bid: int) -> RelEnv:
    """Transfer a copy of ``env`` through block ``bid`` (ends inclusive)."""
    out = env.copy()
    blk = cfg.blocks[bid]
    for i in range(blk.start, blk.end + 1):
        transfer(out, decoded[i])
    return out


# ---------------------------------------------------------------------------
# relational fixpoint
# ---------------------------------------------------------------------------

@dataclass
class RelationalInfo:
    """Per-block entry/exit environments plus interpreted branch facts."""
    entry: List[RelEnv]
    exit: List[RelEnv]
    # conditional-branch uid -> BoolExpr that holds on the *taken* edge
    branch_cond: Dict[int, BoolExpr]
    iterations: int


@register_analysis("relational")
def _compute_relational(ctx: KernelContext) -> RelationalInfo:
    decoded: List[Decoded] = ctx.get("decoded")
    cfg = ctx.get("cfg")
    n = len(cfg.blocks)
    if n == 0:
        return RelationalInfo([], [], {}, 0)
    entry: List[Optional[RelEnv]] = [None] * n
    entry[cfg.entry] = RelEnv()

    # Worklist fixpoint.  entry[b] starts as the first reaching exit env
    # and afterwards only ever *loses* bindings (equality-intersection),
    # so each (block, binding) changes at most twice and the loop
    # terminates without a separate widening pass.
    iters = 0
    work = [cfg.entry]
    in_work = {cfg.entry}
    while work:
        bid = work.pop(0)
        in_work.discard(bid)
        iters += 1
        out = _run_block(entry[bid], cfg, decoded, bid)
        for succ in cfg.blocks[bid].succs:
            if entry[succ] is None:
                entry[succ] = out.copy()
                changed = True
            else:
                changed = _intersect_into(entry[succ], out)
            if changed and succ not in in_work:
                work.append(succ)
                in_work.add(succ)

    for i in range(n):
        if entry[i] is None:         # unreachable block
            entry[i] = RelEnv()
    exit_ = [_run_block(entry[bid], cfg, decoded, bid) for bid in range(n)]

    # interpret every conditional branch in its block's exit env — the
    # state in which the branch predicate is actually read
    branch_cond: Dict[int, BoolExpr] = {}
    for bid in range(n):
        blk = cfg.blocks[bid]
        d = decoded[blk.end]
        if d.kind != K_BRA or d.pred is None:
            continue
        negated, name = d.pred
        fact = exit_[bid].preds.get(name)
        if fact is None:
            continue
        branch_cond[d.uid] = fact.negate() if negated else fact
    return RelationalInfo(entry=entry, exit=exit_, branch_cond=branch_cond,
                          iterations=iters)


# ---------------------------------------------------------------------------
# lane-set solver
# ---------------------------------------------------------------------------

def _is_lane_low5(atom, lane: str) -> bool:
    """Does this atom denote ``lane mod 32`` (i.e. the lane id)?"""
    if not isinstance(atom, UF):
        return False
    lane_term = Term.sym(lane)
    if atom.fn in ("urem", "srem") and len(atom.args) == 2:
        return atom.args[0] == lane_term and atom.args[1].as_const == WARP
    if atom.fn == "and" and len(atom.args) == 2:
        a, b = atom.args
        return (a == lane_term and b.as_const == 31) or \
               (b == lane_term and a.as_const == 31)
    return False


def _lane_profile(t: Term, lane: str) -> Optional[Tuple[int, int, int]]:
    """Decompose ``t`` as ``wq*q + lam*λ + k`` over signed integers,
    where ``lane = 32*q + λ``, ``q >= 0``, ``λ in [0, 32)``.  Returns
    ``(wq, lam, k)`` or None when the term mentions atoms unrelated to
    the lane decomposition."""
    w = t.width
    wq = lam = 0
    for atom, c in t.coeffs.items():
        cs = to_signed(c, w)
        if isinstance(atom, Sym) and atom.name == lane:
            wq += cs * WARP
            lam += cs
        elif isinstance(atom, Sym) and atom.name == "laneid":
            lam += cs
        elif _is_lane_low5(atom, lane):
            lam += cs
        else:
            return None
    return wq, lam, to_signed(t.const, w)


def _exists_wq(rel: str, slope: int, b: int) -> bool:
    """Is there a warp index ``q >= 0`` with ``slope*q + b REL 0``?"""
    if rel == "eq":
        if slope == 0:
            return b == 0
        q, r = divmod(-b, slope)
        return r == 0 and q >= 0
    if rel == "ne":
        return slope != 0 or b != 0
    if rel == "lt":
        return True if slope < 0 else b < 0
    if rel == "le":
        return True if slope < 0 else b <= 0
    if rel == "gt":
        return True if slope > 0 else b > 0
    if rel == "ge":
        return True if slope > 0 else b >= 0
    return True


def _cmp_lanes(c: Cmp, lane: str) -> int:
    """May-set of lanes (bitmask) on which ``c`` can hold for *some*
    warp ``q >= 0`` of the grid."""
    pa = _lane_profile(c.lhs, lane)
    pb = _lane_profile(c.rhs, lane)
    if pa is None or pb is None:
        return FULL_MASK
    awq, alam, ak = pa
    bwq, blam, bk = pb
    slope = awq - bwq
    mask = 0
    for lam in range(WARP):
        a0 = alam * lam + ak
        b0 = blam * lam + bk
        diff0 = a0 - b0
        if c.signed or c.rel in ("eq", "ne"):
            hold = _exists_wq(c.rel, slope, diff0)
        elif awq >= 0 and a0 >= 0 and bwq >= 0 and b0 >= 0:
            # unsigned inequality over provably non-negative in-range
            # values: the unsigned order coincides with the integer
            # order, which covers the tid/lane guards kernels write
            hold = _exists_wq(c.rel, slope, diff0)
        elif awq == 0 and bwq == 0:
            # warp-independent but possibly negative: compare the
            # 2^w-wrapped values exactly
            m = (1 << c.lhs.width) - 1
            av, bv = a0 & m, b0 & m
            hold = {"lt": av < bv, "le": av <= bv,
                    "gt": av > bv, "ge": av >= bv}[c.rel]
        else:
            hold = True
        if hold:
            mask |= 1 << lam
    return mask


def lanes_may(expr: Optional[BoolExpr], lane: str) -> int:
    """May-set of lanes on which ``expr`` can evaluate true (bitmask).

    Unknown structure degrades to the full warp — the analysis is a
    may-analysis, so over-approximation is always sound."""
    if expr is None:
        return FULL_MASK
    if isinstance(expr, BoolConst):
        return FULL_MASK if expr.value else 0
    if isinstance(expr, Cmp):
        return _cmp_lanes(expr, lane)
    if isinstance(expr, BoolOp):
        if expr.op == "and":
            m = FULL_MASK
            for a in expr.args:
                m &= lanes_may(a, lane)
            return m
        if expr.op == "or":
            m = 0
            for a in expr.args:
                m |= lanes_may(a, lane)
            return m
    return FULL_MASK


def _lane_invariant(expr: BoolExpr, lane: str) -> bool:
    """True when every lane of a warp provably agrees on ``expr``
    (the λ-coefficients cancel, so the truth value only depends on the
    warp index and other warp-uniform state)."""
    if isinstance(expr, BoolConst):
        return True
    if isinstance(expr, Cmp):
        pa = _lane_profile(expr.lhs, lane)
        pb = _lane_profile(expr.rhs, lane)
        return pa is not None and pb is not None and pa[1] == pb[1]
    if isinstance(expr, BoolOp) and expr.op in ("and", "or", "xor", "not"):
        return all(_lane_invariant(a, lane) for a in expr.args)
    return False


# ---------------------------------------------------------------------------
# survivor sets + refined divergence levels
# ---------------------------------------------------------------------------

@dataclass
class SurvivorInfo:
    """Which lanes may be active per block, plus branch declassification."""
    lanes: List[int]                    # per block: may-active lane bitmask
    branch_class: Dict[int, int]        # refined class per conditional bra uid
    block_level: List[int]              # refined divergence level per block
    n_refined: int                      # branches declassified vs uniformity

    def proven_full(self, bid: int) -> bool:
        return self.lanes[bid] == FULL_MASK

    def contiguous_bound(self, bid: int) -> Optional[int]:
        """If the survivor set is a proper prefix ``{0..C-1}`` of the
        warp, return C; else None."""
        m = self.lanes[bid]
        if m == 0 or m == FULL_MASK:
            return None
        c = m.bit_length()
        return c if m == (1 << c) - 1 else None


@register_analysis("survivors")
def _compute_survivors(ctx: KernelContext) -> SurvivorInfo:
    decoded: List[Decoded] = ctx.get("decoded")
    cfg = ctx.get("cfg")
    info = ctx.get("uniformity")
    lane = ctx.config.lane
    n = len(cfg.blocks)
    if n == 0:
        return SurvivorInfo([], {}, [], 0)

    # fast path: no conditional branches (the straight-line shape every
    # synthesized KernelGen kernel has) means nothing can restrict the
    # lane set or be declassified — skip the relational fixpoint
    has_cond = any(
        len(cfg.blocks[b].succs) == 2
        and decoded[cfg.blocks[b].end].kind == K_BRA
        and decoded[cfg.blocks[b].end].pred is not None
        for b in range(n))
    if not has_cond:
        return SurvivorInfo(lanes=[FULL_MASK] * n,
                            branch_class=dict(info.branch_class),
                            block_level=list(info.block_level),
                            n_refined=0)

    rel: RelationalInfo = ctx.get("relational")
    # per-edge lane masks from interpreted branch conditions
    edge_mask: Dict[Tuple[int, int], int] = {}
    for bid in range(n):
        blk = cfg.blocks[bid]
        if len(blk.succs) != 2:
            continue
        d = decoded[blk.end]
        if d.kind != K_BRA or d.pred is None:
            continue
        cond = rel.branch_cond.get(d.uid)
        if cond is None:
            continue
        taken, fall = blk.succs[0], blk.succs[1]
        if taken == fall:
            continue
        edge_mask[(bid, taken)] = lanes_may(cond, lane)
        edge_mask[(bid, fall)] = lanes_may(cond.negate(), lane)

    # forward may-analysis: which lanes can reach each block
    surv = [0] * n
    surv[cfg.entry] = FULL_MASK
    work = [cfg.entry]
    in_work = {cfg.entry}
    while work:
        bid = work.pop(0)
        in_work.discard(bid)
        for succ in cfg.blocks[bid].succs:
            out = surv[bid] & edge_mask.get((bid, succ), FULL_MASK)
            new = surv[succ] | out
            if new != surv[succ]:
                surv[succ] = new
                if succ not in in_work:
                    work.append(succ)
                    in_work.add(succ)

    # declassify branches the lane solver proves non-divergent: a branch
    # with a provably one-sided condition (vacuous guard) or a provably
    # lane-invariant condition cannot split a warp
    refined: Dict[int, int] = {}
    n_refined = 0
    for uid, lvl in info.branch_class.items():
        cls = lvl
        if lvl != UNIFORM:
            bid = cfg.block_of[uid]
            cond = rel.branch_cond.get(uid)
            if cond is not None:
                reach = surv[bid]
                tk = lanes_may(cond, lane) & reach
                fl = lanes_may(cond.negate(), lane) & reach
                if tk == 0 or fl == 0 or _lane_invariant(cond, lane):
                    cls = UNIFORM
                    n_refined += 1
        refined[uid] = cls

    # recompute block levels from the refined branch classes (same
    # control-dependence taint as the uniformity analysis)
    pdom = ctx.get("postdominators")
    level = [UNIFORM] * n
    for uid, cls in refined.items():
        if cls == UNIFORM:
            continue
        bid = cfg.block_of[uid]
        for rb in _control_region(cfg, pdom, bid):
            if level[rb] < cls:
                level[rb] = cls
    return SurvivorInfo(lanes=surv, branch_class=refined,
                        block_level=level, n_refined=n_refined)


# ---------------------------------------------------------------------------
# membermask prover
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MaskProof:
    """Verdict for one ``shfl.sync`` membermask."""
    verdict: str          # "proven" | "noncovering" | "unknown"
    mask: Optional[int]   # resolved mask value when constant
    survivors: int        # may-active lane set at the shfl
    via: str              # "imm" | "const-reg" | "activemask" | ""


def prove_shfl_masks(ctx: KernelContext) -> Dict[int, MaskProof]:
    """Prove or refute the membermask of every ``shfl.sync``.

    Proof obligations per shfl in block B with survivor set S:

    * immediate/constant mask M: covered iff ``S & ~M == 0`` (every lane
      that can be active is named in the mask) -> proven; otherwise the
      mask provably strands a possibly-active lane -> noncovering.
    * register mask that is a same-block ``activemask`` result: within a
      basic block the active set cannot change (no branches), so the
      captured mask equals the active set at the shfl -> proven.  Masks
      captured in *other* blocks are not accepted: lanes may reconverge
      or exit between capture and use.
    * anything else -> unknown (the uniformity WARNING stands).
    """
    decoded: List[Decoded] = ctx.get("decoded")
    cfg = ctx.get("cfg")
    if not any(d.kind == K_SHFL and d.plain_ops == 4 for d in decoded):
        return {}
    # both analyses are fetched lazily: a full-warp immediate mask is
    # provable outright (the survivor set is always a subset of the
    # full warp), which is the only shape synthesized code emits — the
    # common case never pays for the fixpoint
    rel: Optional[RelationalInfo] = None
    surv: Optional[SurvivorInfo] = None
    empty = RelEnv()

    def _full_imm(mop) -> bool:
        return isinstance(mop, Imm) and not mop.is_float \
            and (mop.value & FULL_MASK) == FULL_MASK

    proofs: Dict[int, MaskProof] = {}
    for bid, blk in enumerate(cfg.blocks):
        sync_idx = [i for i in range(blk.start, blk.end + 1)
                    if decoded[i].kind == K_SHFL
                    and decoded[i].plain_ops == 4]
        if not sync_idx:
            continue
        if all(_full_imm(shfl_mask_operand(decoded[i]))
               for i in sync_idx):
            for i in sync_idx:
                proofs[decoded[i].uid] = MaskProof(
                    "proven", FULL_MASK, FULL_MASK, "imm")
            continue
        if surv is None:
            surv = ctx.get("survivors")
        s = surv.lanes[bid]
        if all(isinstance(shfl_mask_operand(decoded[i]), Imm)
               for i in sync_idx):
            # immediate masks need no dataflow: prove directly against
            # the survivor set
            for i in sync_idx:
                proofs[decoded[i].uid] = _prove_one(decoded[i], empty,
                                                    {}, s)
            continue
        if rel is None:
            rel = ctx.get("relational")
        env = rel.entry[bid].copy()
        amask: Dict[str, int] = {}  # reg -> defining activemask uid (this block)
        for i in range(blk.start, blk.end + 1):
            d = decoded[i]
            if d.kind == K_SHFL and d.plain_ops == 4:
                proofs[d.uid] = _prove_one(d, env, amask, s)
            # maintain the intra-block activemask provenance map
            defs = stmt_defs(d)
            src_amask: Optional[int] = None
            if d.kind == K_ACTIVEMASK and d.pred is None and defs:
                src_amask = d.uid
            elif d.kind == K_MOV and d.pred is None and len(d.operands) > 1 \
                    and isinstance(d.operands[1], Reg):
                src_amask = amask.get(d.operands[1].name)
            for name in defs:
                amask.pop(name, None)
            if src_amask is not None and defs:
                amask[defs[0]] = src_amask
            transfer(env, d)
    return proofs


def _prove_one(d: Decoded, env: RelEnv, amask: Dict[str, int],
               survivors: int) -> MaskProof:
    mop = shfl_mask_operand(d)
    if isinstance(mop, Reg) and mop.name in amask:
        return MaskProof("proven", None, survivors, "activemask")
    mval: Optional[int] = None
    via = ""
    if isinstance(mop, Imm) and not mop.is_float:
        mval = mop.value & FULL_MASK
        via = "imm"
    elif isinstance(mop, Reg):
        t = env.regs.get(mop.name)
        if t is not None and t.as_const is not None:
            mval = t.as_const & FULL_MASK
            via = "const-reg"
    if mval is None:
        return MaskProof("unknown", None, survivors, via)
    covered = (survivors & ~mval & FULL_MASK) == 0
    return MaskProof("proven" if covered else "noncovering",
                     mval, survivors, via)


# ---------------------------------------------------------------------------
# widening surface consumed by select-shuffles and egraph extract
# ---------------------------------------------------------------------------

def refined_level_of_uid(ctx: KernelContext, uid: int) -> int:
    """Divergence level of a statement under the refined (survivor-
    aware) classification."""
    cfg = ctx.get("cfg")
    surv: SurvivorInfo = ctx.get("survivors")
    if uid < 0 or uid >= len(cfg.block_of):
        return JOIN                  # out of range: refuse to prove anything
    return surv.block_level[cfg.block_of[uid]]


def refined_join_block_ids(ctx: KernelContext) -> FrozenSet[int]:
    """Block ids still JOIN-classified after survivor refinement."""
    surv: SurvivorInfo = ctx.get("survivors")
    return frozenset(
        bid for bid, lvl in enumerate(surv.block_level) if lvl == JOIN)


def survivor_clamps(ctx: KernelContext, detection) -> Dict[int, int]:
    """Per-pair clamp bounds from proven survivor prefixes.

    For a shuffle pair whose loads sit in blocks where the survivor set
    is a proper contiguous prefix ``{0..C-1}`` of the warp, the
    synthesizer can compare the runtime activemask against ``(1<<C)-1``
    instead of the full mask and tighten the down-shuffle out-of-range
    threshold to ``C-1-N`` — strictly fewer corner-case reloads than
    the paper's blanket guard.  Returns ``{dst_uid: C}``."""
    cfg = ctx.get("cfg")
    surv: SurvivorInfo = ctx.get("survivors")
    clamps: Dict[int, int] = {}
    nblocks = len(cfg.block_of)
    for p in getattr(detection, "pairs", ()):
        if not (0 <= p.dst_uid < nblocks and 0 <= p.src_uid < nblocks):
            continue
        db = cfg.block_of[p.dst_uid]
        sb = cfg.block_of[p.src_uid]
        if surv.lanes[db] != surv.lanes[sb]:
            continue  # src capture must run for the same lane set
        c = surv.contiguous_bound(db)
        if c is not None and 0 < c < WARP:
            clamps[p.dst_uid] = c
    return clamps
