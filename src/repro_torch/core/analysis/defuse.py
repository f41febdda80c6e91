"""Mirrors ``src/repro/core/analysis/defuse.py`` (only the imports differ).

Def-use verifier: use-before-def, dead stores, width/type checks.

* **use-before-def** (ERROR ``undef-use``) — a declared register is read
  at a point no definition *may* reach on any path (including back
  edges: a loop counter that feeds itself is reachable through the back
  edge and stays clean).  This is a MAY analysis by design — it only
  flags registers that are provably never written before the use.
* **dead store** (NOTE ``dead-store``) — an unpredicated pure register
  definition (ALU / mov / cvt / setp) whose value no path ever reads.
  Memory and shuffle results are exempt (their side effects are the
  point).
* **width / type-class mismatch** — the declared register class vs the
  instruction's type suffix.  A register *narrower* than the
  instruction width is a WARNING (``width-mismatch``; PTX widens
  narrow loads into wide registers legally, never the reverse); a
  same-width float↔integer reinterpretation is a NOTE (``type-class``)
  because NVCC-emitted code does it deliberately (``.b``-typed
  declarations are wildcards and match everything).  ``.wide``
  multiplies write a double-width destination; ``cvt``/``cvta`` convert
  by definition and are exempt.
"""

from __future__ import annotations

from typing import List, Optional

from ..driver.result import Severity
from ..emulator.decode import (
    K_CVT, K_CVTA, K_FLOAT, K_INT, K_LD, K_MOV, K_PREDLOGIC, K_SELP,
    K_SETP, K_ST,
)
from ..passes.context import KernelContext
from ..ptx.ir import SPECIAL_REGS, TYPE_WIDTH, Reg
from .findings import Finding
from .ops import stmt_defs, stmt_uses

# kinds whose unpredicated, unread definitions are safely deletable —
# the same notion of purity the e-graph extractor's dead-code sweep uses
_PURE_DEF_KINDS = frozenset((
    K_MOV, K_INT, K_FLOAT, K_SELP, K_CVT, K_CVTA, K_SETP, K_PREDLOGIC,
))

_SPECIALS = frozenset(SPECIAL_REGS)


def _type_class(ptype: Optional[str]) -> Optional[str]:
    """'f' (float) / 'i' (signed+unsigned int) / None (wildcard .b, pred,
    or unknown)."""
    if not ptype or ptype == "pred" or ptype.startswith("b"):
        return None
    return "f" if ptype.startswith("f") else "i"


def lint_defuse(ctx: KernelContext) -> List[Finding]:
    kernel = ctx.kernel
    cfg = ctx.get("cfg")
    decoded = ctx.get("decoded")
    table = ctx.get("defuse_table")
    defm, usem = table.defm, table.usem
    n = len(cfg.blocks)
    out: List[Finding] = []

    # one declaration lookup per distinct register name per lint run:
    # None = not checkable (special / undeclared), else (type, width)
    _ri_memo: dict = {}

    def reg_info(name: str):
        if name in _ri_memo:
            return _ri_memo[name]
        if not name.startswith("%") or name in _SPECIALS:
            v = None
        else:
            t = kernel.reg_type(name)
            v = None if t is None else (t, TYPE_WIDTH[t])
        _ri_memo[name] = v
        return v

    # bit mask of the names the def-use checks may report on: string
    # shape only (``%`` and not special) — whether the register is
    # actually declared is confirmed lazily via ``reg_info`` on the few
    # surviving candidates, so clean kernels never pay declaration
    # lookups for the def-use checks at all
    cand_mask = 0
    for j, name in enumerate(table.names):
        if name.startswith("%") and name not in _SPECIALS:
            cand_mask |= 1 << j

    def block_range(bid):
        blk = cfg.blocks[bid]
        return range(blk.start, blk.end + 1)

    # per-block gen masks, hoisted out of the fixpoint loops
    block_defs: List[int] = []
    for bid in range(n):
        acc = 0
        for i in block_range(bid):
            acc |= defm[i]
        block_defs.append(acc)

    # ------------------------------------------------------------------
    # use-before-def: MAY-reaching definitions (union merge, no kill)
    # ------------------------------------------------------------------
    maydef_out: List[int] = [0] * n
    changed = True
    while changed:
        changed = False
        for bid in range(n):
            acc = block_defs[bid]
            for p in cfg.blocks[bid].preds:
                acc |= maydef_out[p]
            if acc != maydef_out[bid]:
                maydef_out[bid] = acc
                changed = True

    reported = 0
    for bid in range(n):
        cur = 0
        for p in cfg.blocks[bid].preds:
            cur |= maydef_out[p]
        for i in block_range(bid):
            fresh = usem[i] & cand_mask & ~(cur | reported)
            if fresh:
                for u in table.uses[i]:
                    if not (fresh >> table.index[u]) & 1 \
                            or reg_info(u) is None:
                        continue
                    reported |= 1 << table.index[u]
                    out.append(Finding(
                        "undef-use", Severity.ERROR,
                        f"register {u} is read but never defined on any "
                        "path from the kernel entry", uid=decoded[i].uid))
            cur |= defm[i]

    # ------------------------------------------------------------------
    # dead stores: backward MAY-liveness
    # ------------------------------------------------------------------
    live_in: List[int] = [0] * n

    def back_transfer(bid, live: int) -> int:
        for i in reversed(block_range(bid)):
            if decoded[i].pred is None:
                live &= ~defm[i]
            live |= usem[i]
        return live

    changed = True
    while changed:
        changed = False
        for bid in range(n - 1, -1, -1):
            lo = 0
            for s in cfg.blocks[bid].succs:
                lo |= live_in[s]
            new = back_transfer(bid, lo)
            if new != live_in[bid]:
                live_in[bid] = new
                changed = True

    for bid in range(n):
        live = 0
        for s in cfg.blocks[bid].succs:
            live |= live_in[s]
        for i in reversed(block_range(bid)):
            d = decoded[i]
            dm = defm[i]
            if (dm and d.pred is None and d.kind in _PURE_DEF_KINDS
                    and not dm & live and not dm & ~cand_mask
                    and all(reg_info(r) is not None for r in table.defs[i])):
                out.append(Finding(
                    "dead-store", Severity.NOTE,
                    f"value of {', '.join(table.defs[i])} is never read "
                    "on any path", uid=d.uid))
            if d.pred is None:
                live &= ~dm
            live |= usem[i]

    # ------------------------------------------------------------------
    # declaration width / type-class vs instruction suffix
    # ------------------------------------------------------------------
    for d in decoded:
        if d.tsuf is None:
            continue
        if d.kind == K_LD:
            targets = [d.operands[0]] if d.operands else []
        elif d.kind == K_ST:
            targets = [op for op in d.operands[1:2] if isinstance(op, Reg)]
        elif d.kind in (K_INT, K_FLOAT, K_MOV):
            targets = [d.operands[0]] if d.operands else []
        else:
            continue
        expected = d.width * 2 if (d.kind == K_INT and d.wide) else d.width
        for op in targets:
            if not isinstance(op, Reg):
                continue
            ri = reg_info(op.name)
            if ri is None:
                continue
            rtype, rwidth = ri
            if rwidth < expected:
                out.append(Finding(
                    "width-mismatch", Severity.WARNING,
                    f"{op.name} is declared .{rtype} ({rwidth}-bit) but "
                    f"{d.base}.{d.tsuf} needs a {expected}-bit register",
                    uid=d.uid))
                continue
            icls = _type_class(d.tsuf)
            rcls = _type_class(rtype)
            if icls and rcls and icls != rcls:
                out.append(Finding(
                    "type-class", Severity.NOTE,
                    f"{op.name} is declared .{rtype} but used as "
                    f".{d.tsuf} ({'float' if icls == 'f' else 'integer'} "
                    "reinterpretation)", uid=d.uid))

    out.sort(key=lambda f: (f.uid if f.uid is not None else -1, f.code))
    return out
