"""Mirrors ``src/repro/core/analysis/ops.py`` (only the imports differ).

Def/use extraction over the shared :class:`Decoded` micro-op stream.

Every analysis in this package walks the same pre-decoded statements the
emulators execute, so the def/use conventions live here once:

* ``stmt_defs`` — registers written by a statement (``shfl`` has a dual
  destination: the value register plus an optional done-predicate).
* ``stmt_uses`` — registers read: source operands, memory-operand base
  registers, and the guard predicate.
* ``is_observable`` — does the statement touch machine state beyond
  registers (memory, shuffles, barriers)?  Parameter loads are *not*
  observable: they read immutable kernel arguments.
"""

from __future__ import annotations

from typing import Tuple

from ..emulator.decode import (
    Decoded, K_BARRIER, K_BRA, K_LABEL, K_LD, K_RET, K_SETP, K_SHFL, K_ST,
)
from ..ptx.ir import MemRef, Reg

_NO_DEF_KINDS = frozenset((K_LABEL, K_BRA, K_RET, K_ST, K_BARRIER))


def shfl_pred_dst(d: Decoded):
    """The optional ``shfl`` done-predicate destination, or ``None``."""
    if d.kind != K_SHFL:
        return None
    rest = d.operands[1:]
    if len(rest) > d.plain_ops and isinstance(rest[0], Reg):
        return rest[0].name
    return None


def shfl_mask_operand(d: Decoded):
    """The membermask operand of a ``shfl.sync`` (last plain operand), or
    ``None`` for the legacy 3-operand form."""
    if d.kind != K_SHFL or d.plain_ops != 4:
        return None
    return d.operands[-1]


def stmt_defs(d: Decoded) -> Tuple[str, ...]:
    """Register names written by this statement."""
    if d.kind in _NO_DEF_KINDS or not d.operands:
        return ()
    out = []
    first = d.operands[0]
    if isinstance(first, Reg):
        out.append(first.name)
    if d.kind == K_SETP:
        # dual form: setp.lt.s32 %p|%q, a, b  — parser keeps both as Regs
        if len(d.operands) > 3 and isinstance(d.operands[1], Reg) \
                and d.operands[1].name.startswith("%p"):
            out.append(d.operands[1].name)
    elif d.kind == K_SHFL:
        p = shfl_pred_dst(d)
        if p is not None:
            out.append(p)
    return tuple(out)


def stmt_uses(d: Decoded) -> Tuple[str, ...]:
    """Register names read by this statement (sources, memory bases,
    guard predicate)."""
    out = []
    if d.pred is not None:
        out.append(d.pred[1])
    if d.kind in (K_LABEL, K_RET):
        return tuple(out)
    # skip written operands only: the value dst, the setp dual dst, and
    # the shfl done-predicate.  A register that is both source and dst
    # (add %r5, %r5, 1) must still count as a use.
    skip = {id(d.operands[0])} if d.operands else set()
    if d.kind in (K_ST, K_BRA, K_BARRIER):
        skip = set()
    elif d.kind == K_SETP and len(stmt_defs(d)) > 1:
        skip.add(id(d.operands[1]))
    elif d.kind == K_SHFL and shfl_pred_dst(d) is not None:
        skip.add(id(d.operands[1]))
    for op in d.operands:
        if id(op) in skip:
            continue
        if isinstance(op, Reg):
            out.append(op.name)
        elif isinstance(op, MemRef):
            out.append(op.base)
    return tuple(out)


def is_observable(d: Decoded) -> bool:
    """True when the statement touches state beyond private registers."""
    if d.kind == K_LD:
        return d.space != "param"
    if d.kind in (K_ST, K_SHFL):
        return True
    if d.kind == K_BARRIER:
        return d.base == "bar"
    if d.kind is None:
        return False
    # unknown opcodes (atom/red/vote/...) are conservatively observable
    return d.base in ("atom", "red", "vote", "match")
