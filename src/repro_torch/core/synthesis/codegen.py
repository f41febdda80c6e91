"""Mirrors ``src/repro/core/synthesis/codegen.py`` (only the imports differ).

Shuffle code generation (paper Section 5.2, Listing 6), target-aware.

Rewrites the kernel body:

* prologue (shared among shuffles): ``%wid = %tid.x % warp_width``
* after each source load: ``mov`` capturing the loaded value
* each covered load is replaced by::

      activemask.b32 %m;                      (ptxasw mode)
      setp.ne.s32  %incomplete, %m, -1;
      setp.lt.u32  %oor, %wid, |N|;           (.up;  .down uses gt, W-1-N)
      or.pred      %pred, %incomplete, %oor;
      shfl.sync.up.b32 %dst, %src, |N|, 0, 0xffffffff;   (sm_70+)
      shfl.up.b32      %dst, %src, |N|, 0;               (sm_3x/5x/6x)
      @%pred ld.global... %dst, [addr];       (corner cases only)

  ``N = 0`` degenerates to a plain ``mov`` (no shuffle).

The target profile (:mod:`repro.core.targets`) decides the encoding:
sm_70+ targets use ``shfl.sync`` with the full membermask, earlier
generations the legacy unsynchronized ``shfl``; the warp width comes
from the profile instead of literal 31/32.

Modes reproduce the paper's ablations: ``ptxasw`` (full), ``nocorner``
(shuffle only, no checker — invalid at boundaries), ``noload`` (covered
loads deleted — perf bound, invalid results).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Union

from ..ptx.ir import Imm, Instr, Kernel, Label, MemRef, Reg
from ..targets import TargetProfile, resolve_target
from .detect import DetectionResult, ShufflePair

MODES = ("ptxasw", "nocorner", "noload")


def synthesize(kernel: Kernel, detection: DetectionResult,
               mode: str = "ptxasw",
               target: Union[TargetProfile, str, None] = None,
               clamps: Optional[Dict[int, int]] = None) -> Kernel:
    """Rewrite covered loads into shuffle sequences.

    ``clamps`` (optional, ``{dst_uid: C}``) carries survivor-prefix
    proofs from the relational analyzer: for a covered load whose block
    provably only ever runs lanes ``{0..C-1}``, the incomplete-warp
    check compares the activemask against ``(1<<C)-1`` instead of the
    full mask (so guarded-but-complete warps keep the shuffle fast
    path) and a down-shuffle's out-of-range threshold tightens from
    ``W-1-N`` to ``C-1-N``.  Without ``clamps`` (the default) the
    output is byte-identical to the blanket corner-case handling.
    """
    assert mode in MODES
    profile = resolve_target(target)
    width = profile.warp_width
    out = copy.deepcopy(kernel)
    if not detection.pairs:
        out.renumber()
        return out

    src_capture: Dict[int, str] = {}   # src stmt uid -> capture register
    by_dst: Dict[int, ShufflePair] = {p.dst_uid: p for p in detection.pairs}

    wid = out.new_reg("u32", hint="sflwid")
    prologue: List[Instr] = [
        Instr("mov.u32", [Reg(wid), Reg("%tid.x")]),
        Instr("rem.u32", [Reg(wid), Reg(wid), Imm(width)]),
    ]
    # the full-warp membermask assumes every lane reaches the shuffle;
    # on real sm_70+ hardware an incomplete warp (exited lanes named in
    # the mask) is undefined behaviour there, which is why the paper's
    # Listing 6 passes the activemask register instead — the ptxasw
    # checker below still detects incomplete warps and reloads, so the
    # emulated data semantics are identical either way
    membermask = Imm(profile.full_membermask, hex=True)

    # allocate capture regs per distinct source
    for p in detection.pairs:
        if p.src_uid not in src_capture:
            src_instr = kernel.body[p.src_uid]
            t = src_instr.type_suffix() or "b32"
            src_capture[p.src_uid] = out.new_reg(t, hint="sflsrc")

    new_body: List[object] = []
    needs_prologue = mode in ("ptxasw", "nocorner")
    placed_prologue = False
    for stmt in kernel.body:
        if isinstance(stmt, Label):
            new_body.append(Label(stmt.name))
            continue
        instr = stmt
        if needs_prologue and not placed_prologue:
            new_body.extend(prologue)
            placed_prologue = True
        if instr.uid in by_dst:
            pair = by_dst[instr.uid]
            cap = src_capture[pair.src_uid]
            t = instr.type_suffix() or "b32"
            dst = instr.operands[0]
            assert isinstance(dst, Reg)
            if mode == "noload":
                # covered load eliminated entirely (perf bound)
                if instr.uid in src_capture:
                    new_body.append(copy.deepcopy(instr))
                    new_body.append(Instr(f"mov.{t}",
                                          [Reg(src_capture[instr.uid]), dst]))
                continue
            if pair.delta == 0:
                new_body.append(Instr(f"mov.{t}", [dst, Reg(cap)]))
                continue
            n = pair.delta
            # survivor-prefix clamp: only meaningful at the native
            # 32-lane warp, and a down-shuffle whose every surviving
            # source lane has exited (C <= N) must keep the blanket
            # guard (the tightened threshold would stop firing)
            c = (clamps or {}).get(instr.uid)
            if c is not None and (width != 32 or (n > 0 and c - 1 - n < 0)):
                c = None
            pair_mask = membermask if c is None else Imm((1 << c) - 1,
                                                         hex=True)
            if mode == "ptxasw":
                # the checker needs the active mask to detect incomplete
                # warps (final-warp corner case, paper Listing 6)
                mask = out.new_reg("b32", hint="sflm")
                inc = out.new_reg("pred", hint="sflinc")
                oor = out.new_reg("pred", hint="sfloor")
                pred = out.new_reg("pred", hint="sflp")
                new_body.append(Instr("activemask.b32", [Reg(mask)]))
                # "incomplete warp" = active set != the expected full
                # set: the profile's whole warp (bitwise identical to
                # the historical -1 compare at warp width 32), or the
                # proven survivor prefix when a clamp applies
                new_body.append(Instr("setp.ne.s32",
                                      [Reg(inc), Reg(mask), pair_mask]))
                if n < 0:
                    new_body.append(Instr("setp.lt.u32",
                                          [Reg(oor), Reg(wid), Imm(-n)]))
                else:
                    bound = width - 1 - n if c is None else c - 1 - n
                    new_body.append(Instr("setp.gt.u32",
                                          [Reg(oor), Reg(wid), Imm(bound)]))
                new_body.append(Instr("or.pred",
                                      [Reg(pred), Reg(inc), Reg(oor)]))
            if n < 0:
                shfl_ops = [dst, Reg(cap), Imm(-n), Imm(0)]
                shfl_dir = "up"
            else:
                shfl_ops = [dst, Reg(cap), Imm(n), Imm(width - 1)]
                shfl_dir = "down"
            if profile.has_shfl_sync:
                # a clamped pair names exactly the proven survivor set
                # in its membermask — which the static prover can then
                # re-verify against the same survivor analysis
                new_body.append(Instr(f"shfl.sync.{shfl_dir}.b32",
                                      shfl_ops + [pair_mask]))
            else:
                new_body.append(Instr(f"shfl.{shfl_dir}.b32", shfl_ops))
            if mode == "ptxasw":
                corner = copy.deepcopy(instr)
                corner.pred = (False, pred)
                new_body.append(corner)
            continue
        new_body.append(copy.deepcopy(instr))
        if instr.uid in src_capture:
            t = instr.type_suffix() or "b32"
            dst = instr.operands[0]
            new_body.append(Instr(f"mov.{t}",
                                  [Reg(src_capture[instr.uid]), dst]))
    out.body = new_body
    out.renumber()
    return out
