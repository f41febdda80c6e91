"""Mirrors ``src/repro/core/analysis/sync.py`` (only the imports differ).

Synchronization checker: barriers and shuffles vs divergence.

``bar.sync`` semantics require every (non-exited) thread of the CTA to
arrive: executing one inside a JOIN-divergent region — where lanes of a
single warp took different sides of a data-dependent branch and both
sides do observable work — is a deadlock on pre-Volta hardware and
undefined behaviour after (ERROR).  Under a divergent *exit guard* the
exited threads never arrive either; real kernels do this deliberately
only when the guard is grid-shaped, so it is flagged as a WARNING, not
an ERROR.

``shfl``/``shfl.sync`` reads another lane's register: inside a JOIN
region the source lane may be executing the other side (ERROR).  The
``.sync`` membermask must cover every active lane.  Since the
relational abstract interpreter landed, coverage is *decided* whenever
the mask is a compile-time constant (immediate or proven-constant
register) or a same-block ``activemask`` capture: the mask is checked
against the survivor set — the statically-possible active lane set —
and reported as a ``membermask-proven`` NOTE or a
``membermask-noncovering`` ERROR.  Only masks the prover cannot
resolve keep the constant-mask ``membermask-unprovable`` WARNING.  Divergence
levels are likewise the survivor-refined ones, so a vacuous or
lane-invariant guard no longer manufactures a false divergent-shfl or
divergent-barrier report.
"""

from __future__ import annotations

from typing import Dict, List

from ..driver.result import Severity
from ..emulator.decode import K_BARRIER, K_SHFL
from ..passes.context import KernelContext
from ..ptx.ir import Imm, Reg
from .findings import Finding
from .ops import shfl_mask_operand
from .uniformity import EXIT_GUARD, JOIN, LEVEL_NAMES, UniformityInfo

FULL_MASK = 0xFFFFFFFF


def _mask_detail(mask) -> str:
    if isinstance(mask, Imm):
        return f"mask:{mask.value:#x}"
    if isinstance(mask, Reg):
        return f"mask:{mask.name}"
    return "mask:?"


def lint_sync(ctx: KernelContext) -> List[Finding]:
    cfg = ctx.get("cfg")
    decoded = ctx.get("decoded")
    info: UniformityInfo = ctx.get("uniformity")
    out: List[Finding] = []

    # The relational machinery only runs when it can change a verdict.
    # Proofs: any sync-form shfl (the prover itself is lazy — full-warp
    # immediate masks are proven without the fixpoint).  Refined
    # levels: only when a barrier/shfl sits at a raw-JOIN block, where
    # declassification could rescue a false divergence ERROR —
    # refinement only ever *lowers* levels, so non-JOIN sites cannot
    # change verdict.  Straight-line kernels (the whole pre-synthesis
    # KernelGen corpus) skip everything, keeping lint inside its E1
    # wall budget.
    has_shfl_sync = any(d.kind == K_SHFL and d.plain_ops == 4
                        for d in decoded)
    proofs: Dict[int, object] = {}
    if has_shfl_sync:
        from .relational import prove_shfl_masks
        proofs = prove_shfl_masks(ctx)
    levels = info.block_level
    if any((d.kind == K_SHFL or (d.kind == K_BARRIER and d.base == "bar"))
           and d.uid is not None and d.uid < len(cfg.block_of)
           and levels[cfg.block_of[d.uid]] == JOIN for d in decoded):
        from . import relational  # noqa: F401  (registers "survivors")
        levels = ctx.get("survivors").block_level

    for d in decoded:
        if d.uid is None:
            continue
        level = levels[cfg.block_of[d.uid]] \
            if d.uid < len(cfg.block_of) else JOIN

        if d.kind == K_BARRIER and d.base == "bar":
            if level == JOIN:
                out.append(Finding(
                    "divergent-barrier", Severity.ERROR,
                    f"bar.sync inside a {LEVEL_NAMES[JOIN]}-divergent "
                    "region: lanes on the other side of the branch never "
                    "arrive (deadlock)", uid=d.uid))
            elif level == EXIT_GUARD:
                out.append(Finding(
                    "guarded-barrier", Severity.WARNING,
                    "bar.sync under a divergent exit guard: exited "
                    "threads never arrive at the barrier", uid=d.uid))
            continue

        if d.kind != K_SHFL:
            continue

        if level == JOIN:
            out.append(Finding(
                "divergent-shfl", Severity.ERROR,
                "shfl inside a join-divergent region: the source lane "
                "may be executing the other side of the branch",
                uid=d.uid))
            continue

        mask = shfl_mask_operand(d)
        if mask is None:
            # legacy pre-sync shfl: implicit full warp; under an exit
            # guard that is the paper's clamp-handled corner case
            if level == EXIT_GUARD:
                out.append(Finding(
                    "shfl-exit-guard", Severity.NOTE,
                    "legacy shfl under a divergent exit guard relies on "
                    "clamp semantics for exited lanes", uid=d.uid))
            continue

        proof = proofs.get(d.uid)
        verdict = getattr(proof, "verdict", "unknown")
        if verdict == "proven":
            extra = " (exit-guarded region: clamp semantics cover " \
                    "exited lanes)" if level == EXIT_GUARD else ""
            how = proof.via
            shown = f"{proof.mask:#x}" if proof.mask is not None \
                else "activemask"
            out.append(Finding(
                "membermask-proven", Severity.NOTE,
                f"shfl.sync membermask {shown} proven ({how}) to cover "
                f"the possible active set {proof.survivors:#x}{extra}",
                uid=d.uid, detail=_mask_detail(mask)))
        elif verdict == "noncovering":
            out.append(Finding(
                "membermask-noncovering", Severity.ERROR,
                f"shfl.sync membermask {proof.mask:#x} strands possibly-"
                f"active lanes {proof.survivors & ~proof.mask & FULL_MASK:#x}"
                " (proven by survivor-set analysis)",
                uid=d.uid, detail=_mask_detail(mask)))
        elif isinstance(mask, Imm):
            # prover unavailable (e.g. skipped): the constant-mask rule
            if (mask.value & FULL_MASK) != FULL_MASK:
                out.append(Finding(
                    "membermask-noncovering", Severity.ERROR,
                    f"shfl.sync membermask {mask} does not provably "
                    "cover all active lanes", uid=d.uid,
                    detail=_mask_detail(mask)))
            elif level == EXIT_GUARD:
                out.append(Finding(
                    "shfl-exit-guard", Severity.NOTE,
                    "full-mask shfl.sync under a divergent exit guard "
                    "relies on clamp semantics for exited lanes",
                    uid=d.uid, detail=_mask_detail(mask)))
        elif isinstance(mask, Reg):
            out.append(Finding(
                "membermask-unprovable", Severity.WARNING,
                f"shfl.sync membermask in register {mask.name} cannot "
                "be proven to cover the active lanes", uid=d.uid,
                detail=_mask_detail(mask)))
    return out
