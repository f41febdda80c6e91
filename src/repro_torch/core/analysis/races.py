"""Mirrors ``src/repro/core/analysis/races.py`` (only the imports differ).

Shared-memory race detection over symbolic affine address forms.

The emulator already gives every ``.shared`` access a symbolic affine
address (coefficients over interned atoms, including the lane symbol
the shuffle solver shifts along).  A store→load pair on ``.shared``
within one flow is a *cross-thread* communication unless the two
addresses are provably the same thread's same location — i.e. identical
affine forms with a non-zero lane coefficient, so lane *i* always reads
back exactly what lane *i* wrote.  Everything else (differing forms,
or lane-invariant addresses that all threads share) requires a
``bar.sync`` between the store and the load; without one that
*dominates* the load (and is dominated by the store's block), the read
may observe the pre-store value — a data race (WARNING: the emulator
cannot prove the dynamic schedule, only the absence of the barrier).
"""

from __future__ import annotations

from typing import List, Tuple

from ..driver.result import Severity
from ..emulator.decode import K_BARRIER, K_ST
from ..emulator.trace import LoadEvent, StoreEvent
from ..passes.context import KernelContext
from ..symbolic.terms import Sym
from .findings import Finding


def _same_thread_same_addr(st_addr, ld_addr, lane_atom) -> bool:
    if st_addr is None or ld_addr is None:
        return False
    if getattr(st_addr, "coeffs", None) is None \
            or getattr(ld_addr, "coeffs", None) is None:
        return False
    if st_addr.coeffs != ld_addr.coeffs or st_addr.const != ld_addr.const:
        return False
    # identical affine forms: private to the lane only if the lane
    # participates (coefficient != 0); a lane-invariant address is one
    # location shared by all threads
    return st_addr.coeffs.get(lane_atom, 0) != 0


def _barrier_between(cfg, dom, barrier_uids, st_uid: int, ld_uid: int) -> bool:
    """Is some ``bar.sync`` on every path from the store to the load?

    Approximation: a barrier in the store's own block after the store
    (and before the load when they share a block), or a barrier block
    that the store's block dominates and that dominates the load's
    block."""
    if not barrier_uids:
        return False
    b_st = cfg.block_of[st_uid]
    b_ld = cfg.block_of[ld_uid]
    for m in barrier_uids:
        b_m = cfg.block_of[m]
        if b_st == b_ld:
            if b_m == b_st and st_uid < m < ld_uid:
                return True
            continue
        if b_m == b_st and m < st_uid:
            continue
        if b_m == b_ld and m > ld_uid:
            continue
        if b_st in dom.get(b_m, ()) and b_m in dom.get(b_ld, ()):
            return True
    return False


def lint_races(ctx: KernelContext) -> List[Finding]:
    decoded = ctx.get("decoded")
    barrier_uids = [d.uid for d in decoded
                    if d.kind == K_BARRIER and d.base == "bar"]
    # cheap syntactic pre-check: a kernel with no .shared store cannot
    # race, and skipping it avoids forcing symbolic emulation when the
    # linter runs standalone (CLI / POST /lint on shared-free kernels)
    if not any(d.kind == K_ST and d.space == "shared" for d in decoded):
        return []
    flows = ctx.get("flows")
    cfg = ctx.get("cfg")
    dom = ctx.get("dominators")
    lane_atom = Sym(ctx.config.lane, 32)

    seen: set = set()
    out: List[Finding] = []
    for fr in flows:
        if fr.terminated == "pruned":
            continue
        shared = [e for e in fr.trace
                  if isinstance(e, (LoadEvent, StoreEvent))
                  and e.space == "shared"]
        stores = [e for e in shared if isinstance(e, StoreEvent)]
        loads = [e for e in shared if isinstance(e, LoadEvent)]
        for st in stores:
            for ld in loads:
                if ld.order <= st.order:
                    continue
                key: Tuple[int, int] = (st.stmt_uid, ld.stmt_uid)
                if key in seen:
                    continue
                if _same_thread_same_addr(st.addr, ld.addr, lane_atom):
                    continue
                if _barrier_between(cfg, dom, barrier_uids,
                                    st.stmt_uid, ld.stmt_uid):
                    continue
                seen.add(key)
                out.append(Finding(
                    "shared-race", Severity.WARNING,
                    f"cross-thread .shared load may race the store at "
                    f"uid:{st.stmt_uid} (no dominating bar.sync between "
                    "them)", uid=ld.stmt_uid, detail=f"st:{st.stmt_uid}"))
    return out
