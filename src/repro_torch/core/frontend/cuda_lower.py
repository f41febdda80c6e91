"""Shuffle detection -> CUDA shuffle schedule (the GPU shuffle synthesis).

Counterpart of ``src/repro/core/frontend/pallas_lower.py``.  The same
detection that drives ``shfl.sync`` insertion on the PTX path selects
which taps of the CUDA stencil kernel's ``paper`` mode arrive through
``__shfl_sync`` instead of a global load.  The reference only checks
that the emulator's pair count and the geometric row schedule agree;
here each detected pair is mapped back to the taps its two loads read,
and the plan is ``consistent`` only if the schedule shuffles exactly
those taps, from those sources, by those deltas, up to the
duplicate-address (delta 0) pairs that geometry de-duplicates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core.driver import default_compiler
from repro_torch.core.frontend.stencil import Program, collect_loads, lower_to_ptx
from repro_torch.core.ptx.ir import Instr
from repro_torch.core.synthesis.detect import DetectionResult
from repro_torch.kernels.stencil.ref import tap_offsets
from repro_torch.kernels.stencil.stencil import (
    FetchPlan,
    RowShuffles,
    make_plan,
    shuffle_schedule,
)

#: one shuffled tap: ((array, offsets) taken, (array, offsets) held, delta)
Shuffle = Tuple[Tuple[str, Tuple[int, ...]], Tuple[str, Tuple[int, ...]], int]


@dataclass
class CudaShufflePlan:
    """Joint result: PTX-level detection + the warp's shuffle schedule."""

    program: Program
    detection: DetectionResult
    plan: FetchPlan
    schedule: List[RowShuffles]
    n_taps: int                 # unique static taps
    n_row_covered: int          # taps that arrive through a shuffle
    consistent: bool            # detected shuffles == scheduled shuffles

    @property
    def n_shuffles(self) -> int:
        return self.detection.n_shuffles


def load_taps(prog: Program) -> Dict[int, Tuple[str, Tuple[int, ...]]]:
    """Statement uid of each ``ld.global`` in ``lower_to_ptx(prog)`` -> the
    (array, tap offsets) it reads.  The lowering emits one load per
    distinct (array, index, tag), in ascending order of the key below
    (``_Emitter.emit_region_loads``), so the k-th load of the kernel is
    the k-th distinct key."""
    def order(ld):
        ix = [(x.coeffs, x.const) for x in ld.idx]
        return (ld.array, tuple(reversed(ix[1:])), ld.idx[0].const, ix[0], ld.tag)

    by_key = {order(ld): ld for ld in collect_loads(prog.expr)}
    lds = [by_key[k] for k in sorted(by_key)]
    uids = [s.uid for s in lower_to_ptx(prog).body
            if isinstance(s, Instr) and s.base == "ld" and "global" in s.parts]
    if len(uids) != len(lds):
        raise ValueError(f"{prog.name}: {len(uids)} global loads in the PTX "
                         f"for {len(lds)} distinct loads")
    return {u: (ld.array, tap_offsets(ld, prog.ndim)) for u, ld in zip(uids, lds)}


def detected_shuffles(prog: Program, detection: DetectionResult) -> List[Shuffle]:
    """The detection's pairs as the taps they move, sorted; a delta-0 pair
    (two loads of one tap) moves nothing and is left out."""
    taps = load_taps(prog)
    out = [(taps[p.dst_uid], taps[p.src_uid], p.delta) for p in detection.pairs]
    return sorted(s for s in out if not (s[2] == 0 and s[0] == s[1]))


def synthesize_cuda(prog: Program, max_delta: int = 31,
                    compiler=None) -> CudaShufflePlan:
    """Run the paper pipeline on the program's PTX lowering (symbolic
    emulation + shuffle detection), derive the per-row shuffle schedule
    and cross-check the two, tap by tap.  Kernels are built only from a
    plan whose ``consistent`` holds, so every shuffle the ``paper``
    kernel issues is one the emulator detected.

    ``compiler`` is the :class:`repro_torch.core.driver.Compiler` session
    to analyze through (defaults to the process-default session, whose
    shared result cache lets repeated plans for the same program skip
    re-emulation), as ``synthesize_tpu`` does in the reference.
    """
    # analysis-only path (emulate + detect, no codegen)
    result = (compiler or default_compiler()).analyze(
        lower_to_ptx(prog), max_delta=max_delta)
    detection = result.reports[0].detection
    try:
        plan = make_plan(prog, "paper")
    except ValueError:
        # loop-carried (Reduce) loads: no stencil geometry — these are the
        # paper's negative cases (matmul/matvec); detection must agree.
        if detection.n_shuffles:
            raise ValueError("emulator found shuffles a non-stencil "
                             "program cannot serve")
        return CudaShufflePlan(program=prog, detection=detection,
                               plan=FetchPlan("paper", []), schedule=[],
                               n_taps=0, n_row_covered=0, consistent=True)

    schedule = shuffle_schedule(plan, max_delta)
    n_taps = sum(len(f.taps) for f in plan.fetches)
    n_row_covered = sum(len(r.covered) for r in schedule)
    scheduled = sorted(((r.array, (dst,) + r.rest), (r.array, (src,) + r.rest), delta)
                       for r in schedule for dst, src, delta in r.covered)
    consistent = detected_shuffles(prog, detection) == scheduled
    return CudaShufflePlan(program=prog, detection=detection, plan=plan,
                           schedule=schedule, n_taps=n_taps,
                           n_row_covered=n_row_covered,
                           consistent=consistent)
