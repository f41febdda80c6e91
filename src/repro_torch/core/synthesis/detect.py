"""Mirrors ``src/repro/core/synthesis/detect.py`` (only the imports differ).

Shuffle detection over symbolic memory traces (paper Section 5.1).

For loads A, B in the same straight-line flow (same basic block, no
intervening may-aliasing store), find constant N with
``A(%tid.x + N) = B(%tid.x)``, |N| <= 31.  Selection rules reverse-
engineered from the paper's Table 2 deltas and Section 5.2:

* only direct global-memory 32-bit loads participate;
* a covered load cannot serve as a source ("no shuffles over shuffled
  elements");
* among eligible sources the smallest |N| wins ("least corner cases");
* the delta must agree across *all* execution flows that reach the load.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..emulator.trace import FlowResult, LoadEvent, StoreEvent
from ..ptx.ir import Kernel, Instr
from ..symbolic import Sym, solve_shift
from ..symbolic.solver import may_alias


@dataclass
class ShufflePair:
    dst_uid: int      # statement uid of the covered load
    src_uid: int      # statement uid of the source load
    delta: int        # N  (negative -> shfl.up, positive -> shfl.down)
    space: str = "global"


@dataclass
class DetectionResult:
    pairs: List[ShufflePair] = field(default_factory=list)
    n_loads: int = 0            # static global loads in the kernel
    n_flows: int = 0
    analysis_time_s: float = 0.0

    @property
    def n_shuffles(self) -> int:
        return len(self.pairs)

    @property
    def mean_abs_delta(self) -> Optional[float]:
        if not self.pairs:
            return None
        return sum(abs(p.delta) for p in self.pairs) / len(self.pairs)


def _static_global_loads(kernel: Kernel) -> int:
    n = 0
    for stmt in kernel.body:
        if isinstance(stmt, Instr) and stmt.base == "ld" \
                and "global" in stmt.parts:
            n += 1
    return n


def detect(kernel: Kernel, flows: List[FlowResult],
           lane: str = "tid.x", max_delta: int = 31,
           shared_too: bool = False) -> DetectionResult:
    t0 = time.perf_counter()
    lane_atom = Sym(lane, 32)
    spaces = ("global", "shared") if shared_too else ("global",)

    # per-flow greedy coverage
    per_flow: List[Dict[int, Tuple[int, int]]] = []  # dst_uid -> (src_uid, N)
    dst_seen_flows: Dict[int, List[Tuple[int, int]]] = {}
    for fr in flows:
        if fr.terminated == "pruned":
            continue
        chosen: Dict[int, Tuple[int, int]] = {}
        covered_srcs = set()
        loads = [e for e in fr.trace if isinstance(e, LoadEvent)
                 and e.space in spaces and e.width == 32 and not e.guarded]
        stores = [e for e in fr.trace if isinstance(e, StoreEvent)]
        for i, e in enumerate(loads):
            best: Optional[Tuple[int, int, int]] = None  # (|N|, order, src_uid, N)
            for s in loads[:i]:
                if s.stmt_uid == e.stmt_uid:
                    continue
                if s.stmt_uid in chosen:       # covered -> not a direct load
                    continue
                if s.block != e.block:         # straight-line flows only
                    continue
                if not s.nc and _store_between(stores, s, e):
                    continue
                n = solve_shift(s.addr, e.addr, lane_atom, max_delta=max_delta)
                if n is None:
                    continue
                cand = (abs(n), s.order, s.stmt_uid, n)
                if best is None or cand < best:
                    best = cand
            if best is not None:
                chosen[e.stmt_uid] = (best[2], best[3])
                covered_srcs.add(best[2])
        per_flow.append(chosen)
        for dst, (src, n) in chosen.items():
            dst_seen_flows.setdefault(dst, []).append((src, n))
        # record loads that appeared uncovered in this flow
        for e in loads:
            if e.stmt_uid not in chosen:
                dst_seen_flows.setdefault(e.stmt_uid, []).append((-1, 0))

    # cross-flow consistency: same (src, N) wherever the load executes
    pairs: List[ShufflePair] = []
    for dst, occurrences in sorted(dst_seen_flows.items()):
        first = occurrences[0]
        if first[0] == -1:
            continue
        if all(o == first for o in occurrences):
            pairs.append(ShufflePair(dst_uid=dst, src_uid=first[0],
                                     delta=first[1]))
    # sources must themselves be un-covered in the final selection
    covered = {p.dst_uid for p in pairs}
    pairs = [p for p in pairs if p.src_uid not in covered]

    return DetectionResult(
        pairs=pairs,
        n_loads=_static_global_loads(kernel),
        n_flows=len(flows),
        analysis_time_s=time.perf_counter() - t0,
    )


def _store_between(stores: List[StoreEvent], s: LoadEvent,
                   e: LoadEvent) -> bool:
    for st in stores:
        if s.order < st.order < e.order and st.space == s.space \
                and may_alias(st.addr, s.addr):
            return True
    return False
