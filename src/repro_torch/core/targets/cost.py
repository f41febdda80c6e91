"""Mirrors ``src/repro/core/targets/cost.py`` (only the imports differ).

Cost-model-guided shuffle selection (the paper's Figure 2, inverted).

The paper *measures* that shuffle synthesis is profitable on
Maxwell/Pascal (L1-hit latency ~2.5x the shuffle latency) and break-even
to harmful on Kepler/Volta (Sections 6-8).  This module turns that
observation into an optimization input: each detected
:class:`~repro.core.synthesis.detect.ShufflePair` is scored with the
per-target cycle model — the predicted per-instance cycles of keeping
the L1 load vs. of the synthesized replacement sequence — and
unprofitable candidates are dropped before codegen.

The per-pair closed form weights the event-count delta the rewrite
induces in the concrete warp emulator
(:mod:`repro.core.emulator.concrete`), with the same latency terms
:func:`repro.core.emulator.cycles.estimate_cycles` applies to those
counts; the capture ``mov`` a source shared by k *kept* pairs costs is
split k ways, so per-pair profits sum to the whole-kernel cycle delta
up to the constant 2-instruction prologue (which cannot reorder
candidates).  Because codegen emits the capture once per distinct
source *of the synthesized set*, ``select`` iterates scoring to a fixed
point: dropping a pair shrinks its sharers' split, raising the
survivors' capture share to what codegen will actually charge them —
a pair profitable only under the stale all-candidates split is
re-scored and rejected.  ``measured_profit`` closes the loop: it diffs
full concrete-emulation stats through the cycle model, which the tests
use to check the static selection against emulated reality.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import List, Union

from .profile import TargetProfile
from .registry import resolve_target


@dataclass(frozen=True)
class PairScore:
    """Predicted per-executed-instance cycles for one candidate."""

    pair: object                  # synthesis.detect.ShufflePair
    keep_load_cycles: float       # baseline: the covered L1 load stays
    shuffled_cycles: float        # rewritten: shuffle + checker + corner

    @property
    def profit(self) -> float:
        return self.keep_load_cycles - self.shuffled_cycles

    @property
    def profitable(self) -> bool:
        return self.profit > 0.0


@dataclass
class SelectionReport:
    """Outcome of the ``select-shuffles`` pass for one kernel."""

    target: str
    mode: str
    scores: List[PairScore]
    selected: object              # DetectionResult with the kept pairs

    @property
    def kept(self) -> List[object]:
        return [s.pair for s in self.scores if s.profitable]

    @property
    def dropped(self) -> List[PairScore]:
        return [s for s in self.scores if not s.profitable]

    @property
    def n_kept(self) -> int:
        return len(self.kept)

    @property
    def n_dropped(self) -> int:
        return len(self.scores) - self.n_kept

    @property
    def summary(self) -> str:
        return (f"{self.target}: kept {self.n_kept}/{len(self.scores)} "
                f"candidates (mode {self.mode})")


def score_pair(pair, profile: Union[TargetProfile, str],
               mode: str = "ptxasw", src_share: int = 1) -> PairScore:
    """Score one candidate with the target's cycle model.

    Mirrors, term by term, the event-count delta the synthesized
    sequence (codegen Listing 6) induces per executed instance of the
    covered load, weighted like ``estimate_cycles``:

    * the L1 load disappears: ``- l1 / mlp``;
    * a shuffle appears, serialized with its consumer: ``+ shfl / shfl_hide``;
    * the source capture ``mov`` costs one ALU slot, split across the
      ``src_share`` pairs reading the same capture (codegen emits it
      once per distinct source);
    * in ``ptxasw`` mode the checker (activemask + 2 setp + or.pred)
      costs 4 ALU slots, the ``|N|/warp`` corner lanes reload through
      L1, and the remaining lanes burn an issued-but-masked slot.
    """
    profile = resolve_target(profile)
    lat = profile.latency
    keep = lat["l1"] / profile.mlp
    n = abs(pair.delta)
    capture = profile.alu_cost / max(src_share, 1)
    if mode == "noload":          # covered load deleted outright
        return PairScore(pair, keep, 0.0)
    if n == 0:                    # degenerate: plain mov from the capture
        return PairScore(pair, keep, profile.alu_cost + capture)
    cost = lat["shfl"] / profile.shfl_hide + capture
    if mode == "ptxasw":
        corner = min(n / profile.warp_width, 1.0)
        cost += 4 * profile.alu_cost
        cost += corner * keep
        cost += (1.0 - corner) * profile.pred_off_cost
    return PairScore(pair, keep, cost)


def select(detection, target: Union[TargetProfile, str, None] = None,
           mode: str = "ptxasw") -> SelectionReport:
    """Drop the candidates the target's cycle model predicts to lose.

    Scoring iterates to a fixed point over the *kept* set: the capture
    ``mov`` is split across the pairs codegen will actually synthesize,
    so each drop re-scores the dropped pair's surviving sharers with
    their larger capture share.  Convergence is guaranteed — a shrinking
    share only raises a pair's cost, so drops are monotone and the loop
    runs at most once per candidate.  A dropped pair keeps the
    (unprofitable) score it was rejected with; survivors carry the
    final-iteration scores, whose profits sum to what codegen emits.
    """
    from ..synthesis.detect import DetectionResult

    pairs = list(detection.pairs)
    profile = resolve_target(target)
    kept = set(range(len(pairs)))
    scores: dict = {}
    while True:
        sharers = Counter(pairs[i].src_uid for i in kept)
        for i in kept:
            scores[i] = score_pair(pairs[i], profile, mode=mode,
                                   src_share=sharers[pairs[i].src_uid])
        dropped = {i for i in kept if not scores[i].profitable}
        if not dropped:
            break
        kept -= dropped
    selected = DetectionResult(pairs=[pairs[i] for i in sorted(kept)],
                               n_loads=detection.n_loads,
                               n_flows=detection.n_flows,
                               analysis_time_s=detection.analysis_time_s)
    return SelectionReport(target=profile.name, mode=mode,
                           scores=[scores[i] for i in range(len(pairs))],
                           selected=selected)


def measured_profit(base_stats, variant_stats,
                    target: Union[TargetProfile, str, None] = None) -> float:
    """Cycles saved by ``variant`` over ``base`` per the target's model,
    from *concrete-emulation* event counts (positive = variant wins)."""
    from ..emulator.cycles import estimate_cycles

    profile = resolve_target(target)
    return (estimate_cycles(base_stats, profile).cycles
            - estimate_cycles(variant_stats, profile).cycles)


# ---------------------------------------------------------------------------
# static per-instruction costs (equality-saturation extraction)
# ---------------------------------------------------------------------------

#: a register-to-register ``mov`` is charged this fraction of an ALU op —
#: on every modeled generation it is eliminated by renaming more often
#: than it issues, and pricing it below the cheapest computation is what
#: lets the extractor prefer "reuse an existing register" over
#: "recompute" without a special case
MOV_FACTOR = 0.5

_FLOAT_TYPES = ("f16", "f32", "f64")
_SLOW_FLOAT = ("div", "sqrt", "rsqrt", "rcp", "sin", "cos", "lg2", "ex2",
               "tanh")
_FREE_BASES = ("ret", "exit", "bar", "membar", "fence")


def int_mul_factor(profile: TargetProfile) -> float:
    """Integer multiply/mad throughput penalty relative to simple ALU:
    pre-Volta chips (sm < 70) quarter-rate the 32-bit IMAD path, newer
    ones half-rate it — which is why ``x*2^k -> x<<k`` strength
    reduction pays more on Kepler/Maxwell/Pascal than on Hopper."""
    return 4.0 if profile.sm < 70 else 2.0


def static_instr_cost(profile: TargetProfile, base: str, *,
                      tsuf: str = None, space: str = None,
                      nc: bool = False, parts=()) -> float:
    """Predicted issue+latency cost of one straight-line instruction.

    The same latency terms the shuffle selector uses (`score_pair`):
    loads amortize their hit latency over the profile's memory-level
    parallelism, shuffles over the shuffle ILP window, ALU ops cost the
    profile's issue weights.  This is the extraction objective for the
    e-graph middle-end — deltas of these costs, not absolute cycles.
    """
    lat = profile.latency
    if base == "ld":
        if space in ("param", "const"):
            return profile.alu_cost
        if space in ("shared", "local"):
            return lat["sm"] / profile.mlp
        return lat["l1"] / profile.mlp
    if base == "st":
        return profile.alu_cost
    if base == "shfl":
        return lat["shfl"] / profile.shfl_hide
    if base == "bra":
        return profile.branch_cost
    if base in _FREE_BASES:
        return 0.0
    if base == "mov":
        return profile.alu_cost * MOV_FACTOR
    if tsuf in _FLOAT_TYPES or base == "fma":
        if base in _SLOW_FLOAT:
            return 4.0 * profile.falu_cost
        return profile.falu_cost
    if base in ("mul", "mad"):
        return profile.alu_cost * int_mul_factor(profile)
    if base in ("div", "rem"):
        return profile.alu_cost * 8.0
    return profile.alu_cost
