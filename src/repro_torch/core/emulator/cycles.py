"""Mirrors ``src/repro/core/emulator/cycles.py`` (only the imports differ).

Latency cycle model calibrated on the paper's Table 1.

Substitutes for wall-clock GPU runs in this environment: the concrete
warp emulator (:mod:`repro.core.emulator.concrete`) produces executed-
event counts per kernel version (Original / NO LOAD / NO CORNER /
PTXASW), and this model weights them with the per-architecture
latencies each :class:`~repro.core.targets.TargetProfile` carries
(Table 1 [16, 33] for the measured generations) to reproduce the
*structure* of Figure 2: which versions win on which generation, and
why (Section 8's analysis: Maxwell/Pascal have L1-hit latencies ~2.5x
the shuffle latency, Kepler/Volta do not).

This is a latency-weighted throughput model, not a simulator: each
event class contributes its latency divided by the architecture's
ability to hide it (ILP slots); numbers are meaningful as *ratios*
between versions on one architecture, exactly how the paper uses
Figure 2.  All architecture data comes from the target registry
(:mod:`repro.core.targets`) — add a profile there and every consumer
(this model, the selection pass, codegen, the benchmarks) picks it up.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Union

from ..targets import TargetProfile, all_targets, resolve_target
from .concrete import RunStats
from .observe import extract_features


@dataclasses.dataclass
class CycleReport:
    arch: str
    cycles: float
    breakdown: Dict[str, float]


def cycles_from_features(features: Dict[str, float],
                         arch: Union[str, TargetProfile],
                         hidden: bool = True) -> float:
    """The model's closed form over an extracted feature vector.

    This is the single expression both :func:`estimate_cycles` and the
    calibration fitter (:mod:`repro.core.targets.calibrate`) evaluate:
    latency-weighted memory/shuffle events divided by the profile's
    hiding factors, plus issue-cost terms.  ``hidden=False`` scores a
    serialized dependent chain (a latency-probe microbenchmark), where
    every event waits for its predecessor and nothing is hidden.
    """
    p = resolve_target(arch)
    lat = p.latency
    load_div = p.mlp if hidden else 1.0
    shfl_div = p.shfl_hide if hidden else 1.0
    g = features.get
    return (g("l1", 0.0) * lat["l1"] / load_div
            + g("sm", 0.0) * lat["sm"] / load_div
            + g("shfl", 0.0) * lat["shfl"] / shfl_div
            + g("alu", 0.0) * p.alu_cost
            + g("falu", 0.0) * p.falu_cost
            + g("branch", 0.0) * p.branch_cost
            + g("pred_off", 0.0) * p.pred_off_cost)


def estimate_cycles(stats: RunStats,
                    arch: Union[str, TargetProfile]) -> CycleReport:
    p = resolve_target(arch)
    lat = p.latency
    counts = stats.counts
    br: Dict[str, float] = {}
    br["load_global"] = counts.get("load_global", 0) * lat["l1"] / p.mlp
    br["load_shared"] = counts.get("load_shared", 0) * lat["sm"] / p.mlp
    br["store"] = (counts.get("store_global", 0)
                   + counts.get("store_shared", 0)) * lat["l1"] / p.mlp
    # shuffles serialize with their consumers (execution dependency,
    # Section 8.1) — hidden less well than loads
    br["shfl"] = counts.get("shfl", 0) * lat["shfl"] / p.shfl_hide
    br["alu"] = counts.get("alu", 0) * p.alu_cost
    br["falu"] = counts.get("falu", 0) * p.falu_cost
    br["branch"] = counts.get("branch", 0) * p.branch_cost
    br["pred_off"] = counts.get("pred_off", 0) * p.pred_off_cost
    # the total is the shared closed form over the extracted features
    # (the breakdown above only splits the l1 term into loads/stores)
    return CycleReport(arch=p.name,
                       cycles=cycles_from_features(extract_features(stats), p),
                       breakdown=br)


def speedup_table(stats_by_version: Dict[str, RunStats],
                  targets: Optional[Sequence[Union[str, TargetProfile]]] = None
                  ) -> Dict[str, Dict[str, float]]:
    """Figure-2-style table: arch -> version -> speedup vs original.

    ``targets`` defaults to every registered profile.  Raises
    :class:`ValueError` when the ``"original"`` baseline is missing; a
    version whose estimated cycles are 0 reports ``inf`` (or 1.0 when
    the baseline is also 0) instead of dividing by zero.
    """
    if "original" not in stats_by_version:
        raise ValueError(
            "speedup_table needs an 'original' baseline version; got "
            f"{sorted(stats_by_version)}")
    profiles = ([resolve_target(t) for t in targets]
                if targets is not None else all_targets())
    out: Dict[str, Dict[str, float]] = {}
    for p in profiles:
        base = estimate_cycles(stats_by_version["original"], p).cycles
        row: Dict[str, float] = {}
        for version, stats in stats_by_version.items():
            cycles = estimate_cycles(stats, p).cycles
            if cycles == 0.0:
                row[version] = math.inf if base > 0.0 else 1.0
            else:
                row[version] = base / cycles
        out[p.name] = row
    return out
