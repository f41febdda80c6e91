"""Mirrors ``src/repro/core/emulator/observe.py`` (only the imports differ).

Observation extraction from concrete-emulation statistics.

The cycle model (:mod:`repro.core.emulator.cycles`) and the calibration
harness (:mod:`repro.core.targets.calibrate`) consume the same
observation model: the raw :class:`~repro.core.emulator.concrete.RunStats`
event counts grouped into the feature vector the closed-form latency
model weights.  Keeping the grouping here — next to the emulator that
produces the counts — means a new event class (say, L2 misses) is added
in exactly one place and every consumer (cycle estimation, profile
fitting, benchmark reporting) picks it up.

Features:

* ``l1``   — events served by the L1/global path: global loads *and*
  stores (``estimate_cycles`` weights stores with the L1 latency);
* ``sm``   — shared-memory reads;
* ``shfl`` — warp shuffles;
* ``alu`` / ``falu`` / ``branch`` / ``pred_off`` — issue-side events
  weighted with the profile's per-instruction costs (compiler
  constants, not measured latencies).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from .concrete import RunStats

#: feature names, in the order the calibration design matrix uses them
MODEL_FEATURES: Tuple[str, ...] = (
    "l1", "sm", "shfl", "alu", "falu", "branch", "pred_off")

#: the subset weighted by fitted latencies (the rest use issue costs)
LATENCY_FEATURES: Tuple[str, ...] = ("l1", "sm", "shfl")


def extract_features(stats: RunStats) -> Dict[str, float]:
    """Group raw event counts into the cycle model's feature vector."""
    c = stats.counts
    return {
        "l1": float(c.get("load_global", 0) + c.get("store_global", 0)
                    + c.get("store_shared", 0)),
        "sm": float(c.get("load_shared", 0)),
        "shfl": float(c.get("shfl", 0)),
        "alu": float(c.get("alu", 0)),
        "falu": float(c.get("falu", 0)),
        "branch": float(c.get("branch", 0)),
        "pred_off": float(c.get("pred_off", 0)),
    }


@dataclass(frozen=True)
class Observation:
    """One measured microbenchmark: a feature vector plus its cycles.

    ``kind`` records how the kernel exercises the hardware, which decides
    how the model's hiding factors apply when fitting:

    * ``"latency"`` — a serialized dependent chain (pointer chase /
      shuffle chain): every event waits for the previous one, so
      latencies contribute *unhidden* (divisor 1);
    * ``"throughput"`` — independent streams: loads overlap up to the
      profile's ``mlp``, shuffles up to ``shfl_hide``, exactly as
      :func:`~repro.core.emulator.cycles.estimate_cycles` scores them.
    """

    name: str
    kind: str                       # "latency" | "throughput"
    features: Dict[str, float] = field(default_factory=dict)
    cycles: float = 0.0

    def feature(self, name: str) -> float:
        return self.features.get(name, 0.0)
