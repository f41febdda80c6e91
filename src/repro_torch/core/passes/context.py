"""Mirrors ``src/repro/core/passes/context.py`` (only the imports differ).

Kernel compilation context: one kernel + memoized analyses.

The :class:`KernelContext` is the substrate every middle-end pass works
on (the role ACC Saturator gives its shared emulator infrastructure):
analyses — CFG, dominators, symbolic flows, alias facts, shuffle
detection — are computed lazily on first request, memoized, and
invalidated when a transform pass rewrites the kernel.  Products (the
pipeline's externally visible outputs, e.g. the detection report) and
analysis timings survive invalidation: they are historical facts about
the run, not facts about the current kernel body.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Iterable, Optional, Tuple

from ..ptx.ir import Kernel
from ..targets import resolve_target


@dataclass(frozen=True)
class PipelineConfig:
    """Everything that changes what the middle-end produces.

    The tuple returned by :meth:`cache_token` participates in the
    content-addressed result-cache key, so any field that alters the
    output of a pass MUST be part of it.
    """

    mode: str = "ptxasw"        # codegen ablation: ptxasw | nocorner | noload
    max_delta: int = 31         # |N| bound for shuffle detection
    lane: str = "tid.x"         # the lane dimension the solver shifts along
    target: Optional[str] = None  # profile name / sm_XX; None = registry default
    selection: str = "all"      # candidate policy: all | cost
    max_flows: int = 256        # emulator: fork budget before truncation
    max_steps: int = 200_000    # emulator: step budget before truncation
    prune_flows: bool = True    # emulator: relevance-gated flow pruning
    saturate: bool = False      # equality-saturation middle-end (egraph)
    lint: str = "off"           # verify-ptx static analysis: off | warn | strict
    widen: bool = False         # survivor-proof-widened synthesis gating

    def cache_token(self) -> Tuple:
        # the target participates as its *resolved* profile name so
        # "sm_61", "pascal" and a module-directive resolution all share
        # cache entries
        return (self.mode, self.max_delta, self.lane,
                resolve_target(self.target).name, self.selection,
                self.max_flows, self.max_steps, self.prune_flows,
                self.saturate, self.lint, self.widen)


# ---------------------------------------------------------------------------
# analysis registry
# ---------------------------------------------------------------------------

AnalysisFn = Callable[["KernelContext"], Any]

ANALYSIS_REGISTRY: Dict[str, AnalysisFn] = {}


def register_analysis(name: str) -> Callable[[AnalysisFn], AnalysisFn]:
    """Register a lazily-computed, memoized kernel analysis.

    The decorated function receives the :class:`KernelContext` and may
    request other analyses through ``ctx.get`` (dependencies memoize
    transitively).
    """

    def deco(fn: AnalysisFn) -> AnalysisFn:
        if name in ANALYSIS_REGISTRY:
            raise ValueError(f"analysis {name!r} already registered")
        ANALYSIS_REGISTRY[name] = fn
        return fn

    return deco


class KernelContext:
    """One kernel travelling through the pass pipeline."""

    def __init__(self, kernel: Kernel,
                 config: Optional[PipelineConfig] = None) -> None:
        self.kernel = kernel
        self.config = config or PipelineConfig()
        self._analyses: Dict[str, Any] = {}
        self._timings: Dict[str, float] = {}
        self.products: Dict[str, Any] = {}
        self.stats: Dict[str, int] = {"computed": 0, "invalidated": 0}

    # ------------------------------------------------------------------
    def get(self, name: str) -> Any:
        """Return the analysis result, computing and memoizing on first use."""
        if name in self._analyses:
            return self._analyses[name]
        try:
            fn = ANALYSIS_REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown analysis {name!r}; registered: "
                           f"{sorted(ANALYSIS_REGISTRY)}") from None
        t0 = time.perf_counter()
        result = fn(self)
        self._analyses[name] = result
        # inclusive time (a dependent analysis's first call includes its
        # dependencies' compute time)
        self._timings[name] = self._timings.get(name, 0.0) \
            + time.perf_counter() - t0
        self.stats["computed"] += 1
        return result

    def cached(self, name: str) -> bool:
        return name in self._analyses

    def timing(self, name: str) -> float:
        return self._timings.get(name, 0.0)

    @property
    def timings(self) -> Dict[str, float]:
        return dict(self._timings)

    # ------------------------------------------------------------------
    def invalidate(self, preserves: Iterable[str] = ()) -> None:
        """Drop every memoized analysis not named in ``preserves``."""
        keep: FrozenSet[str] = frozenset(preserves)
        dropped = [n for n in self._analyses if n not in keep]
        for n in dropped:
            del self._analyses[n]
        self.stats["invalidated"] += len(dropped)

    def replace_kernel(self, new_kernel: Kernel,
                       preserves: Iterable[str] = ()) -> None:
        """Install a transformed kernel and invalidate stale analyses."""
        self.kernel = new_kernel
        self.invalidate(preserves)
