"""Mirrors ``src/repro/core/driver/options.py`` (only the imports differ).

Session configuration for the :class:`~repro.core.driver.Compiler`.

:class:`CompilerOptions` supersedes the ad-hoc ``PipelineConfig`` +
keyword plumbing of the free-function era: one frozen dataclass holds
both the *pipeline* knobs (everything that changes what the middle-end
emits — these forward into :class:`~repro.core.passes.PipelineConfig`
and therefore into the content-addressed cache key) and the *session*
knobs (worker pool size, cache sizing, global-cache opt-in, pass-list
override) that change how a compile runs but never what it produces.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from ..passes.context import PipelineConfig

#: CompilerOptions fields that map 1:1 onto PipelineConfig (the cache
#: key); everything else is session-scoped execution policy.
PIPELINE_FIELDS: Tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(PipelineConfig))


@dataclass(frozen=True)
class CompilerOptions:
    """Everything a compile session needs, in one place.

    Pipeline knobs (participate in the result-cache key):

    * ``mode`` — codegen ablation: ``ptxasw`` | ``nocorner`` | ``noload``
    * ``max_delta`` — ``|N|`` bound for shuffle detection
    * ``lane`` — the lane dimension the solver shifts along
    * ``target`` — profile name / ``sm_XX``; ``None`` = registry default
      (or the module's own ``.target`` directive)
    * ``selection`` — candidate policy: ``all`` | ``cost``
    * ``max_flows`` / ``max_steps`` — symbolic-emulator fork/step budgets;
      when either truncates emulation the compile carries a ``warning``
      diagnostic (results from a truncated emulation are incomplete, so
      the budgets key the cache)
    * ``prune_flows`` — relevance-gated flow pruning in the emulator
      (on by default: drops forked flows that provably cannot reach a
      memory/shuffle instruction *or* a block label, so neither trace
      events nor block-entry memoization can observe the difference)
    * ``saturate`` — opt-in equality-saturation middle-end: the
      ``saturate``/``extract`` passes run between flow emulation and
      shuffle detection, rewriting each kernel to the target profile's
      cheapest equivalent straight-line form (every rewrite is gated by
      differential concrete emulation; a failed gate keeps the original
      body and emits a WARNING diagnostic)
    * ``lint`` — ``verify-ptx`` static analysis: ``off`` (default) |
      ``warn`` (run the analyzer, surface findings as diagnostics at
      their native severity) | ``strict`` (same, but WARNING-or-worse
      findings escalate to ERROR diagnostics).  Findings ride each
      ``KernelReport`` and the JSON wire form; the uniformity *gate*
      inside ``select-shuffles``/``extract`` is always on regardless
      of this knob — it is a soundness property, not a diagnostic
    * ``widen`` — opt-in proof-widened synthesis: gate decisions use
      the relational abstract interpreter's survivor-refined divergence
      levels instead of the raw uniformity lattice (a vacuous or
      lane-invariant guard no longer drops pairs or freezes blocks),
      and proven contiguous survivor prefixes tighten the synthesized
      corner-case clamps.  Every widened decision is re-validated by
      the differential concrete-emulation gate; a failed gate falls
      back to the unwidened synthesis and counts
      ``lint_widening_reverted``.  Off (default) keeps codegen
      byte-identical to the unwidened gate

    Session knobs (execution policy, never part of the cache key):

    * ``jobs`` — worker threads for per-kernel / per-target fan-out
      (``None`` = one per unit, capped at CPUs) and for the
      ``submit()``/``compile_many()`` pool (``None`` = the executor
      default, ``min(32, cpus + 4)``)
    * ``cache_entries`` — LRU capacity of the session-scoped cache
    * ``cache_dir`` — directory of the disk-backed cache tier (default
      off).  When the session builds its own private cache and this is
      unset, the ``REPRO_CACHE_DIR`` environment variable is honored;
      sessions on a shared or caller-supplied cache (``cache=`` /
      ``share_global_cache=True``) never attach a disk tier, so
      combining those with an explicit ``cache_dir`` is a ``ValueError``
      and the environment variable does not apply to them
    * ``share_global_cache`` — opt this session into the process-wide
      ``GLOBAL_CACHE`` instead of a private cache
    * ``passes`` — pass-list override, honored by ``compile`` and
      ``analyze`` alike (``variants`` rejects it: its prefix-sharing
      depends on the stock prefix/tail split); ``None`` = the stock
      middle-end (``compile``) or the analysis-only prefix (``analyze``)
    """

    mode: str = "ptxasw"
    max_delta: int = 31
    lane: str = "tid.x"
    target: Optional[str] = None
    selection: str = "all"
    max_flows: int = 256
    max_steps: int = 200_000
    prune_flows: bool = True
    saturate: bool = False
    lint: str = "off"
    widen: bool = False

    jobs: Optional[int] = None
    cache_entries: int = 4096
    cache_dir: Optional[str] = None
    share_global_cache: bool = False
    passes: Optional[Tuple[str, ...]] = None

    def __post_init__(self) -> None:
        # normalize any sequence to a tuple so the field is hashable
        # everywhere it participates in keys (compile_many dedup)
        if self.passes is not None and not isinstance(self.passes, tuple):
            object.__setattr__(self, "passes", tuple(self.passes))
        if self.lint not in ("off", "warn", "strict"):
            raise ValueError(f"lint must be 'off', 'warn' or 'strict', "
                             f"got {self.lint!r}")

    def pipeline_config(self) -> PipelineConfig:
        """The pipeline-facing view (what keys the result cache)."""
        return PipelineConfig(
            **{name: getattr(self, name) for name in PIPELINE_FIELDS})

    def replace(self, **changes) -> "CompilerOptions":
        """``dataclasses.replace`` with field-name validation."""
        names = {f.name for f in dataclasses.fields(self)}
        unknown = set(changes) - names
        if unknown:
            raise TypeError(f"unknown CompilerOptions field(s) "
                            f"{sorted(unknown)}; valid: {sorted(names)}")
        return dataclasses.replace(self, **changes)

    def with_pipeline_config(self, config: PipelineConfig) -> "CompilerOptions":
        """Overlay every field of an explicit ``PipelineConfig``."""
        return dataclasses.replace(
            self, **{name: getattr(config, name) for name in PIPELINE_FIELDS})
