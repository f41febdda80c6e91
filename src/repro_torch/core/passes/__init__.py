"""Mirrors ``src/repro/core/passes/__init__.py`` (only the imports differ).

Pass-manager middle-end: the extensible PTXASW compiler pipeline.

Public API::

    from repro_torch.core.passes import (
        compile_kernel, compile_module, compile_ptx, analyze_kernel,
        compile_for_targets, TargetVariant,
        KernelContext, PipelineConfig, PassPipeline, register_pass,
        register_analysis, GLOBAL_CACHE,
    )

The ``compile_*`` / ``analyze_kernel`` free functions are thin
delegating shims over one default :class:`repro.core.driver.Compiler`
session (which shares the process-wide result cache, preserving their
historical caching behaviour); ``compile_for_targets`` delegates to
``Compiler.variants``.  New code should construct its own ``Compiler``
— session-scoped cache, explicit job pool, structured
``CompileResult`` — instead of these tuple-returning wrappers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..ptx.ir import Kernel, Module
from ..targets import TargetProfile
from .analyses import AliasFacts, BasicBlock, CFG  # noqa: F401
from .cache import CacheStats, CompileCache, GLOBAL_CACHE  # noqa: F401
from .diskcache import DiskCache  # noqa: F401
from .context import (  # noqa: F401
    ANALYSIS_REGISTRY,
    KernelContext,
    PipelineConfig,
    register_analysis,
)
from .manager import (  # noqa: F401
    ANALYSIS_PASSES,
    DEFAULT_PASSES,
    SYNTHESIS_PASSES,
    KernelReport,
    PASS_REGISTRY,
    Pass,
    PassPipeline,
    default_pipeline,
    register_pass,
    set_default_jobs,
)
from . import stages  # noqa: F401  (registers the built-in passes)

__all__ = [
    "ANALYSIS_PASSES",
    "ANALYSIS_REGISTRY",
    "AliasFacts",
    "BasicBlock",
    "CFG",
    "CacheStats",
    "CompileCache",
    "DEFAULT_PASSES",
    "DiskCache",
    "GLOBAL_CACHE",
    "KernelContext",
    "KernelReport",
    "PASS_REGISTRY",
    "Pass",
    "PassPipeline",
    "PipelineConfig",
    "SYNTHESIS_PASSES",
    "TargetVariant",
    "analyze_kernel",
    "compile_for_targets",
    "compile_kernel",
    "compile_module",
    "compile_ptx",
    "default_pipeline",
    "register_analysis",
    "register_pass",
    "set_default_jobs",
]


def _session():
    """The default driver session (lazy import: driver imports us)."""
    from ..driver import default_compiler
    return default_compiler()


def _check_exclusive(config, pipeline) -> None:
    """``config=`` and ``pipeline=`` both carry a PipelineConfig; taking
    both used to silently drop ``config`` — now it is a hard error."""
    if config is not None and pipeline is not None:
        raise ValueError(
            "pass either config= or pipeline=, not both (a pipeline "
            "already carries its own PipelineConfig)")


def compile_kernel(kernel: Kernel, config: Optional[PipelineConfig] = None,
                   *, cache: Optional[CompileCache] = GLOBAL_CACHE,
                   pipeline: Optional[PassPipeline] = None
                   ) -> Tuple[Kernel, KernelReport]:
    """Run one kernel through the (default) middle-end pipeline."""
    _check_exclusive(config, pipeline)
    if pipeline is not None:
        return pipeline.run_kernel(kernel, cache=cache)
    res = _session().compile(kernel, config, cache=cache)
    return res.module.kernels[0], res.reports[0]


def compile_module(module: Module, config: Optional[PipelineConfig] = None,
                   *, jobs: Optional[int] = None,
                   cache: Optional[CompileCache] = GLOBAL_CACHE,
                   pipeline: Optional[PassPipeline] = None
                   ) -> Tuple[Module, List[KernelReport]]:
    """Compile a whole module (kernels in parallel, directives preserved)."""
    _check_exclusive(config, pipeline)
    if pipeline is not None:
        return pipeline.run_module(module, jobs=jobs, cache=cache)
    res = _session().compile(module, _with_jobs(config, jobs), cache=cache)
    return res.module, res.reports


def compile_ptx(ptx_text: str, config: Optional[PipelineConfig] = None,
                *, jobs: Optional[int] = None,
                cache: Optional[CompileCache] = GLOBAL_CACHE
                ) -> Tuple[str, List[KernelReport]]:
    """PTX text in, synthesized PTX text out (the assembler-wrapper path)."""
    res = _session().compile(ptx_text, _with_jobs(config, jobs), cache=cache)
    return res.ptx, res.reports


def analyze_kernel(kernel: Kernel, config: Optional[PipelineConfig] = None,
                   *, jobs: Optional[int] = None,
                   cache: Optional[CompileCache] = GLOBAL_CACHE,
                   pipeline: Optional[PassPipeline] = None
                   ) -> KernelReport:
    """Emulate + detect only (no synthesis); returns the report."""
    _check_exclusive(config, pipeline)
    if pipeline is not None:
        _, report = pipeline.run_kernel(kernel, cache=cache)
        return report
    res = _session().analyze(kernel, _with_jobs(config, jobs), cache=cache)
    return res.reports[0]


def _with_jobs(config: Optional[PipelineConfig], jobs: Optional[int]):
    """Bridge the legacy ``jobs=`` kwarg into a per-call options object."""
    if jobs is None:
        return config
    from ..driver import CompilerOptions
    opts = CompilerOptions(jobs=jobs)
    return opts.with_pipeline_config(config) if config is not None else opts


@dataclasses.dataclass
class TargetVariant:
    """One architecture's synthesized module."""

    target: TargetProfile
    ptx: str
    reports: List[KernelReport]

    @property
    def n_shuffles(self) -> int:
        return sum(r.detection.n_shuffles for r in self.reports
                   if r.detection is not None)


def compile_for_targets(ptx_text: str,
                        targets: Optional[Sequence[
                            Union[str, TargetProfile]]] = None,
                        config: Optional[PipelineConfig] = None,
                        *, selection: Optional[str] = None,
                        jobs: Optional[int] = None,
                        cache: Optional[CompileCache] = GLOBAL_CACHE
                        ) -> Dict[str, TargetVariant]:
    """Compile one PTX module into per-architecture variants.

    Shim over :meth:`repro.core.driver.Compiler.variants`: the
    expensive, target-independent prefix (symbolic emulation +
    detection) runs once per kernel; every target then replays only the
    cheap selection + synthesis tail with its own profile.  ``targets``
    defaults to every registered profile; ``selection`` overrides the
    config's candidate policy.  Returns ``{profile name:
    TargetVariant}`` in ascending sm order.
    """
    base = config or PipelineConfig()
    if selection is not None:
        base = dataclasses.replace(base, selection=selection)
    results = _session().variants(ptx_text, targets=targets,
                                  config=_with_jobs(base, jobs), cache=cache)
    return {name: TargetVariant(target=res.target_profile, ptx=res.ptx,
                                reports=res.reports)
            for name, res in results.items()}
