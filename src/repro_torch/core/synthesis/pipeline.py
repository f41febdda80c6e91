"""Mirrors ``src/repro/core/synthesis/pipeline.py`` (only the imports differ).

PTXASW compatibility wrappers over the pass-manager middle-end.

Historically this module *was* the middle-end: a hardcoded
``parse -> emulate -> detect -> synthesize`` chain.  The chain now
lives in :mod:`repro.core.passes` as an extensible pass pipeline behind
the :class:`repro.core.driver.Compiler` facade; ``ptxasw`` /
``ptxasw_kernel`` remain as deprecated wrappers so existing callers
keep working unchanged — output stays byte-identical to the legacy
chain (``tests/test_pass_manager.py::test_ptxasw_matches_legacy_chain``),
but each process gets one ``DeprecationWarning`` pointing at the
facade.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

from ..passes import (
    KernelReport,
    PipelineConfig,
    compile_kernel,
    compile_ptx,
)
from ..ptx import Kernel

__all__ = ["KernelReport", "ptxasw", "ptxasw_kernel"]

_warned = False


def _warn_deprecated(name: str) -> None:
    """One warning per process, not one per compile (the wrappers sit on
    hot serving/benchmark loops)."""
    global _warned
    if _warned:
        return
    _warned = True
    warnings.warn(
        f"{name}() is deprecated; use repro_torch.core.driver.Compiler "
        "(e.g. Compiler().compile(src)) — output is byte-identical",
        DeprecationWarning, stacklevel=3)


def ptxasw_kernel(kernel: Kernel, mode: str = "ptxasw",
                  max_delta: int = 31, target: Optional[str] = None,
                  selection: str = "all") -> Tuple[Kernel, KernelReport]:
    """Deprecated compatibility wrapper: one kernel through the default
    pipeline.  Use :class:`repro.core.driver.Compiler` instead."""
    _warn_deprecated("ptxasw_kernel")
    return compile_kernel(kernel,
                          PipelineConfig(mode=mode, max_delta=max_delta,
                                         target=target, selection=selection))


def ptxasw(ptx_text: str, mode: str = "ptxasw",
           max_delta: int = 31, target: Optional[str] = None,
           selection: str = "all") -> Tuple[str, List[KernelReport]]:
    """Deprecated assembler-wrapper entry point: PTX text in, PTX text
    out.  Use :class:`repro.core.driver.Compiler` instead.

    The parsed module is routed through the pipeline intact, so module
    directives (``.version`` / ``.target`` / ``.address_size``) and any
    other non-kernel state survive the rewrite; the ``.target``
    directive also elects the codegen profile unless ``target`` names
    one explicitly.
    """
    _warn_deprecated("ptxasw")
    return compile_ptx(ptx_text,
                       PipelineConfig(mode=mode, max_delta=max_delta,
                                      target=target, selection=selection))
