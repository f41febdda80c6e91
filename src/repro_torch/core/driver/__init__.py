"""Mirrors ``src/repro/core/driver/__init__.py`` (only the imports differ).

Unified compiler driver: one facade over frontends, pipeline,
targets, and cache.

The paper's tool is a single middle-end serving two frontends behind
one assembler-wrapper interface; this package is that shape for the
reproduction.  A :class:`Compiler` session owns its configuration
(:class:`CompilerOptions`), its result cache (session-scoped by
default, ``share_global_cache=True`` to opt into the process-wide
one), and its worker pool; polymorphic sources (PTX text, parsed
``Module``/``Kernel``, stencil-DSL programs, KernelGen benches — see
:mod:`~repro.core.driver.source`) all normalize to PTX the same way,
and every method returns a structured :class:`CompileResult`.

::

    from repro_torch.core.driver import Compiler

    cc = Compiler(jobs=4)
    result = cc.compile(ptx_text)                  # full middle-end
    report = cc.analyze(program)                   # emulate + detect only
    per_arch = cc.variants(ptx_text, targets=["pascal", "volta"])
    results = cc.compile_many(sources)             # batched, deduped
    future = cc.submit(ptx_text)                   # async serving path

The legacy free functions (``repro.core.passes.compile_*``) and the
``ptxasw`` wrappers are thin shims over :func:`default_compiler`.
"""

from .compiler import Compiler, PreparedSource, default_compiler  # noqa: F401
from .options import CompilerOptions  # noqa: F401
from .result import (  # noqa: F401
    CompileResult,
    DetectionSummary,
    Diagnostic,
    Severity,
)
from .source import (  # noqa: F401
    NormalizedSource,
    Source,
    SourceFrontend,
    frontend_names,
    normalize_source,
    register_frontend,
)

__all__ = [
    "Compiler",
    "CompilerOptions",
    "CompileResult",
    "DetectionSummary",
    "Diagnostic",
    "NormalizedSource",
    "PreparedSource",
    "Severity",
    "Source",
    "SourceFrontend",
    "default_compiler",
    "frontend_names",
    "normalize_source",
    "register_frontend",
]
