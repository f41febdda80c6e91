"""Mirrors ``src/repro/core/passes/manager.py`` (only the imports differ).

Pass registry and the pipeline driver.

A *pass* is a named unit of middle-end work over a
:class:`~repro.core.passes.context.KernelContext`:

* **analysis passes** force context analyses and publish products
  (``ctx.products``) without touching the kernel;
* **transform passes** rewrite the kernel via ``ctx.replace_kernel``,
  which invalidates every analysis the pass does not declare preserved.

:class:`PassPipeline` runs an ordered list of passes over one kernel or
a whole module (kernels are independent, so module compilation fans out
over ``concurrent.futures``), consulting a content-addressed result
cache keyed on the kernel's printed PTX text plus the pipeline
configuration and pass list.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, Type, Union

from ..ptx.ir import Kernel, Module
from ..ptx.printer import print_kernel
from ..targets import resolve_target
from .cache import CompileCache, GLOBAL_CACHE
from .context import KernelContext, PipelineConfig


@dataclass
class KernelReport:
    """Per-kernel compilation report (superset of the legacy one)."""

    name: str
    detection: Optional[object] = None        # DetectionResult when computed
    emulate_time_s: float = 0.0
    total_time_s: float = 0.0
    pass_times: Dict[str, float] = field(default_factory=dict)
    cached: bool = False
    target: Optional[str] = None              # resolved profile name
    selection: Optional[object] = None        # targets.cost.SelectionReport
    counters: Dict[str, int] = field(default_factory=dict)  # emulator counters
    findings: List[object] = field(default_factory=list)  # analysis.Finding

    @property
    def summary(self) -> str:
        d = self.detection
        if d is None:
            return f"{self.name}: analysis {self.total_time_s:.3f}s"
        delta = f"{d.mean_abs_delta:.2f}" if d.mean_abs_delta is not None else "-"
        tag = " [cached]" if self.cached else ""
        sel = self.selection
        seltag = (f" sel {sel.n_kept}/{len(sel.scores)}@{sel.target}"
                  if sel is not None else "")
        return (f"{self.name}: shuffle/load {d.n_shuffles}/{d.n_loads} "
                f"delta {delta} flows {d.n_flows} "
                f"analysis {self.total_time_s:.3f}s{seltag}{tag}")


class Pass(Protocol):
    """The pass protocol: a name plus ``run`` over a kernel context."""

    name: str

    def run(self, ctx: KernelContext) -> None: ...


PASS_REGISTRY: Dict[str, Type] = {}


def register_pass(name: str):
    """Class decorator registering a pass under a stable name."""

    def deco(cls):
        if name in PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        cls.name = name
        PASS_REGISTRY[name] = cls
        return cls

    return deco


def _resolve(p: Union[str, Pass]) -> Pass:
    if isinstance(p, str):
        try:
            return PASS_REGISTRY[p]()
        except KeyError:
            raise KeyError(f"unknown pass {p!r}; registered: "
                           f"{sorted(PASS_REGISTRY)}") from None
    return p


# the PTXASW middle-end (paper Fig. 1) expressed as passes; analysis-only
# prefix reused by frontends that need detection without codegen, and by
# compile_for_targets as the shared target-independent prefix
ANALYSIS_PASSES: Tuple[str, ...] = ("emulate-flows", "detect-shuffles")
SYNTHESIS_PASSES: Tuple[str, ...] = ("select-shuffles", "synthesize-shuffles")
DEFAULT_PASSES: Tuple[str, ...] = ANALYSIS_PASSES + SYNTHESIS_PASSES

# the equality-saturation middle-end slots between flow emulation and
# shuffle detection: extraction rewrites the kernel, and detection must
# see (and re-emulate) the extracted body it will synthesize against
SATURATION_PASSES: Tuple[str, ...] = ("saturate", "extract")
SATURATED_ANALYSIS_PASSES: Tuple[str, ...] = \
    ("emulate-flows",) + SATURATION_PASSES + ("detect-shuffles",)
SATURATED_DEFAULT_PASSES: Tuple[str, ...] = \
    SATURATED_ANALYSIS_PASSES + SYNTHESIS_PASSES

_DEFAULT_JOBS: Optional[int] = None


def set_default_jobs(n: Optional[int]) -> None:
    """Set the process-wide default worker count for module compiles.

    Deprecated escape hatch: prefer a session-scoped
    ``repro.core.driver.Compiler(jobs=N)`` — the driver always passes
    its own worker count explicitly, so this global only affects
    callers that reach the pipeline without a session.
    """
    global _DEFAULT_JOBS
    _DEFAULT_JOBS = n


class PassPipeline:
    """An ordered pass list + config, runnable over kernels and modules."""

    def __init__(self, passes: Optional[Sequence[Union[str, Pass]]] = None,
                 config: Optional[PipelineConfig] = None) -> None:
        from . import stages  # noqa: F401  (ensure built-ins are registered)
        self.config = config or PipelineConfig()
        self.passes: List[Pass] = [_resolve(p) for p in
                                   (passes if passes is not None
                                    else DEFAULT_PASSES)]

    @property
    def pass_names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.passes)

    # ------------------------------------------------------------------
    def run_kernel(self, kernel: Kernel,
                   cache: Optional[CompileCache] = None,
                   products: Optional[Dict[str, object]] = None
                   ) -> Tuple[Kernel, KernelReport]:
        """Run the pass list over one kernel.

        ``products`` pre-seeds the context's product map — the hook
        ``compile_for_targets`` uses to share one target-independent
        detection across per-target synthesis runs.  Seeded products
        must be deterministic functions of the kernel text and the
        config (detection is: kernel + ``max_delta`` + ``lane``), since
        they do not participate in the cache key.
        """
        key = None
        if cache is not None:
            key = cache.key(print_kernel(kernel), self.config,
                            self.pass_names)
            hit = cache.get(key)
            if hit is not None:
                return hit
        t0 = time.perf_counter()
        ctx = KernelContext(kernel, self.config)
        if products:
            ctx.products.update(products)
        pass_times: Dict[str, float] = {}
        for p in self.passes:
            pt0 = time.perf_counter()
            p.run(ctx)
            pass_times[p.name] = pass_times.get(p.name, 0.0) \
                + time.perf_counter() - pt0
        report = KernelReport(
            name=kernel.name,
            detection=ctx.products.get("detection"),
            emulate_time_s=ctx.timing("flows"),
            total_time_s=time.perf_counter() - t0,
            pass_times=pass_times,
            target=resolve_target(self.config.target).name,
            selection=ctx.products.get("selection"),
            counters={**ctx.products.get("emulator_counters", {}),
                      **ctx.products.get("saturation_counters", {}),
                      **ctx.products.get("lint_counters", {})},
            findings=list(ctx.products.get("findings", ())),
        )
        out = ctx.kernel
        if cache is not None and key is not None:
            cache.put(key, out, report)
        return out, report

    # ------------------------------------------------------------------
    def for_module(self, module: Module) -> "PassPipeline":
        """The pipeline to apply to ``module``: when the config names no
        target, the module's parsed ``.target sm_XX`` directive elects
        the profile (resolved through the registry, so the cache token
        is the same as naming the profile explicitly)."""
        if self.config.target is not None or not module.target:
            return self
        return PassPipeline(
            passes=self.passes,
            config=dataclasses.replace(self.config, target=module.target))

    # ------------------------------------------------------------------
    def run_module(self, module: Module, jobs: Optional[int] = None,
                   cache: Optional[CompileCache] = None
                   ) -> Tuple[Module, List[KernelReport]]:
        """Compile every kernel of a module, preserving module directives.

        Kernels are independent, so with more than one of them the work
        fans out over a thread pool (``jobs`` workers; defaults to the
        process-wide setting, then to the CPU count).  The module's
        ``.target`` directive selects the target profile unless the
        config already names one (:meth:`for_module`).
        """
        pipeline = self.for_module(module)
        kernels = module.kernels
        n = jobs if jobs is not None else _DEFAULT_JOBS
        if n is None:
            n = min(len(kernels), os.cpu_count() or 1) or 1
        out = Module(kernels=[], version=module.version,
                     target=module.target,
                     address_size=module.address_size)
        if len(kernels) <= 1 or n <= 1:
            results = [pipeline.run_kernel(k, cache=cache) for k in kernels]
        else:
            with concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
                results = list(ex.map(
                    lambda k: pipeline.run_kernel(k, cache=cache), kernels))
        reports: List[KernelReport] = []
        for new_kernel, report in results:
            out.kernels.append(new_kernel)
            reports.append(report)
        return out, reports


def default_pipeline(config: Optional[PipelineConfig] = None,
                     passes: Optional[Sequence[Union[str, Pass]]] = None
                     ) -> PassPipeline:
    return PassPipeline(passes=passes, config=config)
