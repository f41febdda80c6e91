"""Mirrors ``src/repro/core/driver/compiler.py`` (only the imports differ).

The :class:`Compiler` session facade.

One object owns what used to be five free functions, three frontend
entry points, and two process-wide mutable globals: configuration
(:class:`~repro.core.driver.options.CompilerOptions`), a result cache
(session-scoped by default, ``share_global_cache=True`` opts into the
process-wide one), and the worker pool behind ``submit`` /
``compile_many``.  Sources are polymorphic (anything the frontend
registry accepts) and every method returns a structured
:class:`~repro.core.driver.result.CompileResult` instead of a
heterogeneous tuple.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..passes.cache import CacheStats, CompileCache, GLOBAL_CACHE
from ..passes.context import PipelineConfig
from ..passes.manager import (
    ANALYSIS_PASSES,
    DEFAULT_PASSES,
    SATURATED_ANALYSIS_PASSES,
    SATURATED_DEFAULT_PASSES,
    SYNTHESIS_PASSES,
    PassPipeline,
)
from ..ptx.ir import Module
from ..ptx.printer import print_module
from ..targets import TargetProfile, default_target, resolve_target, target_names
from .options import PIPELINE_FIELDS, CompilerOptions
from .result import (
    CompileResult, Diagnostic, Severity, dedupe_diagnostics,
)
from .source import NormalizedSource, Source, normalize_source

#: sentinel for "use the session cache" (``None`` means *no* cache)
_SESSION_CACHE = object()

#: session knobs that configure the cache built in ``Compiler.__init__``
#: — overriding them per call could only be silently ignored, so it is
#: rejected instead
_CONSTRUCTION_ONLY = frozenset({"share_global_cache", "cache_entries",
                                "cache_dir"})

ConfigLike = Union[None, PipelineConfig, CompilerOptions]


@dataclasses.dataclass(frozen=True)
class PreparedSource:
    """A normalized, option-resolved compile unit with its dedup key.

    Produced by :meth:`Compiler.prepare`; executed by
    :meth:`Compiler.compile_prepared` / :meth:`Compiler.submit_prepared`.
    ``key`` is the batching identity — ``(printed module text, pipeline
    cache token, pass-list override)`` — the same triple
    :meth:`Compiler.compile_many` dedupes on and the serving fleet's
    request coalescer joins concurrent HTTP requests on: two sources
    with equal keys compile to byte-identical results.
    """

    key: Tuple[str, str, Optional[Tuple[str, ...]]]
    ns: NormalizedSource
    opts: CompilerOptions
    diags: Tuple[Diagnostic, ...]


def _with_verify(passes: Sequence[str]) -> Tuple[str, ...]:
    """Insert ``verify-ptx`` after ``emulate-flows`` (the linter's race
    detector reuses the memoized flows) or, absent that, at the front."""
    passes = tuple(passes)
    if "verify-ptx" in passes:
        return passes
    if "emulate-flows" in passes:
        i = passes.index("emulate-flows") + 1
        return passes[:i] + ("verify-ptx",) + passes[i:]
    return ("verify-ptx",) + passes


def _analysis_options(opts: CompilerOptions) -> CompilerOptions:
    """The target-independent view of the options: detection depends
    only on ``max_delta`` and ``lane``, so normalizing everything else
    lets all targets (and plain ``analyze`` calls) share one cache
    entry per kernel.  The target is pinned to the default profile's
    name (the same cache token as ``None``) so a module's ``.target``
    directive cannot fork the shared prefix entry."""
    return CompilerOptions(max_delta=opts.max_delta, lane=opts.lane,
                           target=default_target().name)


class Compiler:
    """A compile session over the pass-manager middle-end.

    ::

        with Compiler(jobs=4) as cc:
            result = cc.compile(ptx_text)            # or Module / Kernel /
            report = cc.analyze(program)             #    Program / Bench
            variants = cc.variants(ptx_text, targets=["pascal", "volta"])
            futures = [cc.submit(src) for src in sources]
            results = cc.compile_many(sources)

    The session cache is private unless ``share_global_cache=True`` (or
    an explicit ``cache=`` is handed in); per-call ``cache=None`` forces
    a measured, uncached run.  ``close()`` (or the context manager)
    shuts the ``submit`` pool down; every other method works without it.
    """

    def __init__(self, options: Optional[CompilerOptions] = None, *,
                 cache: Optional[CompileCache] = None, **overrides) -> None:
        if options is not None and overrides:
            raise ValueError(
                "pass either options= or CompilerOptions field overrides, "
                f"not both (got options= and {sorted(overrides)})")
        self.options = options if options is not None \
            else CompilerOptions().replace(**overrides)
        # which session fields the caller *chose* (vs. inherited
        # defaults) — source option hints never override these.  A full
        # options= object counts as choosing every field, same as a
        # per-call config=CompilerOptions.
        self._session_explicit = frozenset(
            f.name for f in dataclasses.fields(CompilerOptions)) \
            if options is not None else frozenset(overrides)
        if cache is not None and self.options.share_global_cache:
            raise ValueError(
                "pass either cache= or share_global_cache=True, not both")
        if self.options.cache_dir is not None and (
                cache is not None or self.options.share_global_cache):
            raise ValueError(
                "cache_dir= attaches a disk tier to the session's own "
                "private cache; it cannot be combined with cache= or "
                "share_global_cache=True")
        if cache is not None:
            self._cache: Optional[CompileCache] = cache
        elif self.options.share_global_cache:
            self._cache = GLOBAL_CACHE
        else:
            # the session builds its own cache, so the disk tier can
            # ride along: explicit cache_dir= wins, then the
            # REPRO_CACHE_DIR environment (fleet deployments point every
            # replica at one shared directory)
            cache_dir = self.options.cache_dir \
                or os.environ.get("REPRO_CACHE_DIR") or None
            disk = None
            if cache_dir is not None:
                from ..passes.diskcache import DiskCache
                disk = DiskCache(cache_dir)
            self._cache = CompileCache(
                max_entries=self.options.cache_entries, disk=disk)
        self._lock = threading.Lock()
        self._pass_times: Dict[str, float] = {}
        self._counters: Dict[str, int] = {}
        self._n_runs = 0
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None

    # ------------------------------------------------------------------
    # session state
    # ------------------------------------------------------------------
    @property
    def cache(self) -> Optional[CompileCache]:
        return self._cache

    @property
    def cache_stats(self) -> CacheStats:
        """Live stats of the session cache (empty stats when uncached)."""
        return self._cache.stats if self._cache is not None else CacheStats()

    @property
    def pass_times(self) -> Dict[str, float]:
        """Per-pass wall time aggregated over every run of this session."""
        with self._lock:
            return dict(self._pass_times)

    @property
    def n_runs(self) -> int:
        with self._lock:
            return self._n_runs

    @property
    def counters(self) -> Dict[str, int]:
        """Per-kernel report counters (emulator + saturation) summed
        over every *measured* run of this session — the aggregate the
        serving front-end's ``/stats`` endpoint publishes."""
        with self._lock:
            return dict(self._counters)

    def _account(self, reports) -> None:
        with self._lock:
            self._n_runs += 1
            for rep in reports:
                if rep.cached:
                    # a hit's report carries a snapshot of the original
                    # run's timings; re-adding it would count phantom
                    # compute once per hit
                    continue
                for name, dt in rep.pass_times.items():
                    self._pass_times[name] = \
                        self._pass_times.get(name, 0.0) + dt
                for name, n in rep.counters.items():
                    self._counters[name] = self._counters.get(name, 0) + n

    # ------------------------------------------------------------------
    # pool lifecycle
    # ------------------------------------------------------------------
    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                # `is not None`, not truthiness: jobs=0 means serial
                # everywhere else, so give it the smallest legal pool
                workers = max(1, self.options.jobs) \
                    if self.options.jobs is not None \
                    else min(32, (os.cpu_count() or 1) + 4)
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="repro-compiler")
            return self._executor

    def close(self) -> None:
        """Shut down the ``submit`` pool (idempotent)."""
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)

    def __enter__(self) -> "Compiler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # option resolution
    # ------------------------------------------------------------------
    def _resolve(self, config: ConfigLike, overrides: Dict[str, object],
                 ns: Optional[NormalizedSource] = None,
                 ) -> Tuple[CompilerOptions, List[Diagnostic]]:
        """Session options <- explicit config/overrides <- source hints.

        ``config`` and field overrides are mutually exclusive (the
        silent-argument-drop wart of the free functions became a hard
        error).  Source option hints (e.g. a KernelGen bench's
        ``max_delta``) fill only fields the caller left untouched —
        per-call *and* session-level: every field the session
        constructor was handed (even at its default value) counts as
        explicitly chosen.
        """
        if config is not None and overrides:
            raise ValueError(
                "pass either config= or field overrides, not both "
                f"(got config= and {sorted(overrides)})")
        fixed = _CONSTRUCTION_ONLY & set(overrides)
        if fixed:
            raise ValueError(
                f"{sorted(fixed)} configure the session cache and are "
                "fixed at Compiler construction; build a new Compiler "
                "instead of overriding them per call")
        if config is None:
            opts = self.options.replace(**overrides) if overrides \
                else self.options
            explicit = set(overrides) | self._session_explicit
        elif isinstance(config, CompilerOptions):
            # construction-only knobs riding in on a per-call options
            # object cannot take effect; reject a deliberate (non-
            # default) mismatch, and inherit the session's values for
            # the rest instead of silently pretending
            defaults = CompilerOptions()
            smuggled = sorted(
                name for name in _CONSTRUCTION_ONLY
                if getattr(config, name) != getattr(defaults, name)
                and getattr(config, name) != getattr(self.options, name))
            if smuggled:
                raise ValueError(
                    f"{smuggled} configure the session cache and are "
                    "fixed at Compiler construction; build a new "
                    "Compiler instead of overriding them per call")
            opts = dataclasses.replace(
                config, **{name: getattr(self.options, name)
                           for name in _CONSTRUCTION_ONLY})
            explicit = {f.name for f in dataclasses.fields(CompilerOptions)}
        elif isinstance(config, PipelineConfig):
            opts = self.options.with_pipeline_config(config)
            explicit = set(PIPELINE_FIELDS)
        else:
            raise TypeError(f"config must be PipelineConfig or "
                            f"CompilerOptions, not {type(config).__name__}")
        diags: List[Diagnostic] = []
        if ns is not None and ns.option_hints:
            hints = {k: v for k, v in ns.option_hints.items()
                     if k not in explicit and getattr(opts, k) != v}
            if hints:
                opts = opts.replace(**hints)
                diags.append(Diagnostic(
                    Severity.NOTE, f"source hints applied: {hints}",
                    source=ns.frontend))
        return opts, diags

    def _pick_cache(self, cache) -> Optional[CompileCache]:
        return self._cache if cache is _SESSION_CACHE else cache

    def _effective_jobs(self, opts: CompilerOptions, n_units: int) -> int:
        """The session's worker count, resolved here so a ``None`` never
        reaches ``run_module`` — which would fall back to the deprecated
        process-wide ``set_default_jobs`` global and break session
        isolation."""
        if opts.jobs is not None:
            return opts.jobs
        return min(n_units, os.cpu_count() or 1) or 1

    # ------------------------------------------------------------------
    # core run
    # ------------------------------------------------------------------
    def _run(self, ns: NormalizedSource, opts: CompilerOptions,
             cache: Optional[CompileCache],
             diags: List[Diagnostic], analysis_only: bool) -> CompileResult:
        t0 = time.perf_counter()
        if opts.passes is not None:
            passes: Sequence[str] = opts.passes
        elif analysis_only:
            passes = SATURATED_ANALYSIS_PASSES if opts.saturate \
                else ANALYSIS_PASSES
        else:
            passes = SATURATED_DEFAULT_PASSES if opts.saturate \
                else DEFAULT_PASSES
        if opts.lint != "off" and opts.passes is None:
            passes = _with_verify(passes)
        pipeline = PassPipeline(passes=passes, config=opts.pipeline_config())
        out_module, reports = pipeline.run_module(
            ns.module, jobs=self._effective_jobs(opts, len(ns.module.kernels)),
            cache=cache)
        self._account(reports)
        diags = list(diags)
        diags.append(Diagnostic(
            Severity.NOTE,
            f"{len(reports)} kernel(s) through "
            f"{' -> '.join(pipeline.pass_names)}",
            source=ns.frontend))
        for rep in reports:
            if rep.detection is not None and rep.detection.n_flows == 0:
                diags.append(Diagnostic(
                    Severity.WARNING, "symbolic emulation found no flows",
                    source="emulate-flows", kernel=rep.name,
                    code="no-flows"))
            t_steps = rep.counters.get("truncated_steps", 0)
            t_forks = rep.counters.get("truncated_forks", 0)
            if t_steps or t_forks:
                what = []
                if t_steps:
                    what.append(f"max_steps={opts.max_steps} stopped "
                                f"{t_steps} flow(s)")
                if t_forks:
                    what.append(f"max_flows={opts.max_flows} dropped "
                                f"{t_forks} fork(s)")
                diags.append(Diagnostic(
                    Severity.WARNING,
                    "emulation truncated: " + "; ".join(what) +
                    " — detection may be incomplete; raise the budget "
                    "via CompilerOptions",
                    source="emulate-flows", kernel=rep.name,
                    code="truncated"))
            sat_failures = rep.counters.get("sat_soundness_failures", 0)
            if sat_failures:
                diags.append(Diagnostic(
                    Severity.WARNING,
                    f"{sat_failures} extracted rewrite(s) failed the "
                    "differential concrete-emulation soundness gate and "
                    "were dropped (original kernel body kept)",
                    source="extract", kernel=rep.name, code="sat-gate"))
            # verify-ptx findings become result diagnostics; in strict
            # mode everything WARNING-or-worse escalates to ERROR
            for f in getattr(rep, "findings", ()) or ():
                sev = f.severity
                if opts.lint == "strict" and sev >= Severity.WARNING:
                    sev = Severity.ERROR
                diags.append(Diagnostic(
                    sev, f.message, source="verify-ptx",
                    kernel=f.kernel or rep.name,
                    code=f.code, location=f.location))
        diags = dedupe_diagnostics(diags)
        return CompileResult(
            ptx=print_module(out_module),
            module=out_module,
            reports=reports,
            options=opts,
            frontend=ns.frontend,
            cache_stats=self.cache_stats.snapshot(),
            diagnostics=diags,
            wall_time_s=time.perf_counter() - t0,
            analysis_only=analysis_only,
        )

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def compile(self, src: Source, config: ConfigLike = None, *,
                cache=_SESSION_CACHE, **overrides) -> CompileResult:
        """Run ``src`` through the full middle-end (synthesis included)."""
        ns = normalize_source(src)
        opts, diags = self._resolve(config, overrides, ns)
        return self._run(ns, opts, self._pick_cache(cache), diags,
                         analysis_only=False)

    def analyze(self, src: Source, config: ConfigLike = None, *,
                cache=_SESSION_CACHE, **overrides) -> CompileResult:
        """Emulate + detect only (no codegen): the frontend-facing path."""
        ns = normalize_source(src)
        opts, diags = self._resolve(config, overrides, ns)
        return self._run(ns, opts, self._pick_cache(cache), diags,
                         analysis_only=True)

    # ------------------------------------------------------------------
    def variants(self, src: Source,
                 targets: Optional[Sequence[Union[str, TargetProfile]]] = None,
                 config: ConfigLike = None, *,
                 cache=_SESSION_CACHE, **overrides
                 ) -> Dict[str, CompileResult]:
        """Per-architecture variants of one source, in one call.

        The expensive target-independent prefix (symbolic emulation +
        detection) runs once per kernel; every target then replays only
        the cheap selection + synthesis tail with its own profile.
        ``targets`` defaults to every registered profile.  Returns
        ``{profile name: CompileResult}`` in registry (ascending sm)
        order, each result stamped with its ``target_profile``.
        """
        ns = normalize_source(src)
        opts, diags = self._resolve(config, overrides, ns)
        if opts.passes is not None:
            raise ValueError(
                "variants() always runs the stock analysis prefix + "
                "synthesis tail (its prefix-sharing depends on that "
                "split); a passes= override is not supported here")
        the_cache = self._pick_cache(cache)
        profiles = [resolve_target(t) for t in
                    (targets if targets is not None else target_names())]

        if opts.saturate:
            # saturation extracts against the target's cost profile, so
            # there is no target-independent analysis prefix to share:
            # each target runs the full saturated pipeline (cached
            # independently — the profile name is in the cache token)
            def build_saturated(profile: TargetProfile) -> CompileResult:
                result = self._run(ns, opts.replace(target=profile.name),
                                   the_cache, list(diags),
                                   analysis_only=False)
                result.target_profile = profile
                return result

            n_sat = opts.jobs if opts.jobs is not None \
                else min(len(profiles), os.cpu_count() or 1)
            if len(profiles) <= 1 or n_sat <= 1:
                sat_results = [build_saturated(p) for p in profiles]
            else:
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=n_sat) as ex:
                    sat_results = list(ex.map(build_saturated, profiles))
            return {r.target_profile.name: r for r in sat_results}

        # the prefix dominates wall clock, so it fans out over kernels
        # exactly like a module compile before targets fan out
        prefix = PassPipeline(passes=ANALYSIS_PASSES,
                              config=_analysis_options(opts).pipeline_config())
        _, prefix_reports = prefix.run_module(
            ns.module, jobs=self._effective_jobs(opts, len(ns.module.kernels)),
            cache=the_cache)
        self._account(prefix_reports)
        detections = {rep.name: rep.detection for rep in prefix_reports}

        def build(profile: TargetProfile) -> CompileResult:
            t0 = time.perf_counter()
            tail_opts = opts.replace(target=profile.name)
            tail = PassPipeline(passes=SYNTHESIS_PASSES,
                                config=tail_opts.pipeline_config())
            out = Module(kernels=[], version=profile.ptx_version,
                         target=profile.sm_name,
                         address_size=profile.address_size)
            reports = []
            for kernel in ns.module.kernels:
                new_kernel, rep = tail.run_kernel(
                    kernel, cache=the_cache,
                    products={"detection": detections[kernel.name]})
                out.kernels.append(new_kernel)
                reports.append(rep)
            self._account(reports)
            return CompileResult(
                ptx=print_module(out), module=out, reports=reports,
                options=tail_opts, frontend=ns.frontend,
                cache_stats=self.cache_stats.snapshot(),
                diagnostics=list(diags),
                wall_time_s=time.perf_counter() - t0,
                target_profile=profile,
            )

        n = opts.jobs if opts.jobs is not None \
            else min(len(profiles), os.cpu_count() or 1)
        if len(profiles) <= 1 or n <= 1:
            results = [build(p) for p in profiles]
        else:
            with concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
                results = list(ex.map(build, profiles))
        return {r.target_profile.name: r for r in results}

    # ------------------------------------------------------------------
    # batched / async serving path
    # ------------------------------------------------------------------
    def submit(self, src: Source, config: ConfigLike = None, *,
               cache=_SESSION_CACHE, **overrides
               ) -> "concurrent.futures.Future[CompileResult]":
        """Asynchronous :meth:`compile` on the session pool."""
        return self._pool().submit(self.compile, src, config,
                                   cache=cache, **overrides)

    def prepare(self, src: Source, config: ConfigLike = None,
                **overrides) -> PreparedSource:
        """Normalize + resolve one source without compiling it.

        The returned :class:`PreparedSource` carries the batching
        ``key`` (module text, cache token, pass list): callers that
        need to decide *whether* to compile — the fleet front-end's
        request coalescer, admission control — key on it, then hand
        the prepared unit to :meth:`compile_prepared` /
        :meth:`submit_prepared`.  Raises the same ``ValueError`` /
        ``TypeError`` family as :meth:`compile` on bad sources or
        options, so validation cost (and blame) stays with the caller.
        """
        ns = normalize_source(src)
        opts, diags = self._resolve(config, overrides, ns)
        key = (print_module(ns.module),
               opts.pipeline_config().cache_token(),
               opts.passes)
        return PreparedSource(key=key, ns=ns, opts=opts,
                              diags=tuple(diags))

    def compile_prepared(self, prepared: PreparedSource, *,
                         cache=_SESSION_CACHE,
                         analysis_only: bool = False) -> CompileResult:
        """Run a :meth:`prepare`-d unit through the middle-end."""
        return self._run(prepared.ns, prepared.opts,
                         self._pick_cache(cache), list(prepared.diags),
                         analysis_only=analysis_only)

    def submit_prepared(self, prepared: PreparedSource, *,
                        cache=_SESSION_CACHE, analysis_only: bool = False
                        ) -> "concurrent.futures.Future[CompileResult]":
        """Asynchronous :meth:`compile_prepared` on the session pool."""
        return self._pool().submit(self.compile_prepared, prepared,
                                   cache=cache, analysis_only=analysis_only)

    def compile_many(self, srcs: Sequence[Source],
                     config: ConfigLike = None, *,
                     cache=_SESSION_CACHE, **overrides
                     ) -> List[CompileResult]:
        """Compile a batch, one emulate/detect per *distinct* kernel.

        Sources are normalized up front and deduplicated on (module
        text, resolved cache token): each distinct unit compiles exactly
        once on the session pool, and duplicates are then served from
        the session cache — so a batch with repeats never re-runs
        symbolic emulation for them, even when the repeats arrive
        concurrently.  (With ``cache=None`` there is nothing to share
        through, so every source compiles independently.)
        """
        the_cache = self._pick_cache(cache)
        srcs = list(srcs)

        def prep(src):
            return self.prepare(src, config, **overrides)

        # normalization (frontend lowering) and key printing are per-
        # source and independent, so they fan out too instead of running
        # serially in the caller thread ahead of the compiles
        prepared = list(self._pool().map(prep, srcs)) if len(srcs) > 1 \
            else [prep(src) for src in srcs]

        def run_one(item: PreparedSource) -> CompileResult:
            return self.compile_prepared(item, cache=cache)

        if the_cache is None or len(prepared) <= 1:
            # no cache to serve duplicates through: every source
            # compiles independently
            distinct = prepared
        else:
            seen = set()
            distinct = []
            for item in prepared:
                if item.key not in seen:
                    seen.add(item.key)
                    distinct.append(item)
        if len(distinct) > 1:
            first_pass = dict(zip(
                (id(item) for item in distinct),
                self._pool().map(run_one, distinct)))
        else:
            first_pass = {id(item): run_one(item) for item in distinct}

        results: List[CompileResult] = []
        for item in prepared:
            got = first_pass.get(id(item))
            if got is None:
                # duplicate: recompile through the now-warm cache (a
                # pure hit) so every caller gets an isolated result
                got = run_one(item)
            results.append(got)
        return results


# ---------------------------------------------------------------------------
# the default session behind the legacy free functions
# ---------------------------------------------------------------------------

_DEFAULT: Optional[Compiler] = None
_DEFAULT_LOCK = threading.Lock()


def default_compiler() -> Compiler:
    """The process-default session the legacy shims delegate to.

    It shares :data:`~repro.core.passes.GLOBAL_CACHE` so pre-facade
    callers keep their cross-call caching behaviour; new code should
    build its own :class:`Compiler` (session-scoped cache, explicit
    jobs) instead.
    """
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            # kwargs form: only share_global_cache is session-explicit,
            # so source hints (a Bench's max_delta) keep applying to
            # everything the legacy shims compile
            _DEFAULT = Compiler(share_global_cache=True)
        return _DEFAULT
