"""Mirrors ``src/repro/core/passes/stages.py`` (only the imports differ).

The PTXASW middle-end stages (paper Fig. 1) expressed as passes.

``emulate-flows`` and ``detect-shuffles`` are analysis passes: they
force context analyses and publish the detection product.
``select-shuffles`` is the cost gate: with ``selection="cost"`` it
scores each detected candidate with the target profile's cycle model
and drops the ones the architecture is predicted to lose on (paper
Sections 6-8: Maxwell/Pascal win, Kepler/Volta break even or lose);
with the default ``selection="all"`` it keeps every candidate, which
reproduces the paper's unconditional synthesis.
``synthesize-shuffles`` is the transform: it rewrites the kernel with
the target's encoding (``shfl.sync`` + membermask on sm_70+, legacy
``shfl`` below) and invalidates every analysis (the synthesized body
has new uids, blocks and memory behaviour).

Future optimizations (shared-memory shuffles, vectorized loads) plug in
here: register a pass, insert its name into the pipeline's pass list,
and reuse the memoized analyses.
"""

from __future__ import annotations

from .context import KernelContext
from .manager import register_pass


@register_pass("emulate-flows")
class EmulateFlows:
    """Force the symbolic-emulator flow analysis (Section 4)."""

    def run(self, ctx: KernelContext) -> None:
        ctx.get("flows")
        # The always-on uniformity safety gate (select-shuffles /
        # extract) consumes these on the same un-transformed kernel, in
        # every pipeline configuration — computing them here (instead of
        # at first use inside a later pass) keeps per-pass timings
        # attributing shared infrastructure to the shared stage rather
        # than to whichever consumer happens to run first.
        from ..analysis import uniformity as _uniformity  # noqa: F401
        ctx.get("cfg")
        ctx.get("uniformity")


@register_pass("detect-shuffles")
class DetectShuffles:
    """Shuffle-pair detection (Section 5.1); publishes ``detection``."""

    def run(self, ctx: KernelContext) -> None:
        ctx.products["detection"] = ctx.get("detection")


@register_pass("saturate")
class Saturate:
    """Equality saturation over the per-block PTX dataflow (e-graph
    build, symbolic value-number + cross-flow load CSE, budgeted rule
    application).  No-op unless ``config.saturate`` — the knob is also
    folded into the cache token, so saturated and unsaturated results
    never share cache entries."""

    def run(self, ctx: KernelContext) -> None:
        if not ctx.config.saturate:
            return
        # late import: the egraph package pulls in targets + emulator
        from ..egraph.saturate import run_saturate
        run_saturate(ctx)


@register_pass("extract")
class Extract:
    """Cost-guided extraction from the saturated e-graphs: rebuilds the
    kernel with the target profile's cheapest representative per value,
    then gates the whole rewrite behind differential concrete emulation
    (a failed check keeps the original body and is counted in
    ``sat_soundness_failures``)."""

    def run(self, ctx: KernelContext) -> None:
        if not ctx.config.saturate:
            return
        from ..egraph.extract import run_extract
        run_extract(ctx)


@register_pass("verify-ptx")
class VerifyPtx:
    """Static semantic analysis (uniformity, synchronization, races,
    def-use) over the input kernel.  Publishes the finding list and
    ``lint_``-prefixed counters as products; the driver lifts findings
    into result diagnostics.  Scheduled only when ``config.lint`` is not
    ``"off"`` (the knob is in the cache token, so linted and unlinted
    results never share cache entries)."""

    def run(self, ctx: KernelContext) -> None:
        # late import: the analysis package pulls in the driver's
        # Severity enum
        from ..analysis.lint import run_lint
        from ..analysis.findings import finding_counters
        findings = run_lint(ctx)
        ctx.products["findings"] = findings
        counters = ctx.products.setdefault("lint_counters", {})
        for name, n in finding_counters(findings).items():
            counters[name] = counters.get(name, 0) + n


def _detection(ctx: KernelContext):
    detection = ctx.products.get("detection")
    if detection is None:
        detection = ctx.get("detection")
        ctx.products["detection"] = detection
    return detection


def _gate_detection(ctx: KernelContext, detection):
    """The always-on uniformity safety gate: refuse to synthesize a
    shuffle whose load sits in a join-divergent region (the source lane
    may be executing the other side of the branch — the exact hazard
    class the static analyzer flags as ``divergent-shfl``).

    Returns ``(gated_detection, n_widened)``; with ``config.widen`` on,
    ``n_widened`` counts pairs kept only because the relational
    survivor proofs declassified their region (the synthesize stage
    re-validates those through the differential gate).
    """
    from ..analysis.uniformity import gate_pairs
    gated, dropped, widened = gate_pairs(ctx, detection)
    if dropped:
        counters = ctx.products.setdefault("lint_counters", {})
        counters["lint_gated_pairs"] = \
            counters.get("lint_gated_pairs", 0) + dropped
        ctx.products["detection"] = gated
    return gated, widened


@register_pass("select-shuffles")
class SelectShuffles:
    """Cost-model-guided candidate selection against the target profile,
    behind the uniformity safety gate (divergent candidates never reach
    the cost model, whatever the selection policy)."""

    def run(self, ctx: KernelContext) -> None:
        # late import: keeps the targets package import-light and avoids
        # synthesis <-> passes import cycles
        from ..targets.cost import select
        detection, _ = _gate_detection(ctx, _detection(ctx))
        if ctx.config.selection != "cost":
            return
        report = select(detection, ctx.config.target, mode=ctx.config.mode)
        ctx.products["detection_all"] = detection
        ctx.products["detection"] = report.selected
        ctx.products["selection"] = report


@register_pass("synthesize-shuffles")
class SynthesizeShuffles:
    """Rewrite covered loads into shuffle sequences (Section 5.2)."""

    def run(self, ctx: KernelContext) -> None:
        # late import: synthesis.__init__ imports the legacy wrapper,
        # which imports this package
        from ..synthesis.codegen import synthesize
        # idempotent re-gate: covers custom pass lists that synthesize
        # without the select stage
        detection, widened = _gate_detection(ctx, _detection(ctx))
        clamps = None
        if ctx.config.widen and getattr(detection, "pairs", None):
            from ..analysis.relational import survivor_clamps
            clamps = survivor_clamps(ctx, detection) or None
        new_kernel = synthesize(ctx.kernel, detection,
                                mode=ctx.config.mode,
                                target=ctx.config.target,
                                clamps=clamps)
        if widened or clamps:
            # every proof-widened decision (pair kept past the raw JOIN
            # gate, or clamp tightened past the blanket corner case) is
            # re-validated by differential concrete emulation; a failed
            # check reverts to the unwidened synthesis
            from ..egraph.verify import differential_check
            counters = ctx.products.setdefault("lint_counters", {})
            reason = differential_check(ctx.kernel, new_kernel)
            if reason is not None:
                counters["lint_widening_reverted"] = \
                    counters.get("lint_widening_reverted", 0) + 1
                import dataclasses
                from ..analysis.uniformity import JOIN, level_of_uid
                keep = [p for p in detection.pairs
                        if level_of_uid(ctx, p.dst_uid) != JOIN
                        and level_of_uid(ctx, p.src_uid) != JOIN]
                safe = dataclasses.replace(detection, pairs=keep)
                ctx.products["detection"] = safe
                new_kernel = synthesize(ctx.kernel, safe,
                                        mode=ctx.config.mode,
                                        target=ctx.config.target)
            else:
                if widened:
                    counters["lint_widened_pairs"] = \
                        counters.get("lint_widened_pairs", 0) + widened
                if clamps:
                    counters["lint_survivor_clamps"] = \
                        counters.get("lint_survivor_clamps", 0) + len(clamps)
        ctx.replace_kernel(new_kernel)
