"""Mirrors ``src/repro/core/analysis/lint.py`` (only the imports and the CLI's
program name differ).

Lint orchestration + the ``python -m repro_torch.core.analysis.lint`` CLI.

:func:`run_lint` is the single entry the ``verify-ptx`` pass, the CLI,
and ``POST /lint`` all share: it runs the def-use verifier, the
synchronization checker, and the shared-memory race detector over one
:class:`~repro.core.passes.context.KernelContext` and returns the
sorted, kernel-stamped :class:`~repro.core.analysis.findings.Finding`
list.

CLI::

    python -m repro_torch.core.analysis.lint file.ptx [file2.ptx ...]
    python -m repro_torch.core.analysis.lint --bench jacobi,laplacian
    python -m repro_torch.core.analysis.lint --corpus all --strict
    python -m repro_torch.core.analysis.lint --corpus all --synthesized \
        --target volta --json

Exit-code contract (stable; CI consumes it):

* ``0`` — clean: no WARNING-or-worse findings (NOTEs, including the
  prover's ``membermask-proven``, are informational and never fail a
  build)
* ``1`` — at least one finding at WARNING or above
* ``2`` — usage error (bad flags, unreadable file, unknown bench)

``--strict`` is retained as a compatible alias of the default WARNING
threshold; ``--errors-only`` restores the historical ERROR-only gate.

``--json`` emits a schema-stamped machine-readable envelope::

    {"schema": "repro-lint-findings", "schema_version": 1,
     "n_kernels": 19, "findings": [...],
     "summary": {"errors": 0, "warnings": 0, "notes": 16,
                 "proven_masks": 16}}

``--synthesized`` first runs each kernel through the full compile
pipeline for ``--target`` and lints the *synthesized* output — the way
CI proves every emitted full-mask ``shfl.sync`` membermask.
"""

from __future__ import annotations

import argparse
import dataclasses
import json as _json
import sys
from typing import Iterable, List, Optional, Tuple

from ..driver.result import Severity
from ..passes.context import KernelContext, PipelineConfig
from .findings import Finding


def run_lint(ctx: KernelContext) -> List[Finding]:
    """All static checks over one kernel context, sorted by location."""
    # registers the cfg/dominators/flows analyses when the linter runs
    # standalone (CLI / HTTP) outside the pass pipeline
    from ..passes import analyses as _analyses  # noqa: F401
    from .defuse import lint_defuse
    from .races import lint_races
    from .sync import lint_sync

    findings = [*lint_defuse(ctx), *lint_sync(ctx), *lint_races(ctx)]
    name = ctx.kernel.name
    findings = [dataclasses.replace(f, kernel=name)
                if f.kernel is None else f for f in findings]
    findings.sort(key=lambda f: (f.uid if f.uid is not None else -1, f.code))
    return findings


def lint_kernel(kernel, config: Optional[PipelineConfig] = None,
                kernel_name: Optional[str] = None) -> List[Finding]:
    ctx = KernelContext(kernel, config or PipelineConfig())
    findings = run_lint(ctx)
    if kernel_name:
        findings = [dataclasses.replace(f, kernel=kernel_name)
                    for f in findings]
    return findings


def lint_module(module, config: Optional[PipelineConfig] = None
                ) -> List[Finding]:
    out: List[Finding] = []
    for kernel in module.kernels:
        out.extend(lint_kernel(kernel, config=config))
    return out


def lint_source(text: str, config: Optional[PipelineConfig] = None
                ) -> List[Finding]:
    from ..ptx.parser import parse
    return lint_module(parse(text), config=config)


# ---------------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------------

def corpus_kernels(which: str) -> List[Tuple[str, object]]:
    """(name, Kernel) pairs for ``kernelgen`` (the 16-kernel suite),
    ``apps`` (the Section-8.5 applications), or ``all``."""
    from ..frontend.kernelgen import all_benches
    from ..frontend.stencil import lower_to_ptx

    if which not in ("kernelgen", "apps", "all"):
        raise ValueError(f"unknown corpus {which!r}; "
                         "expected kernelgen | apps | all")
    benches = all_benches(include_apps=(which in ("apps", "all")))
    if which == "apps":
        suite = set(all_benches(include_apps=False))
        benches = {n: b for n, b in benches.items() if n not in suite}
    return [(name, lower_to_ptx(b.program))
            for name, b in sorted(benches.items())]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

#: machine-readable envelope identity for ``--json`` consumers
JSON_SCHEMA = "repro-lint-findings"
JSON_SCHEMA_VERSION = 1


def summarize(findings: Iterable[Finding]) -> dict:
    """The ``--json`` summary block (also what CI asserts against)."""
    findings = list(findings)
    return {
        "errors": sum(1 for f in findings
                      if f.severity == Severity.ERROR),
        "warnings": sum(1 for f in findings
                        if f.severity == Severity.WARNING),
        "notes": sum(1 for f in findings if f.severity == Severity.NOTE),
        "proven_masks": sum(1 for f in findings
                            if f.code == "membermask-proven"),
    }


def _emit(findings: List[Finding], as_json: bool, n_kernels: int,
          out=None) -> None:
    out = out or sys.stdout
    if as_json:
        payload = {
            "schema": JSON_SCHEMA,
            "schema_version": JSON_SCHEMA_VERSION,
            "n_kernels": n_kernels,
            "findings": [f.to_dict() for f in findings],
            "summary": summarize(findings),
        }
        print(_json.dumps(payload, indent=2), file=out)
        return
    for f in findings:
        print(str(f), file=out)


def _synthesize_module(module, target: Optional[str], widen: bool):
    """Run a parsed module through the full compile pipeline and parse
    the synthesized PTX back for linting (the prover path)."""
    from ..driver import Compiler
    from ..driver.options import CompilerOptions
    from ..ptx.parser import parse
    from ..ptx.printer import print_module
    cc = Compiler(CompilerOptions(target=target, widen=widen))
    result = cc.compile(print_module(module))
    return parse(result.to_json_dict()["ptx"])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis.lint",
        description="Static PTX semantic analyzer (verify-ptx, standalone); "
                    "exits 0 clean / 1 findings >= WARNING / 2 usage error")
    ap.add_argument("files", nargs="*", help="PTX files to lint")
    ap.add_argument("--bench", default=None,
                    help="comma-separated KernelGen bench names")
    ap.add_argument("--corpus", default=None,
                    choices=("kernelgen", "apps", "all"),
                    help="lint a built-in lowered corpus")
    ap.add_argument("--strict", action="store_true",
                    help="compatible alias of the default WARNING threshold")
    ap.add_argument("--errors-only", action="store_true",
                    help="historical gate: exit non-zero on ERROR findings "
                         "only (default threshold is WARNING)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit a schema-stamped JSON findings envelope")
    ap.add_argument("--synthesized", action="store_true",
                    help="compile each kernel first and lint the "
                         "synthesized output (membermask prover path)")
    ap.add_argument("--target", default=None,
                    help="target profile for --synthesized "
                         "(e.g. volta, sm_70; default: registry default)")
    ap.add_argument("--widen", action="store_true",
                    help="with --synthesized: enable proof-widened "
                         "synthesis (CompilerOptions.widen)")
    ap.add_argument("--lane", default="tid.x",
                    help="lane dimension for the race detector's affine "
                         "addresses (default: tid.x)")
    args = ap.parse_args(argv)

    if not args.files and not args.bench and not args.corpus:
        ap.error("nothing to lint: pass files, --bench, or --corpus")

    config = PipelineConfig(lane=args.lane)
    findings: List[Finding] = []
    n_kernels = 0

    def lint_unit(module_or_kernel, name: Optional[str] = None) -> int:
        """Lint one parsed module or lowered kernel, honoring
        ``--synthesized``; returns the kernel count."""
        from ..ptx.ir import Module
        if not isinstance(module_or_kernel, Module):
            module_or_kernel = Module(kernels=[module_or_kernel])
        if args.synthesized:
            module_or_kernel = _synthesize_module(
                module_or_kernel, args.target, args.widen)
        fs = lint_module(module_or_kernel, config=config)
        if name:
            fs = [dataclasses.replace(f, kernel=name) for f in fs]
        findings.extend(fs)
        return len(module_or_kernel.kernels)

    try:
        for path in args.files:
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
            from ..ptx.parser import parse
            n_kernels += lint_unit(parse(text))

        if args.bench:
            from ..frontend.kernelgen import get_bench
            from ..frontend.stencil import lower_to_ptx
            for name in [s.strip() for s in args.bench.split(",")
                         if s.strip()]:
                n_kernels += lint_unit(lower_to_ptx(get_bench(name).program),
                                       name=name)

        if args.corpus:
            for name, kernel in corpus_kernels(args.corpus):
                n_kernels += lint_unit(kernel, name=name)
    except (OSError, KeyError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    _emit(findings, args.as_json, n_kernels)
    summary = summarize(findings)
    if not args.as_json:
        print(f"{len(findings)} finding(s) across {n_kernels} kernel(s): "
              f"{summary['errors']} error(s), "
              f"{summary['warnings']} warning(s), "
              f"{summary['notes']} note(s)")
    threshold = Severity.ERROR if args.errors_only else Severity.WARNING
    return 1 if any(f.severity >= threshold for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
