"""Mirrors ``src/repro/core/driver/result.py`` (only the imports differ).

Structured compile results and diagnostics.

One :class:`CompileResult` replaces the heterogeneous tuples the free
functions returned (``(Kernel, report)`` / ``(str, [reports])`` /
``(Module, [reports])`` / bare report): output PTX text *and* module,
per-kernel :class:`~repro.core.passes.KernelReport`\\ s, aggregated
pass timings, a cache-stats snapshot, selection decisions (inside the
reports), and severity-levelled diagnostics.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..passes.cache import CacheStats
from ..passes.manager import KernelReport
from ..ptx.ir import Module
from ..targets import TargetProfile, resolve_target
from .options import CompilerOptions

#: schema stamp of the JSON wire form (`to_json_dict`/`from_json_dict`)
RESULT_SCHEMA_VERSION = 1


class Severity(enum.IntEnum):
    NOTE = 0
    WARNING = 1
    ERROR = 2


@dataclass(frozen=True)
class Diagnostic:
    """One driver/frontend/pass message attached to a result.

    ``code`` is a stable machine-readable class ("truncated",
    "no-flows", a ``verify-ptx`` finding code...) and ``location`` an
    optional statement anchor ("uid:12"); together with ``kernel`` they
    form the deduplication key — repeated compiles of the same kernel in
    one session collapse to one diagnostic per (kernel, code, location).
    """

    severity: Severity
    message: str
    source: str = "driver"          # "driver", a frontend or pass name
    kernel: Optional[str] = None    # kernel it concerns, when any
    code: Optional[str] = None      # stable machine-readable class
    location: Optional[str] = None  # statement anchor, e.g. "uid:12"

    def __str__(self) -> str:
        where = f" [{self.kernel}]" if self.kernel else ""
        if self.location:
            where += f" @{self.location}"
        tag = f" [{self.code}]" if self.code else ""
        return f"{self.severity.name.lower()}: {self.source}{where}:{tag} " \
               f"{self.message}"


def dedupe_diagnostics(diags: List["Diagnostic"]) -> List["Diagnostic"]:
    """Collapse duplicates, preserving order of first occurrence.

    Coded diagnostics dedupe on (kernel, code, location) — the same
    finding re-derived for the same statement of the same kernel is one
    fact however many times it compiles.  Uncoded diagnostics dedupe
    only on full equality (the dataclass is frozen, so that is the
    tuple of all fields)."""
    seen: set = set()
    out: List[Diagnostic] = []
    for d in diags:
        key = (("coded", d.kernel, d.code, d.location)
               if d.code is not None else d)
        if key in seen:
            continue
        seen.add(key)
        out.append(d)
    return out


@dataclass(frozen=True)
class DetectionSummary:
    """The wire form of a detection result: the scalar facts a remote
    client needs (`CompileResult.n_shuffles`, report summaries) without
    shipping flow/instruction objects over HTTP."""

    n_shuffles: int = 0
    n_loads: int = 0
    n_flows: int = 0
    mean_abs_delta: Optional[float] = None


@dataclass
class CompileResult:
    """Everything one ``Compiler.compile/analyze/variants`` run produced."""

    ptx: str                              # printed output module
    module: Module                        # output module (input for analyze)
    reports: List[KernelReport]           # per-kernel, module order
    options: CompilerOptions              # options resolved for this run
    frontend: str                         # which ingestion form matched
    cache_stats: CacheStats = field(default_factory=CacheStats)
    diagnostics: List[Diagnostic] = field(default_factory=list)
    wall_time_s: float = 0.0
    analysis_only: bool = False
    target_profile: Optional[TargetProfile] = None   # set by variants()

    # ------------------------------------------------------------------
    @property
    def by_kernel(self) -> Dict[str, KernelReport]:
        return {r.name: r for r in self.reports}

    @property
    def n_shuffles(self) -> int:
        return sum(r.detection.n_shuffles for r in self.reports
                   if r.detection is not None)

    @property
    def cached(self) -> bool:
        """True iff every kernel was served from the result cache."""
        return bool(self.reports) and all(r.cached for r in self.reports)

    @property
    def pass_times(self) -> Dict[str, float]:
        """Per-pass wall time summed over kernels, pipeline order."""
        total: Dict[str, float] = {}
        for rep in self.reports:
            for name, dt in rep.pass_times.items():
                total[name] = total.get(name, 0.0) + dt
        return total

    @property
    def emulator_counters(self) -> Dict[str, int]:
        """Emulator phase counters summed over kernels (steps, forks,
        memoization hits, truncations, terms interned).  Saturation
        counters (``sat_`` prefix) live in :attr:`saturation_counters`;
        static-analysis counters (``lint_`` prefix) in
        :attr:`lint_counters`."""
        total: Dict[str, int] = {}
        for rep in self.reports:
            for name, n in rep.counters.items():
                if not name.startswith(("sat_", "lint_")):
                    total[name] = total.get(name, 0) + n
        return total

    @property
    def saturation_counters(self) -> Dict[str, int]:
        """Equality-saturation middle-end counters summed over kernels
        (e-classes/e-nodes built, rules applied, rewrites, deleted
        instructions, predicted cycle delta in milli-cycles, soundness
        failures).  Empty when ``saturate`` was off."""
        total: Dict[str, int] = {}
        for rep in self.reports:
            for name, n in rep.counters.items():
                if name.startswith("sat_"):
                    total[name] = total.get(name, 0) + n
        return total

    @property
    def lint_counters(self) -> Dict[str, int]:
        """``verify-ptx`` static-analysis counters summed over kernels
        (findings per code and per severity, plus pairs dropped by the
        uniformity gate).  Empty when ``lint`` was off and the gate
        never fired."""
        total: Dict[str, int] = {}
        for rep in self.reports:
            for name, n in rep.counters.items():
                if name.startswith("lint_"):
                    total[name] = total.get(name, 0) + n
        return total

    @property
    def findings(self) -> List[object]:
        """Static-analysis findings over all kernels, module order."""
        out: List[object] = []
        for rep in self.reports:
            out.extend(getattr(rep, "findings", ()) or ())
        return out

    def diagnostics_at(self, severity: Severity) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= severity]

    @property
    def summary(self) -> str:
        kinds = "analysis" if self.analysis_only else "compile"
        tgt = f"@{self.target_profile.name}" if self.target_profile else ""
        return (f"{kinds}{tgt}: {len(self.reports)} kernel(s) via "
                f"{self.frontend}, {self.n_shuffles} shuffle(s), "
                f"{self.wall_time_s:.3f}s"
                + (" [cached]" if self.cached else ""))

    # ------------------------------------------------------------------
    # JSON wire form (the HTTP serving front-end's response payload)
    # ------------------------------------------------------------------
    def to_json_dict(self) -> Dict:
        """A ``json.dumps``-ready dict of this result.

        The PTX text rides whole (the module is re-parsed on the other
        side), detections collapse to :class:`DetectionSummary` scalars,
        and selection objects are dropped — everything a serving client
        consumes survives; pass-internal objects do not.
        """
        def report_dict(rep: KernelReport) -> Dict:
            d = rep.detection
            return {
                "name": rep.name,
                "cached": rep.cached,
                "target": rep.target,
                "emulate_time_s": rep.emulate_time_s,
                "total_time_s": rep.total_time_s,
                "pass_times": dict(rep.pass_times),
                "counters": dict(rep.counters),
                "findings": [f.to_dict()
                             for f in getattr(rep, "findings", ()) or ()],
                "detection": None if d is None else {
                    "n_shuffles": d.n_shuffles,
                    "n_loads": d.n_loads,
                    "n_flows": d.n_flows,
                    "mean_abs_delta": d.mean_abs_delta,
                },
            }

        opts = {f.name: getattr(self.options, f.name)
                for f in dataclasses.fields(self.options)}
        if opts.get("passes") is not None:
            opts["passes"] = list(opts["passes"])
        return {
            "schema": RESULT_SCHEMA_VERSION,
            "ptx": self.ptx,
            "frontend": self.frontend,
            "analysis_only": self.analysis_only,
            "wall_time_s": self.wall_time_s,
            "options": opts,
            "reports": [report_dict(r) for r in self.reports],
            "cache_stats": self.cache_stats.to_dict(),
            "diagnostics": [{"severity": d.severity.name,
                             "message": d.message,
                             "source": d.source,
                             "kernel": d.kernel,
                             "code": d.code,
                             "location": d.location}
                            for d in self.diagnostics],
            "target_profile": self.target_profile.name
            if self.target_profile is not None else None,
        }

    @classmethod
    def from_json_dict(cls, payload: Dict) -> "CompileResult":
        """Rebuild a result from :meth:`to_json_dict` output.

        The module is re-parsed from the PTX text (byte-identity of the
        print→parse→print round trip is test-pinned), detections come
        back as :class:`DetectionSummary`, and the cache-stats snapshot
        keeps only the counter fields JSON carries.
        """
        schema = payload.get("schema")
        if schema != RESULT_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported CompileResult schema {schema!r} "
                f"(this build speaks {RESULT_SCHEMA_VERSION})")
        from ..analysis.findings import Finding
        from ..ptx.parser import parse
        opts = dict(payload.get("options") or {})
        if opts.get("passes") is not None:
            opts["passes"] = tuple(opts["passes"])
        known = {f.name for f in dataclasses.fields(CompilerOptions)}
        options = CompilerOptions().replace(
            **{k: v for k, v in opts.items() if k in known})
        reports = []
        for rd in payload.get("reports", ()):
            det = rd.get("detection")
            reports.append(KernelReport(
                name=rd["name"],
                detection=None if det is None else DetectionSummary(**det),
                emulate_time_s=rd.get("emulate_time_s", 0.0),
                total_time_s=rd.get("total_time_s", 0.0),
                pass_times=dict(rd.get("pass_times") or {}),
                cached=rd.get("cached", False),
                target=rd.get("target"),
                counters=dict(rd.get("counters") or {}),
                findings=[Finding.from_dict(f)
                          for f in rd.get("findings") or ()],
            ))
        stats_fields = {f.name for f in dataclasses.fields(CacheStats)}
        stats = CacheStats(**{k: v for k, v in
                              (payload.get("cache_stats") or {}).items()
                              if k in stats_fields})
        target_name = payload.get("target_profile")
        return cls(
            ptx=payload["ptx"],
            module=parse(payload["ptx"]),
            reports=reports,
            options=options,
            frontend=payload.get("frontend", "ptx"),
            cache_stats=stats,
            diagnostics=[Diagnostic(Severity[d["severity"]], d["message"],
                                    source=d.get("source", "driver"),
                                    kernel=d.get("kernel"),
                                    code=d.get("code"),
                                    location=d.get("location"))
                         for d in payload.get("diagnostics", ())],
            wall_time_s=payload.get("wall_time_s", 0.0),
            analysis_only=payload.get("analysis_only", False),
            target_profile=resolve_target(target_name)
            if target_name is not None else None,
        )
