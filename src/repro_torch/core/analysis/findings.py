"""Mirrors ``src/repro/core/analysis/findings.py`` (only the imports differ).

The static-analyzer's finding model.

A :class:`Finding` is one diagnosed fact about one kernel statement —
picklable (it rides :class:`~repro.core.passes.manager.KernelReport`
through the memory and disk cache tiers), hashable, and carrying a
stable machine-readable ``code`` so services can count findings per
class and the driver can deduplicate diagnostics across repeated
compiles.

Severity levels reuse the driver's :class:`Severity` IntEnum — ERROR
means "this kernel is unsound as written" (divergent barrier, divergent
shfl, non-covering membermask, use of a never-defined register),
WARNING means "likely bug / not provable" (shared-memory race,
unprovable register membermask, width mismatch, barrier under an exit
guard), NOTE is informational (type-class reinterpretation, dead
store, exit-guarded shfl corner).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from ..driver.result import Severity

# the full finding-code vocabulary; lint counters and docs key off this
CODES = (
    "divergent-barrier",      # ERROR: bar.sync in a join-divergent region
    "guarded-barrier",        # WARNING: bar.sync under a divergent exit guard
    "divergent-shfl",         # ERROR: shfl in a join-divergent region
    "membermask-noncovering",  # ERROR: constant mask misses active lanes
    "membermask-unprovable",  # WARNING: register mask, coverage unknown
    "membermask-proven",      # NOTE: mask proven to cover the active set
    "shfl-exit-guard",        # NOTE: full mask but under an exit guard
    "shared-race",            # WARNING: cross-thread .shared st->ld, no bar
    "undef-use",              # ERROR: register never defined on any path
    "width-mismatch",         # WARNING: reg narrower than instruction type
    "type-class",             # NOTE: float<->int reinterpretation
    "dead-store",             # NOTE: pure def never read
)


@dataclass(frozen=True)
class Finding:
    """One static-analysis diagnosis, anchored to a statement uid."""

    code: str
    severity: Severity
    message: str
    kernel: Optional[str] = None
    uid: Optional[int] = None
    # distinguishes same-code findings anchored at the same statement
    # (two shfls in one bundle, one load raced by two stores): folded
    # into ``location`` so diagnostic dedup keeps both
    detail: Optional[str] = None

    @property
    def location(self) -> Optional[str]:
        if self.uid is None:
            return None
        base = f"uid:{self.uid}"
        return base if self.detail is None else f"{base}:{self.detail}"

    def __str__(self) -> str:
        where = f"{self.kernel or '<kernel>'}"
        if self.uid is not None:
            where += f":{self.uid}"
        return f"{where}: {self.severity.name.lower()} [{self.code}] " \
               f"{self.message}"

    def to_dict(self) -> Dict:
        return {"code": self.code, "severity": self.severity.name,
                "message": self.message, "kernel": self.kernel,
                "uid": self.uid, "detail": self.detail}

    @classmethod
    def from_dict(cls, d: Dict) -> "Finding":
        return cls(code=d["code"], severity=Severity[d["severity"]],
                   message=d["message"], kernel=d.get("kernel"),
                   uid=d.get("uid"), detail=d.get("detail"))


def finding_counters(findings: Iterable[Finding]) -> Dict[str, int]:
    """Per-code + per-severity counters (all keys ``lint_``-prefixed so
    they split cleanly from emulator/saturation counters downstream)."""
    out: Dict[str, int] = {}
    for f in findings:
        out["lint_findings"] = out.get("lint_findings", 0) + 1
        sev = f"lint_{f.severity.name.lower()}s"
        out[sev] = out.get(sev, 0) + 1
        code = "lint_" + f.code.replace("-", "_")
        out[code] = out.get(code, 0) + 1
    return out


def worst_severity(findings: Iterable[Finding]) -> Optional[Severity]:
    worst: Optional[Severity] = None
    for f in findings:
        if worst is None or f.severity > worst:
            worst = f.severity
    return worst
