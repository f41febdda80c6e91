"""Mirrors ``src/repro/core/analysis/__init__.py`` in part: the finding
model and the uniformity analysis that the always-on synthesis gate
(``passes/stages.py::_gate_detection``) reads.  ``lint_kernel`` and
``run_lint`` are not ported yet (ROADMAP Queue 1 item 3).

* :mod:`.uniformity` — forward dataflow from ``tid``-derived values
  through registers and predicates; classifies every basic block and
  branch as warp-uniform, exit-guard divergent (the ubiquitous
  ``setp; @%p bra $EXIT`` bounds guard), or join-divergent (both sides
  do observable work before re-converging).
* :mod:`.reach` — which pcs can still reach a detection-relevant or
  memoization-relevant statement (the soundness core of the emulator's
  ``prune_flows`` fast path).

Import discipline: this package never imports the emulator machine or
the pass stages at module level (the emulator's pruning imports
:mod:`.reach`), so everything here stays cycle-free.
"""

from __future__ import annotations

from .findings import Finding, finding_counters
from . import uniformity as _uniformity  # noqa: F401  (registers analyses)

__all__ = ["Finding", "finding_counters"]
