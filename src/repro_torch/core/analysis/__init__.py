"""Mirrors ``src/repro/core/analysis/__init__.py`` (only the imports differ).

Static PTX semantic analysis (`verify-ptx`).

The paper's premise is that warp shuffles are "difficult to use by even
advanced GPU programmers" — a ``shfl`` under divergent control flow,
with a wrong membermask, or racing an unsynchronized shared-memory
access is *silently* unsound.  The differential gate catches what
its two sampled grid configs exercise; this package catches the rest by
construction:

* :mod:`.uniformity` — forward dataflow from ``tid``-derived values
  through registers and predicates; classifies every basic block and
  branch as warp-uniform, exit-guard divergent (the ubiquitous
  ``setp; @%p bra $EXIT`` bounds guard), or join-divergent (both sides
  do observable work before re-converging).
* :mod:`.sync` — ``bar.sync`` under divergent control (deadlock),
  ``shfl``/``shfl.sync`` in divergent blocks or with a membermask not
  provably covering the active lanes.
* :mod:`.races` — cross-thread ``.shared`` store→load pairs without an
  intervening dominating ``bar.sync``, over the emulator's symbolic
  affine address forms.
* :mod:`.defuse` — use-before-def, dead stores, and type/width
  mismatches between register declarations and instruction suffixes.
* :mod:`.reach` — which pcs can still reach a detection-relevant or
  memoization-relevant statement (the soundness core of the emulator's
  ``prune_flows`` fast path).
* :mod:`.lint` — orchestration (:func:`~repro.core.analysis.lint.run_lint`)
  plus the ``python -m repro_torch.core.analysis.lint`` CLI.

Wired three ways: the ``verify-ptx`` pass (``CompilerOptions.lint``)
emits severity-levelled :class:`~repro.core.driver.result.Diagnostic`\\ s
into ``CompileResult``; ``select-shuffles`` and egraph ``extract``
consult the uniformity gate so synthesis only fires in provably
uniform-or-exit-guarded regions; and ``POST /lint`` on ``ptx_service``
serves it over HTTP with per-finding counters on ``/stats``.

Import discipline: this package never imports the emulator machine or
the pass stages at module level (the emulator's pruning imports
:mod:`.reach`), so everything here stays cycle-free.
"""

from __future__ import annotations

from .findings import Finding, finding_counters
from . import uniformity as _uniformity  # noqa: F401  (registers analyses)

__all__ = ["Finding", "finding_counters", "lint_kernel", "run_lint"]


def lint_kernel(kernel, config=None, kernel_name=None):
    """Lint one kernel; see :func:`repro.core.analysis.lint.lint_kernel`."""
    from .lint import lint_kernel as _lk
    return _lk(kernel, config=config, kernel_name=kernel_name)


def run_lint(ctx):
    """Lint one :class:`~repro.core.passes.context.KernelContext`."""
    from .lint import run_lint as _rl
    return _rl(ctx)
