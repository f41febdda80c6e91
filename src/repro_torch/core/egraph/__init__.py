"""Mirrors ``src/repro/core/egraph/__init__.py`` (only the imports differ).

Equality-saturation middle-end over the PTX IR (ACC Saturator idea).

Per-block e-graphs built from the pass manager's memoized analyses
(:mod:`.build`), an algebraic/strength-reduction/CSE rule registry
(:mod:`.rules`), a budgeted saturation driver that also folds in
cross-flow load CSE from the symbolic emulator's value numbers
(:mod:`.saturate`), a target-profile-aware cost-guided extractor
(:mod:`.extract`), and a differential concrete-emulation soundness
gate (:mod:`.verify`).  Wired into the pipeline as the ``saturate`` and
``extract`` passes (see ``repro.core.passes.stages``), gated by the
``CompilerOptions.saturate`` knob.
"""

from .egraph import EGraph, ENode  # noqa: F401
from .rules import RULE_REGISTRY, Rule, default_rules, register_rule  # noqa: F401
