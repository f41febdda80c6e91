"""Mirrors ``src/repro/core/synthesis/__init__.py`` (only the imports differ)."""

from .detect import DetectionResult, ShufflePair, detect  # noqa: F401
from .codegen import MODES, synthesize  # noqa: F401
from .pipeline import KernelReport, ptxasw, ptxasw_kernel  # noqa: F401
