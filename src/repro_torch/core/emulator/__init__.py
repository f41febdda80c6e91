"""Mirrors ``src/repro/core/emulator/__init__.py`` (only the imports differ)."""

from .machine import SymbolicEmulator, emulate  # noqa: F401
from .observe import (  # noqa: F401
    LATENCY_FEATURES,
    MODEL_FEATURES,
    Observation,
    extract_features,
)
from .trace import FlowResult, LoadEvent, StoreEvent  # noqa: F401
