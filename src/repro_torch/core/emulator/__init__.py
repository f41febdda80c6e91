from .machine import SymbolicEmulator, emulate  # noqa: F401
from .trace import FlowResult, LoadEvent, StoreEvent  # noqa: F401
