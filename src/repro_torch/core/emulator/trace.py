"""Mirrors ``src/repro/core/emulator/trace.py`` (only the imports differ).

Memory-trace records produced by the symbolic emulator (Section 4.3)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..symbolic import AssumptionSet, Term


@dataclass
class LoadEvent:
    stmt_uid: int          # statement index of the ld instruction
    space: str             # "global" | "shared" | "const" | "local"
    nc: bool               # read-only (.nc) load — never store-invalidated
    addr: Term             # symbolic address (64-bit affine term)
    width: int             # loaded value width in bits
    value: Term            # the UF standing for the loaded data
    block: int             # basic-block id (straight-line flow check)
    order: int             # position within the flow's trace
    invalidated: bool = False   # set when a later store may overwrite it
    guarded: bool = False  # load executed under a predicate


@dataclass
class StoreEvent:
    stmt_uid: int
    space: str
    addr: Term
    width: int
    value: Term
    block: int
    order: int


@dataclass
class FlowResult:
    """One completed execution flow: its trace and path assumptions."""

    flow_id: int
    trace: List[object] = field(default_factory=list)   # Load/Store events
    assumptions: Optional[AssumptionSet] = None
    terminated: str = "ret"   # "ret" | "backedge" | "memo" | "limit"

    def loads(self) -> List[LoadEvent]:
        return [e for e in self.trace if isinstance(e, LoadEvent)]

    def stores(self) -> List[StoreEvent]:
        return [e for e in self.trace if isinstance(e, StoreEvent)]
