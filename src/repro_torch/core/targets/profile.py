"""Mirrors ``src/repro/core/targets/profile.py`` (only the imports differ).

Data-driven GPU architecture profiles.

A :class:`TargetProfile` is the single source of truth for everything
the middle-end knows about one GPU generation: the Table-1 latency
calibration the cycle model weights event counts with, the
latency-hiding factors (MLP / shuffle ILP), the warp geometry, and the
ISA capabilities codegen must respect (legacy ``shfl`` vs
``shfl.sync`` + membermask).  Profiles are plain data — engines
(cycle model, selection pass, codegen, printer) consume them through
the registry (:mod:`repro.core.targets.registry`) so adding an
architecture is a data change, not a code change.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Mapping


@dataclass(frozen=True)
class TargetProfile:
    """One GPU generation as the middle-end sees it.

    ``latency`` carries the paper's Table 1 columns in clock cycles:
    ``shfl`` (warp shuffle), ``sm`` (shared-memory read), ``l1``
    (L1-cache hit).  ``calibration`` records whether those numbers come
    from the paper's Table 1 or are extrapolations for generations the
    paper did not measure.
    """

    name: str                      # registry key, e.g. "pascal"
    sm: int                        # compute capability, e.g. 61
    arch: str                      # display name, e.g. "Pascal"
    latency: Dict[str, int]        # {"shfl": .., "sm": .., "l1": ..}
    mlp: float                     # outstanding loads an SM overlaps
    has_shfl_sync: bool            # sm_70+: shfl.sync + membermask ISA
    shfl_ilp: float = 4.0          # shuffle-hiding slots (exec dependency)
    # parameterizes codegen arithmetic (lane modulus, shuffle clamps,
    # membermasks) and the cost model's corner fraction; values other
    # than 32 exercise codegen shape only — the PTX .b32 shuffle forms
    # and the 32-lane emulators do not model such hardware
    warp_width: int = 32
    ptx_version: str = "7.6"       # .version the printer emits
    address_size: str = "64"
    calibration: str = "table1"    # "table1" | "extrapolated"
    # issue-side costs (cycles per executed instruction)
    alu_cost: float = 0.5          # dual-issue integer pipe
    falu_cost: float = 1.0
    branch_cost: float = 2.0
    pred_off_cost: float = 0.25    # issued-but-masked slot

    @property
    def sm_name(self) -> str:
        return f"sm_{self.sm}"

    @property
    def full_membermask(self) -> int:
        return (1 << self.warp_width) - 1

    @property
    def shfl_hide(self) -> float:
        """Hiding factor for shuffles: they serialize with their
        consumers (execution dependency, paper Section 8.1), so they are
        hidden less well than loads."""
        return min(self.mlp, self.shfl_ilp)

    @property
    def l1_over_shuffle(self) -> float:
        """The paper's headline profitability ratio: >1 means a shuffle
        is cheaper than the cache hit it replaces."""
        return self.latency["l1"] / self.latency["shfl"]

    # ------------------------------------------------------------------
    # persistence (calibration JSON round-trip)
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON-serializable view of the profile (all fields)."""
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "TargetProfile":
        """Rebuild a profile from :meth:`to_dict` output.  Unknown keys
        are rejected loudly — a schema drift should fail a load, not
        silently drop a field."""
        fields = {f for f in cls.__dataclass_fields__}  # noqa: C401
        extra = set(data) - fields
        if extra:
            raise ValueError(f"unknown TargetProfile fields: {sorted(extra)}")
        kwargs = dict(data)
        if "latency" not in kwargs:
            raise ValueError("TargetProfile data is missing 'latency'")
        kwargs["latency"] = dict(kwargs["latency"])
        return cls(**kwargs)
