"""Mirrors ``src/repro/core/targets/__init__.py`` (only the imports differ).

Target subsystem: data-driven GPU architecture profiles.

Public API::

    from repro_torch.core.targets import (
        TargetProfile, register_target, resolve_target, get_target,
        all_targets, target_names, default_target,
    )

Profiles (latency tables, hiding factors, warp geometry, ISA
capabilities) are data; the cycle model, the ``select-shuffles`` pass,
codegen, and the printer are the engines that consume them.  Cost
scoring lives in :mod:`repro.core.targets.cost` and the autotuned
calibration harness (microbenchmark suite + measurement backends +
least-squares/coordinate-descent fitter that registers
``"<gen>-tuned"`` profiles) in :mod:`repro.core.targets.calibrate`;
both are imported lazily to keep the package import-light.
"""

from .profile import TargetProfile  # noqa: F401
from .registry import (  # noqa: F401
    AMPERE,
    HOPPER,
    KEPLER,
    MAXWELL,
    PASCAL,
    VOLTA,
    all_targets,
    default_target,
    get_target,
    register_target,
    resolve_target,
    target_names,
    unregister_target,
)
