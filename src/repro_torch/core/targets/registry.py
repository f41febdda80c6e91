"""Mirrors ``src/repro/core/targets/registry.py`` (only the imports differ).

Target registry: named profiles + resolution from ``.target`` strings.

Built-in profiles cover the paper's four measured generations (Table 1
[16, 33]) plus Ampere/Hopper extrapolations.  ``resolve_target``
accepts a profile, a registry name (``"pascal"``), an ``sm_XX`` string
(exact or nearest-below match, so ``sm_75`` resolves to Volta), a full
``.target`` directive payload (``"sm_90a, texmode_independent"``), or
``None`` for the process default.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Tuple, Union

from .profile import TargetProfile

_REGISTRY: Dict[str, TargetProfile] = {}

# Registration is no longer an import-time-only event: the calibration
# harness (targets.calibrate) registers fitted profiles at runtime,
# possibly while parallel run_module compiles are resolving targets on
# worker threads.  Every read/write of _REGISTRY holds this lock.
_LOCK = threading.RLock()

_SM_RE = re.compile(r"sm_(\d+)")


def register_target(profile: TargetProfile,
                    overwrite: bool = False) -> TargetProfile:
    """Register a profile under its name (and make it sm-resolvable).

    Re-registering an existing name raises unless ``overwrite=True``,
    and even then only profiles whose registered entry carries
    ``calibration="fitted"`` may be replaced — re-running a calibration
    is idempotent, but the built-in Table-1 data cards cannot be
    clobbered by accident.
    """
    with _LOCK:
        existing = _REGISTRY.get(profile.name)
        if existing is not None:
            if not overwrite:
                raise ValueError(
                    f"target {profile.name!r} already registered "
                    "(pass overwrite=True to replace a fitted profile)")
            if existing.calibration != "fitted":
                raise ValueError(
                    f"target {profile.name!r} is a built-in "
                    f"{existing.calibration!r} profile; only "
                    "calibration='fitted' entries may be overwritten")
        _REGISTRY[profile.name] = profile
    return profile


def unregister_target(name: str) -> TargetProfile:
    """Remove a runtime-registered fitted profile (tests,
    re-calibration).  Built-in data cards cannot be removed — the same
    protection ``register_target``'s overwrite guard gives them."""
    with _LOCK:
        if name == _DEFAULT_NAME:
            raise ValueError(f"cannot unregister the default target {name!r}")
        try:
            existing = _REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown target profile {name!r}") from None
        if existing.calibration != "fitted":
            raise ValueError(
                f"target {name!r} is a built-in {existing.calibration!r} "
                "profile; only calibration='fitted' entries can be removed")
        return _REGISTRY.pop(name)


def target_names() -> Tuple[str, ...]:
    """Registered profile names, ascending by compute capability."""
    return tuple(p.name for p in all_targets())


def all_targets() -> Tuple[TargetProfile, ...]:
    with _LOCK:
        profiles = list(_REGISTRY.values())
    # deterministic order even when a fitted profile shares its base
    # profile's compute capability
    return tuple(sorted(profiles, key=lambda p: (p.sm, p.name)))


def default_target() -> TargetProfile:
    """The process default (what the printer's fallback directives and
    unconfigured pipelines use)."""
    with _LOCK:
        return _REGISTRY[_DEFAULT_NAME]


def get_target(name: str) -> TargetProfile:
    """Strict lookup by registered profile name (no sm resolution)."""
    with _LOCK:
        try:
            return _REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown target profile {name!r}; registered: "
                           f"{sorted(_REGISTRY)}") from None


def resolve_target(spec: Union[TargetProfile, str, None] = None
                   ) -> TargetProfile:
    """Resolve a profile from a name, sm string, directive, or None."""
    if spec is None:
        return default_target()
    if isinstance(spec, TargetProfile):
        return spec
    s = spec.split(",")[0].strip().lower()
    with _LOCK:
        if s in _REGISTRY:
            return _REGISTRY[s]
    m = _SM_RE.match(s)
    if m:
        n = int(m.group(1))
        if n < 30:
            # pre-Kepler ISAs have no warp shuffle at all: refusing is
            # better than stamping shfl code for hardware that cannot
            # run it
            raise KeyError(f"target {spec!r} predates the warp-shuffle "
                           "ISA (sm_30); no profile can model it")
        # fitted profiles share their base generation's sm; resolving a
        # hardware string must keep electing the hardware data card —
        # tuned profiles are opted into by name
        profiles = [p for p in all_targets() if p.calibration != "fitted"]
        at_or_below = [p for p in profiles if p.sm <= n]
        # sm_30..34 fall forward to the lowest profile (Kepler): same
        # ISA generation, only the latency calibration is borrowed
        return at_or_below[-1] if at_or_below else profiles[0]
    with _LOCK:
        known = sorted(_REGISTRY)
    raise KeyError(f"unknown target {spec!r}; registered: "
                   f"{known} (or any sm_XX >= 30)")


# ---------------------------------------------------------------------------
# built-in profiles
# ---------------------------------------------------------------------------
# Latencies for Kepler..Volta are the paper's Table 1 (clock cycles);
# MLP reflects Section 8's analysis (Volta's scheduler hides the most
# latency, Kepler the least).  Ampere/Hopper extend the Volta trend
# (fast L1, deeper schedulers) and are marked "extrapolated".

KEPLER = register_target(TargetProfile(
    name="kepler", sm=35, arch="Kepler (K40)",
    latency=dict(shfl=24, sm=26, l1=35), mlp=4.0,
    has_shfl_sync=False, ptx_version="6.3"))

MAXWELL = register_target(TargetProfile(
    name="maxwell", sm=52, arch="Maxwell (GTX TITAN X)",
    latency=dict(shfl=33, sm=23, l1=82), mlp=6.0,
    has_shfl_sync=False, ptx_version="6.3"))

PASCAL = register_target(TargetProfile(
    name="pascal", sm=61, arch="Pascal (TITAN X)",
    latency=dict(shfl=33, sm=24, l1=82), mlp=6.0,
    has_shfl_sync=False, ptx_version="6.3"))

VOLTA = register_target(TargetProfile(
    name="volta", sm=70, arch="Volta (V100)",
    latency=dict(shfl=22, sm=19, l1=28), mlp=8.0,
    has_shfl_sync=True, ptx_version="7.6"))

AMPERE = register_target(TargetProfile(
    name="ampere", sm=80, arch="Ampere (A100)",
    latency=dict(shfl=23, sm=22, l1=33), mlp=10.0,
    has_shfl_sync=True, ptx_version="7.8", calibration="extrapolated"))

HOPPER = register_target(TargetProfile(
    name="hopper", sm=90, arch="Hopper (H100)",
    latency=dict(shfl=25, sm=24, l1=33), mlp=12.0,
    has_shfl_sync=True, ptx_version="8.2", calibration="extrapolated"))

#: the printer's historical fallback was sm_70 — keep Volta the default
_DEFAULT_NAME = "volta"
