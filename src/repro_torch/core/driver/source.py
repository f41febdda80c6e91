"""Mirrors ``src/repro/core/driver/source.py`` (only the imports differ).

Polymorphic source ingestion: the driver's frontend registry.

The paper's tool feeds two frontends (CUDA and OpenACC) into one
middle-end; this registry generalizes that: any object a registered
frontend recognizes normalizes to a parsed :class:`~repro.core.ptx.ir.Module`
the same way, and the :class:`~repro.core.driver.Compiler` only ever
sees modules.  Built-in frontends, tried in registration order:

=============  ==========================================  =============
name           accepts                                     via
=============  ==========================================  =============
``ptx``        PTX text (``str``)                          ``ptx.parser.parse``
``module``     parsed :class:`Module`                      identity
``kernel``     parsed :class:`Kernel`                      1-kernel module
``stencil``    stencil-DSL :class:`Program`                ``lower_to_ptx``
``kernelgen``  KernelGen :class:`Bench`                    ``lower_to_ptx``
=============  ==========================================  =============

A frontend may attach *option hints* (e.g. a KernelGen bench carries
its own ``max_delta``); the driver applies a hint only when the caller
did not set that field explicitly.  Register new ingestion forms with
:func:`register_frontend`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple, Union

from ..frontend.kernelgen import Bench
from ..frontend.stencil import Program, lower_to_ptx
from ..ptx.ir import Kernel, Module
from ..ptx.parser import parse

#: The built-in ingestion forms (open set: any type a registered
#: frontend's ``matches`` accepts compiles the same way).
Source = Union[str, Module, Kernel, Program, Bench]


@dataclass(frozen=True)
class NormalizedSource:
    """A source after frontend normalization: one module + provenance."""

    module: Module
    frontend: str
    #: pipeline-option hints carried by the source itself (applied only
    #: where the caller set nothing explicitly)
    option_hints: Mapping[str, object] = field(default_factory=dict)


@dataclass(frozen=True)
class SourceFrontend:
    """One ingestion form: a predicate plus a normalizer."""

    name: str
    matches: Callable[[object], bool]
    normalize: Callable[[object], NormalizedSource]


_FRONTENDS: Dict[str, SourceFrontend] = {}


def register_frontend(name: str, matches: Callable[[object], bool],
                      normalize: Callable[[object], NormalizedSource],
                      *, overwrite: bool = False) -> SourceFrontend:
    """Register an ingestion form; frontends are tried in registration
    order, first match wins."""
    if name in _FRONTENDS and not overwrite:
        raise ValueError(f"frontend {name!r} already registered")
    fe = SourceFrontend(name=name, matches=matches, normalize=normalize)
    _FRONTENDS[name] = fe
    return fe


def frontend_names() -> Tuple[str, ...]:
    return tuple(_FRONTENDS)


def normalize_source(src: object) -> NormalizedSource:
    """Normalize any supported source to a module, or raise ``TypeError``."""
    for fe in _FRONTENDS.values():
        if fe.matches(src):
            return fe.normalize(src)
    raise TypeError(
        f"no frontend accepts {type(src).__name__!r}; registered "
        f"frontends: {list(_FRONTENDS)} (register_frontend to add one)")


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

register_frontend(
    "ptx", lambda s: isinstance(s, str),
    lambda s: NormalizedSource(module=parse(s), frontend="ptx"))

register_frontend(
    "module", lambda s: isinstance(s, Module),
    lambda s: NormalizedSource(module=s, frontend="module"))

register_frontend(
    "kernel", lambda s: isinstance(s, Kernel),
    lambda s: NormalizedSource(module=Module(kernels=[s]),
                               frontend="kernel"))

register_frontend(
    "stencil", lambda s: isinstance(s, Program),
    lambda s: NormalizedSource(module=Module(kernels=[lower_to_ptx(s)]),
                               frontend="stencil"))

register_frontend(
    "kernelgen", lambda s: isinstance(s, Bench),
    lambda s: NormalizedSource(module=Module(kernels=[lower_to_ptx(s.program)]),
                               frontend="kernelgen",
                               option_hints={"max_delta": s.max_delta}))
