"""Carry a program and its data over from the JAX package.

:func:`program_from_reference` rebuilds a stencil-DSL ``Program`` written
with ``repro.core.frontend.stencil`` as this package's ``Program``, by
walking its dataclass fields and class names, so nothing of ``repro`` is
imported.  :func:`arrays_from_numpy` keeps the reference's layout, with
``i`` as the last axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.frontend import stencil as dsl

_NODES = {cls.__name__: cls for cls in
          (dsl.Index, dsl.Const, dsl.Scalar, dsl.Load, dsl.Bin, dsl.Call,
           dsl.Reduce, dsl.Program)}


def _convert(obj):
    name = type(obj).__name__
    if dataclasses.is_dataclass(obj) and name in _NODES:
        fields = {f.name: _convert(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)}
        return _NODES[name](**fields)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_convert(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _convert(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    raise TypeError(f"cannot carry a {name} over to the port")


def program_from_reference(obj) -> dsl.Program:
    """The port's ``Program`` equal, field for field, to a reference one."""
    if type(obj).__name__ != "Program" or not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected a stencil-DSL Program, got {type(obj).__name__}")
    return _convert(obj)


def arrays_from_numpy(arrays: Dict[str, np.ndarray],
                      device: str = "cuda") -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device``, same shapes and axis order."""
    return {name: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
            for name, x in arrays.items()}
