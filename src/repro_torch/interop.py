"""Carry a program and its data over from the JAX package.

:func:`program_from_reference` rebuilds a stencil-DSL ``Program`` written
with ``repro.core.frontend.stencil`` as this package's ``Program``, by
walking its dataclass fields and class names, so nothing of ``repro`` is
imported.  :func:`arrays_from_numpy` keeps the reference's layout, with
``i`` as the last axis.  :func:`dense_params_from_reference`,
:func:`ssm_params_from_reference` and :func:`hybrid_params_from_reference`
turn the reference's initialized ``Model``, ``SSMModel`` and
``HybridModel`` parameters into this package's ``state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

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


def _tensor(x) -> torch.Tensor:
    """A numpy (or array-like) leaf as a tensor of the same dtype;
    bfloat16, which numpy lacks, goes through float32 exactly."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def dense_params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``repro_torch.models.Model(cfg)`` holding the
    reference's unboxed ``Model.init`` parameters (numpy leaves; block
    leaves stacked on a leading layer axis).  A ``nonparametric`` norm has
    no leaves, so OLMo's ``ln1``, ``ln2`` and ``ln_f`` give no keys."""
    sd = _head_params(tree)
    for i in range(cfg.n_layers):
        _stacked_block(sd, i, tree["blocks"], (i,))
    return sd


def ssm_params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``repro_torch.models.SSMModel(cfg)`` holding
    the reference's unboxed ``SSMModel.init`` parameters (numpy leaves;
    block leaves stacked on a leading layer axis)."""
    sd = _head_params(tree)
    for i in range(cfg.n_layers):
        _stacked_block(sd, i, tree["blocks"], (i,))
    return sd


def hybrid_params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``repro_torch.models.HybridModel(cfg)``
    holding the reference's unboxed ``HybridModel.init`` parameters
    (numpy leaves): ``supers[s][j]`` becomes block ``s * attn_every + j``,
    ``trail[t]`` block ``n_super * attn_every + t``, and ``shared_attn``
    the shared transformer block."""
    ne = cfg.attn_every
    n_super = cfg.n_layers // ne
    sd = _head_params(tree)
    for s in range(n_super):
        for j in range(ne):
            _stacked_block(sd, s * ne + j, tree["supers"], (s, j))
    for t in range(cfg.n_layers - n_super * ne):
        _stacked_block(sd, n_super * ne + t, tree["trail"], (t,))
    for part, leaves in tree["shared_attn"].items():
        for name, leaf in leaves.items():
            sd[f"shared_attn.{part}.{name}"] = _tensor(leaf)
    return sd


def _head_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd = {"embed.table": _tensor(tree["embed"]["table"])}
    for name, leaf in tree["ln_f"].items():
        sd[f"ln_f.{name}"] = _tensor(leaf)
    return sd


def _stacked_block(sd: Dict[str, torch.Tensor], i: int,
                   stacked: Mapping[str, Any], index: tuple) -> None:
    """Block ``i`` of the port from the stacked leaves at ``index``."""
    for part, leaves in stacked.items():
        for name, leaf in leaves.items():
            sd[f"blocks.{i}.{part}.{name}"] = _tensor(np.asarray(leaf)[index])
