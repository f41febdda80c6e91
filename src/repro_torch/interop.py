"""Carry a program and its data over from the JAX package.

:func:`program_from_reference` rebuilds a stencil-DSL ``Program`` written
with ``repro.core.frontend.stencil`` as this package's ``Program``, by
walking its dataclass fields and class names, so nothing of ``repro`` is
imported.  :func:`arrays_from_numpy` keeps the reference's layout, with
``i`` as the last axis.  :func:`dense_params_from_reference`,
:func:`ssm_params_from_reference` and :func:`hybrid_params_from_reference`
turn the reference's initialized ``Model``, ``SSMModel`` and
``HybridModel`` parameters into this package's ``state_dict``
(:func:`params_from_reference` picks one by family), and
:func:`reference_tree` goes the other way.  :func:`train_state_tree` and
:func:`load_train_state` carry a whole train state, the parameters and
the optimizer's ``OptState``, in the reference's layout: the tree the
checkpoint store writes and both packages read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping

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
    bfloat16, which numpy lacks, goes through float32 exactly.  A tensor
    is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x
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
            sd[f"blocks.{i}.{part}.{name}"] = _tensor(leaf[index])


_FROM_REFERENCE = {"dense": dense_params_from_reference, "ssm": ssm_params_from_reference,
                   "hybrid": hybrid_params_from_reference}
_TBLOCK = ("ln1", "attn", "ln2", "mlp")
_MBLOCK = ("ln", "mamba")


def params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's model of ``cfg.family`` holding the
    reference's parameter tree (numpy or tensor leaves)."""
    return _FROM_REFERENCE[cfg.family](cfg, tree)


def _part(state: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The leaves named ``prefix + name``; {} for a non-parametric norm."""
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _stacked(state: Mapping[str, torch.Tensor], parts, layers: List[int],
             lead: tuple) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each leaf of blocks ``layers`` stacked along leading axes ``lead``."""
    out = {}
    for part in parts:
        names = _part(state, f"blocks.{layers[0]}.{part}.")
        out[part] = {n: torch.stack([state[f"blocks.{i}.{part}.{n}"] for i in layers])
                     .reshape(lead + tuple(names[n].shape)) for n in names}
    return out


def reference_tree(cfg, state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's parameter tree of ``cfg`` from a dict keyed like the
    port's ``state_dict`` (the parameters, or an optimizer moment): nested
    dicts of tensors, block leaves stacked on a leading layer axis (the
    hybrid's ``supers`` on (supercell, block)), empty dicts for
    non-parametric norms.  The inverse of :func:`params_from_reference`."""
    tree: Dict[str, Any] = {"embed": {"table": state["embed.table"]},
                            "ln_f": _part(state, "ln_f.")}
    L = cfg.n_layers
    if cfg.family == "hybrid":
        ne = cfg.attn_every
        n_super = L // ne
        tree["supers"] = _stacked(state, _MBLOCK, list(range(n_super * ne)), (n_super, ne))
        tree["shared_attn"] = {p: _part(state, f"shared_attn.{p}.") for p in _TBLOCK}
        if L > n_super * ne:
            tree["trail"] = _stacked(state, _MBLOCK, list(range(n_super * ne, L)),
                                     (L - n_super * ne,))
    else:
        parts = _TBLOCK if cfg.family == "dense" else _MBLOCK
        tree["blocks"] = _stacked(state, parts, list(range(L)), (L,))
    return tree


def reference_ndims(cfg, params: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """Per parameter, the dimensions of the reference's leaf that holds it:
    its own, plus the layer axes a block's leaves are stacked on (two in
    the hybrid's ``supers``, one elsewhere).  The reference decays every
    leaf of two or more dimensions, so every block parameter, vectors
    included."""
    L, ne = cfg.n_layers, cfg.attn_every
    in_supers = (L // ne) * ne if cfg.family == "hybrid" else 0
    out = {}
    for k, p in params.items():
        lead = 0
        if k.startswith("blocks."):
            lead = 2 if int(k.split(".")[1]) < in_supers else 1
        out[k] = p.ndim + lead
    return out


def train_state_tree(cfg, model: torch.nn.Module, opt_state):
    """``(params, OptState(mu, nu, count))`` in the reference's layout: what
    the reference's train loop checkpoints, built off the autograd graph
    (block leaves are stacked copies, the others the tensors themselves)."""
    with torch.no_grad():
        return (reference_tree(cfg, dict(model.named_parameters())),
                opt_state._replace(mu=reference_tree(cfg, opt_state.mu),
                                   nu=reference_tree(cfg, opt_state.nu)))


def load_train_state(cfg, model: torch.nn.Module, opt_state, tree):
    """Copy a :func:`train_state_tree` into ``model`` and into
    ``opt_state``'s moments, in place; returns the state with its count."""
    params, (mu, nu, count) = tree
    with torch.no_grad():
        model.load_state_dict(params_from_reference(cfg, params))
        for moment, src in ((opt_state.mu, mu), (opt_state.nu, nu)):
            for k, v in params_from_reference(cfg, src).items():
                moment[k].copy_(v)
    return opt_state._replace(
        count=torch.as_tensor(count, dtype=torch.int32).to(opt_state.count.device))
