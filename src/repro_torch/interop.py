"""Carry a program and its data over from the JAX package.

:func:`program_from_reference` rebuilds a stencil-DSL ``Program`` written
with ``repro.core.frontend.stencil`` as this package's ``Program``, by
walking its dataclass fields and class names, so nothing of ``repro`` is
imported.  :func:`arrays_from_numpy` keeps the reference's layout, with
``i`` as the last axis.  :func:`params_from_reference` turns the
reference's initialized parameters of any family (``Model`` dense or
MoE, ``VLMModel``, ``SSMModel``, ``HybridModel``, ``EncDecModel``) into
this package's ``state_dict``, through one ``*_params_from_reference``
per family, and :func:`reference_tree` goes the other way.  :func:`train_state_tree` and
:func:`load_train_state` carry a whole train state, the parameters and
the optimizer's ``OptState``, in the reference's layout: the tree the
checkpoint store writes and both packages read.  :func:`logical_axes`
gives each parameter the reference's logical axes, which the sharding
rules resolve against a mesh.
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
    """The ``state_dict`` of ``repro_torch.models.Model(cfg)`` (dense or
    MoE) holding the reference's unboxed ``Model.init`` parameters (numpy
    leaves; block leaves stacked on a leading layer axis).  A
    ``nonparametric`` norm has no leaves, so OLMo's ``ln1``, ``ln2`` and
    ``ln_f`` give no keys."""
    sd = _head_params(tree)
    for i in range(cfg.n_layers):
        _stacked_block(sd, f"blocks.{i}", tree["blocks"], (i,))
    return sd


def ssm_params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``repro_torch.models.SSMModel(cfg)`` holding
    the reference's unboxed ``SSMModel.init`` parameters (numpy leaves;
    block leaves stacked on a leading layer axis)."""
    return dense_params_from_reference(cfg, tree)


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
            _stacked_block(sd, f"blocks.{s * ne + j}", tree["supers"], (s, j))
    for t in range(cfg.n_layers - n_super * ne):
        _stacked_block(sd, f"blocks.{n_super * ne + t}", tree["trail"], (t,))
    _stacked_block(sd, "shared_attn", tree["shared_attn"], ())
    return sd


def vlm_params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``repro_torch.models.VLMModel(cfg)`` holding
    the reference's unboxed ``VLMModel.init`` parameters (numpy leaves):
    ``super_self[s][j]`` (stacked on (supercell, block)) becomes block
    ``s * (cross_every - 1) + j``, ``super_cross[s]`` cross block ``s``,
    its scalar ``gate`` included."""
    n_self = cfg.cross_every - 1
    sd = _head_params(tree)
    for s in range(cfg.n_layers // cfg.cross_every):
        for j in range(n_self):
            _stacked_block(sd, f"blocks.{s * n_self + j}", tree["super_self"], (s, j))
        _stacked_block(sd, f"cross.{s}", tree["super_cross"], (s,))
    return sd


def encdec_params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``repro_torch.models.EncDecModel(cfg)`` holding
    the reference's unboxed ``EncDecModel.init`` parameters (numpy
    leaves): ``enc_blocks[i]`` and ``enc_ln`` under the same names, the
    decoder's ``dec_blocks[i]`` as ``blocks.i``."""
    sd = _head_params(tree)
    for i in range(cfg.n_encoder_layers):
        _stacked_block(sd, f"enc_blocks.{i}", tree["enc_blocks"], (i,))
    for name, leaf in tree["enc_ln"].items():
        sd[f"enc_ln.{name}"] = _tensor(leaf)
    for i in range(cfg.n_layers):
        _stacked_block(sd, f"blocks.{i}", tree["dec_blocks"], (i,))
    return sd


def _head_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd = {"embed.table": _tensor(tree["embed"]["table"])}
    for name, leaf in tree["ln_f"].items():
        sd[f"ln_f.{name}"] = _tensor(leaf)
    return sd


def _stacked_block(sd: Dict[str, torch.Tensor], prefix: str,
                   stacked: Mapping[str, Any], index: tuple) -> None:
    """The port's block ``prefix`` from the stacked leaves at ``index``: a
    part that is a dict of leaves gives ``prefix.part.name``, a part that
    is a leaf (the VLM's ``gate``) ``prefix.part``."""
    for part, leaves in stacked.items():
        if isinstance(leaves, Mapping):
            for name, leaf in leaves.items():
                sd[f"{prefix}.{part}.{name}"] = _tensor(leaf[index])
        else:
            sd[f"{prefix}.{part}"] = _tensor(leaves[index])


_FROM_REFERENCE = {"dense": dense_params_from_reference, "moe": dense_params_from_reference,
                   "ssm": ssm_params_from_reference, "hybrid": hybrid_params_from_reference,
                   "vlm": vlm_params_from_reference, "audio": encdec_params_from_reference}
_MBLOCK = ("ln", "mamba")
_XBLOCK = ("ln1", "xattn", "ln2", "mlp", "gate")                     # the VLM's cross block
_DEC_BLOCK = ("ln1", "attn", "lnx", "xattn", "ln2", "mlp")           # the enc-dec decoder's


def _tblock(cfg) -> tuple:
    """A transformer block's parts: the MoE ffn or the MLP."""
    return ("ln1", "attn", "ln2", "moe" if cfg.n_experts else "mlp")


def params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's model of ``cfg.family`` holding the
    reference's parameter tree (numpy or tensor leaves)."""
    return _FROM_REFERENCE[cfg.family](cfg, tree)


def _part(state: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The leaves named ``prefix + name``; {} for a non-parametric norm."""
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _stacked(state: Mapping[str, torch.Tensor], parts, layers: List[int],
             lead: tuple, prefix: str = "blocks") -> Dict[str, Any]:
    """Each leaf of blocks ``prefix.i`` for i in ``layers``, stacked along
    leading axes ``lead``; a part that is a leaf stacks as one."""
    def stack(keys):
        return torch.stack([state[k] for k in keys]).reshape(lead + state[keys[0]].shape)

    out: Dict[str, Any] = {}
    for part in parts:
        if f"{prefix}.{layers[0]}.{part}" in state:
            out[part] = stack([f"{prefix}.{i}.{part}" for i in layers])
            continue
        names = _part(state, f"{prefix}.{layers[0]}.{part}.")
        out[part] = {n: stack([f"{prefix}.{i}.{part}.{n}" for i in layers]) for n in names}
    return out


def reference_tree(cfg, state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's parameter tree of ``cfg`` from a dict keyed like the
    port's ``state_dict`` (the parameters, or an optimizer moment): nested
    dicts of tensors, block leaves stacked on a leading layer axis (the
    hybrid's ``supers`` and the VLM's ``super_self`` on (supercell,
    block)), empty dicts for non-parametric norms.  The inverse of
    :func:`params_from_reference`."""
    tree: Dict[str, Any] = {"embed": {"table": state["embed.table"]},
                            "ln_f": _part(state, "ln_f.")}
    L = cfg.n_layers
    if cfg.family == "hybrid":
        ne = cfg.attn_every
        n_super = L // ne
        tree["supers"] = _stacked(state, _MBLOCK, list(range(n_super * ne)), (n_super, ne))
        tree["shared_attn"] = {p: _part(state, f"shared_attn.{p}.") for p in _tblock(cfg)}
        if L > n_super * ne:
            tree["trail"] = _stacked(state, _MBLOCK, list(range(n_super * ne, L)),
                                     (L - n_super * ne,))
    elif cfg.family == "vlm":
        n_super, n_self = L // cfg.cross_every, cfg.cross_every - 1
        tree["super_self"] = _stacked(state, _tblock(cfg), list(range(n_super * n_self)),
                                      (n_super, n_self))
        tree["super_cross"] = _stacked(state, _XBLOCK, list(range(n_super)), (n_super,),
                                       prefix="cross")
    elif cfg.family == "audio":
        E = cfg.n_encoder_layers
        tree["enc_blocks"] = _stacked(state, _tblock(cfg), list(range(E)), (E,),
                                      prefix="enc_blocks")
        tree["enc_ln"] = _part(state, "enc_ln.")
        tree["dec_blocks"] = _stacked(state, _DEC_BLOCK, list(range(L)), (L,))
    else:
        parts = _MBLOCK if cfg.family == "ssm" else _tblock(cfg)
        tree["blocks"] = _stacked(state, parts, list(range(L)), (L,))
    return tree


def reference_ndims(cfg, params: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """Per parameter, the dimensions of the reference's leaf that holds it:
    its own, plus the layer axes a block's leaves are stacked on (two in
    the hybrid's ``supers`` and the VLM's ``super_self``, one in every
    other stack: blocks, the VLM's cross blocks, the encoder's blocks).
    The reference decays every leaf of two or more dimensions, so every
    block parameter, vectors included, but not the VLM's scalar gates,
    which stack to one dimension."""
    L, ne = cfg.n_layers, cfg.attn_every
    in_supers = {"hybrid": (L // ne) * ne, "vlm": L}.get(cfg.family, 0)
    out = {}
    for k, p in params.items():
        head, _, rest = k.partition(".")
        lead = 0
        if head == "blocks":
            lead = 2 if int(rest.split(".")[0]) < in_supers else 1
        elif head in ("cross", "enc_blocks"):
            lead = 1
        out[k] = p.ndim + lead
    return out


# the reference's logical axes (src/repro/models/{attention,mlp,moe,mamba2}.py)
# by (part, leaf name); a norm's leaves are ("embed",) whatever the part
_AXES = {
    **{(part, "wq"): ("embed", "heads", "head_dim") for part in ("attn", "xattn")},
    **{(part, w): ("embed", "kv_heads", "head_dim")
       for part in ("attn", "xattn") for w in ("wk", "wv")},
    **{(part, "wo"): ("heads", "head_dim", "embed") for part in ("attn", "xattn")},
    ("mlp", "w_up"): ("embed", "ff"), ("mlp", "w_gate"): ("embed", "ff"),
    ("mlp", "w_down"): ("ff", "embed"),
    ("moe", "router"): ("embed", "expert"), ("moe", "w_gate"): ("expert", "embed", "ff"),
    ("moe", "w_up"): ("expert", "embed", "ff"), ("moe", "w_down"): ("expert", "ff", "embed"),
    ("mamba", "w_in"): ("embed", "inner"), ("mamba", "conv_w"): ("conv", "inner"),
    ("mamba", "conv_b"): ("inner",), ("mamba", "a_log"): ("heads",),
    ("mamba", "dt_bias"): ("heads",), ("mamba", "d_skip"): ("heads",),
    ("mamba", "norm_scale"): ("inner",), ("mamba", "w_out"): ("inner", "embed"),
    ("embed", "table"): ("vocab", "embed"),
}


def logical_axes(cfg, model: torch.nn.Module) -> Dict[str, tuple]:
    """Per parameter of the port's ``model``, the reference's logical axes
    of the leaf that holds it (``src/repro/models/common.py:21-31``), less
    the ``layers`` axes a stacked leaf carries: the port's blocks are a
    flat ``ModuleList``.  The VLM's scalar gate has none."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf, part = parts[-1], parts[-2] if len(parts) > 1 else ""
        if leaf == "gate" and p.ndim == 0:
            out[name] = ()
        elif leaf in ("scale", "bias"):
            out[name] = ("embed",)
        elif (part, leaf) in _AXES:
            out[name] = _AXES[part, leaf]
        else:
            raise KeyError(f"{cfg.name}: no logical axes for parameter {name}")
        if len(out[name]) != p.ndim:
            raise ValueError(f"{name}: axes {out[name]} for shape {tuple(p.shape)}")
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
