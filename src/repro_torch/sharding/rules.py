"""Logical-axis -> mesh-axis sharding rules (mirrors
``src/repro/sharding/rules.py``).

Each parameter of the port has logical axis names
(``interop.logical_axes``); this module resolves them against a mesh
into a :class:`PartitionSpec` and then into DTensor placements.
Resolution is *divisibility-checked*: a logical axis whose dimension
does not divide the mapped mesh-axis size falls back to replication for
that dim (GQA archs with n_kv_heads < the tensor-axis size, vocab sizes
that are not lane multiples), and the fallback is reported.

Default logical map (16x16 production mesh):

  vocab   -> model   (tensor-parallel unembedding)
  embed   -> data    (ZeRO-3/FSDP: params gathered per use)
  heads   -> model   (tensor-parallel attention)
  kv_heads-> model   (replicated automatically when kv < |model|)
  ff      -> model   (tensor-parallel MLP)
  expert  -> data    (expert parallelism: all_to_all dispatch)
  inner   -> model   (SSM inner dim)
  batch   -> (pod, data)
  seq     -> model   (sequence parallelism in MoE dispatch / long ctx)

A mesh is a ``DeviceMesh`` or, for the rules alone, a plain ``{name:
size}`` mapping (the reference's tests use such a stand-in); axis sizes
are read through :func:`mesh_axes` either way.  The reference's GSPMD
partitions global arrays; the port runs one process per mesh
coordinate, so a "sharding" here is a list of placements, one per mesh
dimension, and ``constrain_batch`` checks a local activation rather than
asking a compiler to reshard it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

AxisMap = Dict[str, Union[str, Tuple[str, ...], None]]

DEFAULT_RULES: AxisMap = {
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "expert": "data",
    "layers": None,
    "conv": None,
    "state": None,
    "inner": "model",
    "batch": ("pod", "data"),
    "seq": "model",
}

BATCH_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of names
    (the dimension split over several axes, the first outermost) or None
    (replicated); equal, entry by entry, to the reference's ``P``.  Missing
    trailing entries are replicated (``resolve_spec`` drops them)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a ``{name: size}``
    mapping (or of an object whose ``shape`` is one)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _axis_size(axes_of: Mapping[str, int], axes: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= axes_of[a]
    return n


def resolve_spec(shape: Tuple[int, ...],
                 logical: Tuple[Optional[str], ...],
                 mesh,
                 rules: Optional[AxisMap] = None,
                 report: Optional[List[str]] = None) -> PartitionSpec:
    """Logical axes tuple -> PartitionSpec, with divisibility fallback."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    parts: List[Any] = []
    used: set = set()
    for dim, name in zip(shape, logical):
        mapped = rules.get(name) if name else None
        if mapped is None:
            parts.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        # a mesh axis may appear once per spec
        if any(a in used for a in axes) or any(a not in sizes for a in axes):
            parts.append(None)
            continue
        if dim % _axis_size(sizes, axes) != 0:
            if report is not None:
                report.append(
                    f"dim {name}={dim} not divisible by {axes} "
                    f"({_axis_size(sizes, axes)}) -> replicated")
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes[0] if len(axes) == 1 else tuple(axes))
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def placements(spec: PartitionSpec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that splits tensor dimension d, else ``Replicate()``.
    A dimension split over several axes takes them outermost first, which
    DTensor does in mesh order; a spec naming them in another order has no
    placements."""
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(f"{spec}: axes {axes} of dim {d} are not in "
                                      f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def param_specs(model, mesh, rules: Optional[AxisMap] = None,
                report: Optional[List[str]] = None) -> Dict[str, PartitionSpec]:
    """{parameter name: PartitionSpec} of the port's ``model``."""
    from repro_torch.interop import logical_axes
    axes = logical_axes(model.cfg, model)
    return {name: resolve_spec(tuple(p.shape), axes[name], mesh, rules, report)
            for name, p in model.named_parameters()}


def param_shardings(model, mesh, rules: Optional[AxisMap] = None,
                    report: Optional[List[str]] = None) -> Dict[str, list]:
    """{parameter name: DTensor placements}: the reference's
    ``NamedSharding`` per leaf."""
    return {name: placements(spec, mesh)
            for name, spec in param_specs(model, mesh, rules, report).items()}


def batch_spec(mesh, rules: Optional[AxisMap] = None) -> PartitionSpec:
    """The token batches' (B, S) spec: batch over (pod, data)."""
    rules = rules or DEFAULT_RULES
    b = rules.get("batch")
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in ((b,) if isinstance(b, str) else b) if a in sizes)
    return PartitionSpec(axes if len(axes) > 1 else axes[0])


def batch_sharding(mesh, rules: Optional[AxisMap] = None) -> list:
    """The placements of the token batches: :func:`batch_spec` on ``mesh``."""
    return placements(batch_spec(mesh, rules), mesh)


def shard_batch_spec(mesh, shape: Tuple[int, ...],
                     batch_dim: int = 0) -> PartitionSpec:
    """``shape``'s batch dimension over (pod, data) where it divides, else
    replicated."""
    sizes = mesh_axes(mesh)
    parts: List[Any] = [None] * len(shape)
    axes = tuple(a for a in BATCH_AXES if a in sizes)
    if shape[batch_dim] % _axis_size(sizes, axes) == 0:
        parts[batch_dim] = axes if len(axes) > 1 else axes[0]
    return PartitionSpec(*parts)


def rules_for(cfg, mesh) -> AxisMap:
    """Config-aware rules: the MoE ``ep_tp`` schedule stores experts on
    the tensor axis with full-width FFN, so the logical EXPERT axis maps
    to 'model' and FF replicates (matching the sharded dispatch's
    layout, with no resharding at the boundary)."""
    rules = dict(DEFAULT_RULES)
    sched = getattr(cfg, "moe_schedule", "2d")
    if getattr(cfg, "n_experts", 0) and sched in ("ep_tp", "auto"):
        from repro_torch.models.moe import choose_schedule
        resolved = sched if sched != "auto" else choose_schedule(
            cfg.n_experts, cfg.d_model, cfg.d_ff, mesh)
        if resolved == "ep_tp":
            rules["expert"] = "model"
            rules["ff"] = None
    return rules


def local_shape(shape: Tuple[int, ...], spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec`` (every split dimension divides, as :func:`resolve_spec` and
    :func:`shard_batch_spec` make sure)."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] //= _axis_size(sizes, entry)
    return tuple(out)


def constrain_batch(x, mesh, global_batch: Optional[int] = None):
    """Keep an activation's batch (dim 0) sharded over (pod, data).

    The reference pins this with a sharding constraint at block
    boundaries, so that GSPMD gathers the weights per layer (ZeRO-3) and
    leaves the activations batch-sharded.  Here a DTensor activation is
    redistributed to that layout; a plain tensor is this rank's shard, and
    where ``global_batch`` is given its batch dimension must be the
    shard's.  The identity without a mesh."""
    if mesh is None:
        return x
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(shard_batch_spec(mesh, x.shape), mesh))
    if global_batch is not None:
        shape = (global_batch,) + tuple(x.shape[1:])
        want = local_shape(shape, shard_batch_spec(mesh, shape), mesh)[0]
        if x.shape[0] != want:
            raise ValueError(f"activation of batch {x.shape[0]} on a mesh "
                             f"{mesh_axes(mesh)}: this rank's shard of a batch of "
                             f"{global_batch} is {want}")
    return x


def shard_batch(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, DTensor]:
    """Each rank's shard of a global batch that every rank holds whole
    (``TokenPipeline`` makes the same batch on every rank), as DTensors
    laid out by :func:`shard_batch_spec`; no communication."""
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, mesh, placements(shard_batch_spec(mesh, v.shape), mesh),
                                 src_data_rank=None)
            for k, v in batch.items()}


def place_params(model: torch.nn.Module, mesh, rules: Optional[AxisMap] = None,
                 report: Optional[List[str]] = None) -> torch.nn.Module:
    """Each parameter of ``model`` replaced, in place, by a DTensor laid out
    by :func:`param_shardings`, cut from the whole tensor every rank
    holds (drawn from the same seed), with no communication."""
    from torch.distributed.tensor import distribute_tensor
    for name, pl in param_shardings(model, mesh, rules, report).items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        p = mod._parameters[leaf]
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, pl, src_data_rank=None),
            requires_grad=p.requires_grad)
    return model
