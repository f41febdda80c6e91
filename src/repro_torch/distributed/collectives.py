"""The collectives the port's mesh path is built from, each differentiable
where a gradient crosses it.

The port runs SPMD over ranks, one per mesh coordinate.  A value that
every rank of a group computes alike is *replicated*: its gradient is
the same on every rank of the group, not a part of a sum.  So:

* :func:`split` takes a replicated tensor's block for this rank; its
  backward all-gathers the blocks' gradients, which makes the
  replicated input's gradient whole again on every rank;
* :func:`gather` all-gathers the blocks into a replicated tensor; its
  backward takes this rank's block of the (replicated) gradient and
  multiplies nothing by the group's size;
* :func:`hop` sends a tensor ``shift`` ranks along a ring and receives
  from the other side (a ``ppermute``); its backward is the reverse hop;
* :func:`broadcast` hands rank ``src``'s tensor to the group; its
  backward keeps the gradient on ``src`` only (and reaches the graphs of
  the tensors it is told to keep, with no gradient);
* :func:`gather_param` gathers a DTensor parameter whole before a block
  runs (ZeRO-3).  Its backward sums the gradients over the batch axes,
  where each rank saw its own batch shard, and takes the replicated
  gradient as it is on every other axis; the sum comes back
  reduce-scattered onto the parameter's shards;
* :func:`batch_sum` sums a value without a gradient (counts, a loss to
  report) over the batch axes.

The sharded MoE dispatch (``models.moe.apply_moe_sharded``) moves tokens
whose values differ on every rank, and multiplies a gathered copy by a
different weight shard on each, so its collectives differentiate as
the reference's ``shard_map`` transposes them (``jax.grad`` is the
oracle):

* :func:`all_to_all` sends block i of a (n, ...) tensor to group rank i
  and receives block i from rank i; its backward is the reverse
  ``all_to_all``;
* :func:`all_gather` concatenates the group's blocks, which differ, into
  a copy that each rank multiplies by its own weight shard: its backward
  is a reduce-scatter, every rank's cotangent of a block summed on the
  block's owner (where :func:`gather`'s takes the rank's own block of a
  replicated cotangent);
* :func:`reduce_scatter` (the reference's ``psum_scatter``) sums the
  group's tensors, which differ, and keeps this rank's block of the sum;
  its backward all-gathers the blocks' cotangents;
* :func:`all_reduce` (``psum``) sums partial values that differ, into a
  result each rank uses differently (the partial router logits and
  hidden of the ``2d_dshard`` schedule): its backward is a sum as well;
* :func:`varying` and :func:`replicated` are the identity forward.  They
  mark where the reference's ``shard_map`` meets a tensor that is the
  same on every rank of an axis its spec does not name: the cotangent of
  such an input is summed over the axis (:func:`varying`), and that of
  such an output divided by its size (:func:`replicated`), since every
  rank hands back a copy of the one cotangent.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.sharding.rules import BATCH_AXES


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    n, _ = _size_rank(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all of {tuple(x.shape)} over a group of {n}")
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, _ = _size_rank(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    n, _ = _size_rank(group)
    if n == 1:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, _ = _size_rank(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = _size_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    return x.chunk(n, dim=dim)[r].contiguous()


def _p2p(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n, r = _size_rank(group)
    if shift % n == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    if x.device.type == "meta":         # the dry run: no backend to batch on
        reqs = [dist.isend(x, dst, group), dist.irecv(out, src, group)]
    else:
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                       dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


class _Collective(torch.autograd.Function):
    """``forward(x)``, whose backward is ``backward(g)``: one collective
    (or identity) and its transpose, each a function of the tensor alone."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_fn = backward
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.backward_fn(g), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src, *keep):
        ctx.keep_grad = dist.get_rank(group) == src
        ctx.n_keep = len(keep)
        out = x.detach().clone().contiguous()
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return ((g if ctx.keep_grad else torch.zeros_like(g)), None, None,
                *([None] * ctx.n_keep))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x: (n, ...) over a group of n: block i goes to group rank i, and
    block i of the result came from rank i."""
    return _Collective.apply(x, lambda t: _all_to_all(t, group),
                             lambda g: _all_to_all(g, group))


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank
    order, as a copy each rank multiplies by its own weight shard
    (backward: a reduce-scatter; module docstring)."""
    return _Collective.apply(x, lambda t: _all_gather_cat(t, group, dim),
                             lambda g: _reduce_scatter(g, group, dim))


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the group's ``x``."""
    return _Collective.apply(x, lambda t: _reduce_scatter(t, group, dim),
                             lambda g: _all_gather_cat(g, group, dim))


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ``x`` (backward: a sum as well)."""
    return _Collective.apply(x, lambda t: _sum(t, group), lambda g: _sum(g, group))


def varying(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose cotangent is summed over the group in the backward."""
    return _Collective.apply(x, lambda t: t.view_as(t), lambda g: _sum(g, group))


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose cotangent is divided by the group's size in the
    backward."""
    n = dist.get_world_size(group)
    return _Collective.apply(x, lambda t: t.view_as(t), lambda g: g / n)


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of replicated ``x`` along ``dim``."""
    return _Collective.apply(x, lambda t: _block(t, group, dim),
                             lambda g: _all_gather_cat(g, group, dim))


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank order."""
    return _Collective.apply(x, lambda t: _all_gather_cat(t, group, dim),
                             lambda g: _block(g, group, dim))


def hop(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` further along the group's ring; the
    tensor returned is the one from ``shift`` ranks back."""
    return _Collective.apply(x, lambda t: _p2p(t, group, shift),
                             lambda g: _p2p(g, group, -shift))


def broadcast(x: torch.Tensor, group, src: int, *keep: torch.Tensor) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group.  ``keep``:
    tensors that get no gradient but whose graphs the backward must reach
    on every rank, so that the point-to-point ops behind them run their
    backward on every rank, paired with their peers'."""
    return _Broadcast.apply(x, group, src, *keep)


def local_of(p: DTensor, placements, grad_placements=None) -> torch.Tensor:
    """``p`` redistributed to ``placements``, as this rank's plain tensor,
    whose gradient has ``grad_placements``.  Under inference mode (serving)
    the redistribution runs outside it, on ``p`` detached, with no graph:
    there DTensor detaches a redistributed parameter in place, which some
    PyTorch releases have no sharding rule for (2.11 raises)."""
    if torch.is_inference_mode_enabled():
        with torch.inference_mode(False):
            return p.detach().redistribute(p.device_mesh, placements).to_local()
    return p.redistribute(p.device_mesh, placements).to_local(grad_placements=grad_placements)


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter whole, as a plain tensor (any other tensor as it
    is); see the module docstring for its gradient."""
    if not isinstance(p, DTensor):
        return p
    names = p.device_mesh.mesh_dim_names
    grads = [Partial() if n in BATCH_AXES else Replicate() for n in names]
    return local_of(p, [Replicate()] * len(names), grads)


@torch.no_grad()
def batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's batch axes (pod, data); no gradient."""
    x = x.detach().clone()
    for axis in BATCH_AXES:
        if axis in (mesh.mesh_dim_names or ()) and mesh.size(
                mesh.mesh_dim_names.index(axis)) > 1:
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x
