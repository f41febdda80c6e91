"""Train-step factory: loss -> grad -> (optional compression) -> AdamW
(mirrors ``src/repro/train/step.py``).

``make_train_step(model, opt_cfg, accum_steps, compress_pod_grads,
mesh)`` returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.
The parameters live in the model and are updated in place, where the
reference's pure function takes and returns them.

* ``accum_steps`` splits the batch along dim 0 into that many
  micro-batches, sums their gradients in float32, divides by
  ``accum_steps`` and averages the loss; the other metrics are the last
  micro-batch's, as in the reference's ``lax.scan``.
* ``compress_pod_grads`` with a ``mesh`` that has a ``pod`` axis runs
  ``distributed.pod_compressed_mean`` on the gradients (int8 on the wire
  across pods), as the reference does.

On a model with a mesh (``models.lm``) the batch is the global batch as
DTensors (``sharding.shard_batch``); each rank's loss is its share, the
gradients come back summed over the batch shards and are laid out as
their parameters (a gradient still partial over an axis where its
parameter is replicated is reduced there), and the loss and the other
metrics reported are the global ones.

Weight decay falls where the reference's falls: on every leaf of its
layout with two or more dimensions (``interop.reference_ndims``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.collectives import batch_sum
from repro_torch.interop import reference_ndims
from repro_torch.sharding.rules import mesh_axes, shard_batch
from repro_torch.tracing import unit
from .optim import OptConfig, OptState, adamw_update


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _micro_batches(batch, accum_steps: int, mesh):
    """The batch split along dim 0 into ``accum_steps`` micro-batches; on a
    mesh each is the global micro-batch, sharded again."""
    if mesh is not None:
        full = {k: v.full_tensor() for k, v in batch.items()}
        micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
                 for k, v in full.items()}
        return [shard_batch({k: v[i] for k, v in micro.items()}, mesh)
                for i in range(accum_steps)]
    micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
             for k, v in batch.items()}
    return [{k: v[i] for k, v in micro.items()} for i in range(accum_steps)]


def make_train_step(model, opt_cfg: OptConfig, accum_steps: int = 1,
                    compress_pod_grads: bool = False, mesh=None) -> Callable:
    params = dict(model.named_parameters())
    ndims = reference_ndims(model.cfg, params)        # the reference's decay mask
    model_mesh = getattr(model, "mesh", None)
    compress = (compress_pod_grads and mesh is not None and "pod" in mesh_axes(mesh))

    def grads_of(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        if model_mesh is not None:
            loss = batch_sum(loss, model_mesh)
            metrics = {k: batch_sum(v, model_mesh) for k, v in metrics.items()}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                {k: _placed_like(g, params[k]) for k, g in zip(params, grads)})

    def compute_grads(batch):
        if accum_steps == 1:
            return grads_of(batch)
        loss_sum = 0.0
        total = {k: torch.zeros_like(p, dtype=torch.float32).detach()
                 for k, p in params.items()}
        for micro in _micro_batches(batch, accum_steps, model_mesh):
            loss, metrics, grads = grads_of(micro)
            loss_sum = loss_sum + loss
            for k, g in grads.items():
                total[k] += g
            del grads
        return (loss_sum / accum_steps, metrics,
                {k: g / accum_steps for k, g in total.items()})

    def train_step(opt_state: OptState, batch) -> Tuple[OptState, Dict]:
        B, L = batch["tokens"].shape
        with unit("train.step", B=B, L=L):
            loss, metrics, grads = compute_grads(batch)
            if compress:
                from repro_torch.distributed.compression import pod_compressed_mean
                grads = pod_compressed_mean(grads, mesh)
            _, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state, params, ndims)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
