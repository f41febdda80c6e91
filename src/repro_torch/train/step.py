"""Train-step factory: loss -> grad -> AdamW (mirrors
``src/repro/train/step.py``).

``make_train_step(model, opt_cfg, accum_steps)`` returns
``train_step(opt_state, batch) -> (opt_state, metrics)``.  The
parameters live in the model and are updated in place, where the
reference's pure function takes and returns them.

* ``accum_steps`` splits the batch along dim 0 into that many
  micro-batches, sums their gradients in float32, divides by
  ``accum_steps`` and averages the loss; the other metrics are the last
  micro-batch's, as in the reference's ``lax.scan``.
* ``compress_pod_grads`` (int8 gradient compression across pods) waits
  for the distributed part of the port and raises.

Weight decay falls where the reference's falls: on every leaf of its
layout with two or more dimensions (``interop.reference_ndims``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.interop import reference_ndims
from .optim import OptConfig, OptState, adamw_update


def make_train_step(model, opt_cfg: OptConfig, accum_steps: int = 1,
                    compress_pod_grads: bool = False) -> Callable:
    if compress_pod_grads:
        raise NotImplementedError("gradient compression across pods waits for "
                                  "the distributed part of the port")
    params = dict(model.named_parameters())
    ndims = reference_ndims(model.cfg, params)        # the reference's decay mask

    def grads_of(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def compute_grads(batch):
        if accum_steps == 1:
            return grads_of(batch)
        micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
                 for k, v in batch.items()}
        loss_sum = 0.0
        total = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        for i in range(accum_steps):
            loss, metrics, grads = grads_of({k: v[i] for k, v in micro.items()})
            loss_sum = loss_sum + loss
            for k, g in grads.items():
                total[k] += g
            del grads
        return (loss_sum / accum_steps, metrics,
                {k: g / accum_steps for k, g in total.items()})

    def train_step(opt_state: OptState, batch) -> Tuple[OptState, Dict]:
        loss, metrics, grads = compute_grads(batch)
        _, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state, params, ndims)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
