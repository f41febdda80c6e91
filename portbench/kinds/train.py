"""Pre-training steps through ``train.step.make_train_step``.

Traffic parameters: ``batch`` rows of ``seq`` tokens a step, fresh ids
from the seed each step; ``opt``, the ``OptConfig`` fields that differ
from its defaults; ``checked_steps``, the first steps the reference
follows; ``trace_steps``, the steps the traced part holds.

Set-up builds one training step with its model and optimizer state and
drives it through the first ``checked_steps`` steps, on rows that all
differ, through the same call and feed as the window; they warm every
shape too.  It keeps each step's loss, each gradient's norm as AdamW got
it in step 1 (from the first moment: mu / (1 - b1)) and, before step 4
moves them, each parameter's change since the draw.  The window then
steps the same object on; the training rate is all the window's tokens
over its time, the last step ending in a synchronise.

The check runs the reference (float32, the same draws and batches, the
program's AdamW restated) through the same steps and reads, by the worst
leaf, the gap between the program's norms and the reference's against
the reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change
(the line's ``notes`` name them).  The float32 leaves, which every step
moves on both sides, are also compared element by element, so an update
in the wrong direction shows: the norm of the program's change less the
reference's over the reference's, for the median leaf.  Not for the
worst: AdamW's first steps move an element by about lr whatever its
gradient, so an element whose gradient is under a hundredth of its
leaf's moves either way by rounding, and one such element sets the worst
leaf's reading.
"""

from __future__ import annotations

import re
import statistics
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from portbench import flops
from portbench.harness import TOKEN_STREAM, WARM_STREAM, Run
from portbench.reference import adamw as ref_adamw
from portbench.reference import model as ref

#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the change
NOUGHT = 1e-3


@dataclass
class Trajectory:
    losses: List[float] = field(default_factory=list)
    grads: Dict[str, float] = field(default_factory=dict)     # step 1, clipped
    change: Dict[str, float] = field(default_factory=dict)    # after the checked steps
    moved: Dict[str, torch.Tensor] = field(default_factory=dict)   # float32 leaves' change


def kept(base: Trajectory) -> List[str]:
    """The leaves the change is compared over (the NOUGHT rule)."""
    gmed = statistics.median(base.grads.values())
    return [k for k, g in base.grads.items() if g >= NOUGHT * gmed]


def left_out(base: Trajectory) -> Dict[str, int]:
    """The leaves the NOUGHT rule leaves out, counted by name across the
    blocks."""
    out = set(kept(base))
    return dict(sorted(Counter(re.sub(r"\.\d+\.", ".*.", k)
                               for k in base.grads if k not in out).items()))


def gaps(side: Trajectory, base: Trajectory) -> Dict[str, float]:
    """The compared numbers of ``side`` against ``base`` (the reference)."""
    norm = lambda t: float(torch.linalg.vector_norm(t))       # noqa: E731
    loss = max(abs(a - b) / abs(b) for a, b in zip(side.losses, base.losses))
    gmed = statistics.median(base.grads.values())
    grad = max(abs(side.grads[k] - g) / max(g, gmed) for k, g in base.grads.items())
    keys = kept(base)
    cmed = statistics.median(base.change[k] for k in keys)
    change = max(abs(side.change[k] - base.change[k]) / max(base.change[k], cmed, 1e-30)
                 for k in keys)
    diff = statistics.median(norm(side.moved[k] - base.moved[k]) / max(norm(base.moved[k]), 1e-30)
                             for k in keys if k in base.moved)
    return {"loss_gap": loss, "grad_norm_gap": grad, "change_gap": change,
            "change_diff_f32_median": diff}


def float32_changes(now: Dict[str, torch.Tensor],
                    drawn: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each float32 leaf's change since the draw, on the host."""
    return {k: (v.detach().float() - drawn[k].float()).cpu() for k, v in now.items()
            if drawn[k].dtype == torch.float32}


class Kind:
    #: the SSD's backward marks are read in a pass without the profiler
    marked = True

    def __init__(self, ctx: Run):
        self.ctx = ctx
        self.model = None
        self.program = Trajectory()
        self.first: List[Dict[str, torch.Tensor]] = []

    def _batch(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        t = self.ctx.traffic
        ids = self.ctx.ids(gen, t["batch"], t["seq"] + 1)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def setup(self) -> None:
        from repro_torch.train.optim import OptConfig, init_opt_state
        from repro_torch.train.step import make_train_step

        ctx = self.ctx
        self.model = ctx.build()
        self.opt_cfg = OptConfig(**ctx.traffic.get("opt", {}))
        params = dict(self.model.named_parameters())
        self.state = init_opt_state(params)
        self.step = make_train_step(self.model, self.opt_cfg)
        self.gen = ctx.generator(TOKEN_STREAM)
        self.first = [self._batch(self.gen) for _ in range(ctx.traffic["checked_steps"])]
        for i, batch in enumerate(self.first):
            self.state, metrics = self.step(self.state, batch)
            self.program.losses.append(float(metrics["loss"]))
            if i == 0:
                self.program.grads = {k: float(torch.linalg.vector_norm(m)) / (1 - self.opt_cfg.b1)
                                      for k, m in self.state.mu.items()}
        drawn = ctx.reference_params()
        with torch.no_grad():
            self.program.change = {k: float(torch.linalg.vector_norm(p.float() - drawn[k].float()))
                                   for k, p in params.items()}
            self.program.moved = float32_changes(params, drawn)
        del drawn

    def window(self, seconds: float):
        ctx, t = self.ctx, self.ctx.traffic
        losses = []
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds or len(losses) < ctx.min_units:
            self.state, metrics = self.step(self.state, self._batch(self.gen))
            losses.append(metrics["loss"])
        ctx.sync()
        wall = time.perf_counter() - t_start
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        steps = len(losses)
        return ({"train_tok_s": steps * t["batch"] * t["seq"] / wall}, steps, failed,
                {"flops": steps * flops.train_flops(ctx.model_cfg, t["batch"], t["seq"]),
                 "seconds": wall, "units": {"step": steps}})

    def traced_part(self) -> None:
        gen = self.ctx.generator(WARM_STREAM)
        for _ in range(self.ctx.traffic["trace_steps"]):
            self.state, _ = self.step(self.state, self._batch(gen))

    def traced_work(self) -> dict:
        """The backward runs on autograd's own thread, outside any range
        opened around a step: the trace holds the steps alone."""
        n = self.ctx.traffic["trace_steps"]
        return {"train_steps": n, "unit_site": None, "unit_keys": ["step"] * n}

    def free(self) -> None:
        self.model = self.state = self.step = None

    def _reference(self, drawn: Dict[str, torch.Tensor], precision: str,
                   rows: int) -> Trajectory:
        """The reference through the checked steps on the first ``rows``
        rows of each batch."""
        out = Trajectory()
        p = {k: v.float().clone().requires_grad_(True) for k, v in drawn.items()}
        opt = ref_adamw.AdamW(p, ref.dtypes_of(drawn),
                              {**ref_adamw.DEFAULTS, **self.ctx.traffic.get("opt", {})})
        for i, batch in enumerate(self.first):
            loss = ref.loss(p, self.ctx.model_cfg, batch["tokens"][:rows],
                            batch["labels"][:rows], precision)
            grads = torch.autograd.grad(loss, list(p.values()))
            norms = opt.step(p, dict(zip(p, grads)))
            del grads
            out.losses.append(float(loss.detach()))
            if i == 0:
                out.grads = norms
        with torch.no_grad():
            out.change = {k: float(torch.linalg.vector_norm(v - drawn[k].float()))
                          for k, v in p.items()}
            out.moved = float32_changes(p, drawn)
        return out

    def check(self):
        ctx = self.ctx
        ref.exact()
        drawn = ctx.reference_params()
        rows = ctx.traffic["batch"]
        base = self._reference(drawn, "f32", rows)
        stand_ins = {"fp8": ("fp8", rows), "half_batch": ("f32", rows // 2)}
        controls = {c: gaps(self._reference(drawn, *stand_ins[c]), base) for c in ctx.controls}
        self.notes = {"change_gap_leaves_out": left_out(base)}
        return gaps(self.program, base), controls
