"""A prefill pool, served closed-loop through ``serve.step.generate``.

Traffic parameters: ``batch`` requests a call; ``deck``, [prompt length,
batches] pairs dealt in turn from a deck shuffled by the seed, so every
window holds the same proportions; ``output_tokens`` (1: the prefill's
argmax); ``check_requests``, the size of the checked sample.

The window serves one rectangular batch after another.  A request's time
to first token runs from the batch's submission to its token on the
host.  The traced part serves one whole deck.  The check runs the
reference over a sample of the window's requests, one of the longest
among them, and reads the widest gap by which a served token's logit lies
below the reference's best.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Tuple

import torch

from portbench import flops
from portbench.harness import WARM_STREAM, TOKEN_STREAM, Run, percentile
from portbench.reference import model as ref
from portbench.trace import PREFIX

#: prompt tokens one reference call reads at most
REF_TOKENS = 32768


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per row, how far the logit of ``tokens`` lies below the best."""
    return ref_logits.max(dim=-1).values - ref_logits.gather(-1, tokens[..., None].long())[..., 0]


def reference_gaps(ctx: Run, picked: List[Tuple[torch.Tensor, torch.Tensor]],
                   precisions) -> Dict[str, float]:
    """The widest gap over the ``picked`` requests (prompt, served token),
    of the served tokens and of the tokens each control precision puts
    first; the prompts of one length go through the reference together,
    ``REF_TOKENS`` at a time."""
    params = ref.as_f32(ctx.reference_params())
    ref.exact()
    worst = {"served": 0.0, **{p: 0.0 for p in precisions}}
    by_len: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
    for prompt, token in picked:
        by_len.setdefault(prompt.shape[-1], []).append((prompt, token))
    with torch.no_grad():
        for L, reqs in sorted(by_len.items()):
            rows = max(REF_TOKENS // L, 1)
            for i in range(0, len(reqs), rows):
                toks = torch.stack([t for t, _ in reqs[i:i + rows]]).to(ctx.device)
                want = torch.stack([o for _, o in reqs[i:i + rows]]).to(ctx.device)
                best = ref.last_logits(params, ctx.model_cfg, toks)
                worst["served"] = max(worst["served"], float(served_gap(best, want).max()))
                for p in precisions:
                    low = ref.last_logits(params, ctx.model_cfg, toks, precision=p)
                    worst[p] = max(worst[p], float(served_gap(best, low.argmax(-1)).max()))
    return worst


class Kind:
    def __init__(self, ctx: Run):
        self.ctx = ctx
        self.model = None
        self.records: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def _serve(self, tokens: torch.Tensor) -> torch.Tensor:
        from repro_torch.serve import step

        out = step.generate(self.model, {"tokens": tokens}, self.ctx.traffic["output_tokens"])
        return out.cpu()

    def setup(self) -> None:
        ctx = self.ctx
        self.model = ctx.build()
        gen = ctx.generator(WARM_STREAM)
        for L in ctx.deck().values():
            self._serve(ctx.ids(gen, ctx.traffic["batch"], L))

    def window(self, seconds: float):
        ctx, B = self.ctx, self.ctx.traffic["batch"]
        deck, gen = ctx.deck(), ctx.generator(TOKEN_STREAM)
        ttft, work, units = [], 0.0, Counter()
        t_start = time.perf_counter()
        t_end = t_start
        while t_end - t_start < seconds or len(self.records) < ctx.min_units:
            L = deck.deal()
            tokens = ctx.ids(gen, B, L)
            t0 = time.perf_counter()
            out = self._serve(tokens)
            t_end = time.perf_counter()
            ttft += [t_end - t0] * B
            work += flops.prefill_flops(ctx.model_cfg, B, L)
            units[L] += 1
            self.records.append((tokens, out))
        vocab = ctx.model_cfg["vocab"]
        failed = sum(int(((o < 0) | (o >= vocab)).any()) for _, out in self.records
                     for o in out)
        return ({"ttft_ms_p95": 1e3 * percentile(ttft, 95)}, len(ttft), failed,
                {"flops": work, "seconds": t_end - t_start, "units": units})

    def traced_part(self) -> None:
        """One whole deck, dealt anew, each batch in a span of its own."""
        from torch.profiler import record_function

        ctx = self.ctx
        deck, gen = ctx.deck(), ctx.generator(WARM_STREAM)
        self.traced_keys = []
        for _ in range(len(deck.cards)):
            L = deck.deal()
            with record_function(PREFIX + "unit"):
                self._serve(ctx.ids(gen, ctx.traffic["batch"], L))
            self.traced_keys.append(L)

    def traced_work(self) -> dict:
        return {"unit_site": "unit", "unit_keys": self.traced_keys}

    def free(self) -> None:
        self.model = None

    def check(self):
        ctx = self.ctx
        requests = [(tokens[i], out[i]) for tokens, out in self.records
                    for i in range(tokens.shape[0])]
        picked = ctx.sample(requests, ctx.traffic["check_requests"], lambda r: r[0].shape[-1])
        worst = reference_gaps(ctx, [(t, o[0]) for t, o in picked], ctx.controls)
        return ({"served_gap_max": worst["served"]},
                {p: {"served_gap_max": worst[p]} for p in ctx.controls})
