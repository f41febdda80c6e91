"""Granite-4.0-H's prefill pool: ``prefill``'s traffic, window, traced deck
and check, with Granite's own weights (``portbench.granite.draw``), work
(``granite.prefill_flops``) and reference (``reference/granite.py``).

The traced part also wraps the program's feed-forward and flash call
sites, ``repro_torch.models.granite_hybrid.moe_ffn`` (one layer's
feed-forward: its norm, the router, the routed experts and the shared
expert) and
``repro_torch.models.attention.flash_attention``, in ``portbench::moe``
and ``portbench::flash`` ranges (as ``trace.sites`` wraps the SSD's), and
hands their calls' shapes to the readers through :meth:`Kind.traced_work`.
A program without them keeps its other readings and leaves those of the
two sites out.

The check's reference holds the weights as drawn (bf16) and takes each
layer's to float32 as it runs, so that it fits once the program is freed.
Stand-ins of the check (``control.py --controls``): ``fp8``, the
reference's products in float8; ``top8``, each token routed to its 8 best
experts; ``no_shared``, the shared expert left out; ``rope``, RoPE on q
and k; ``scale_dh``, the scores scaled by Dh^-1/2.  ``bf16``, the
reference's products on bfloat16 operands, is a witness and no fault: it
reads what rounding alone gives.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import Counter
from typing import Dict, List, Tuple

import torch

from portbench import granite as gw
from portbench import weights
from portbench.harness import TOKEN_STREAM, Run, percentile
from portbench.kinds import prefill
from portbench.reference import granite as gref
from portbench.trace import PREFIX

#: prompt tokens one reference call reads at most
REF_TOKENS = 16384
#: the call sites the traced part wraps: name -> (module, attribute)
SITES = {"flash": ("repro_torch.models.attention", "flash_attention"),
         "moe": ("repro_torch.models.granite_hybrid", "moe_ffn")}


def _meta(site: str, args) -> dict:
    """flash (q, k, v, ...): B, S, H, KV, Dh; moe (ffn, x, cfg): T, D, E, k,
    F, Fs."""
    if site == "flash":
        q, k = args[0], args[1]
        B, S, H, Dh = q.shape
        return {"B": B, "S": S, "H": H, "KV": k.shape[2], "Dh": Dh,
                "dtype": str(q.dtype).replace("torch.", "")}
    x, cfg = args[1], args[2]
    D = x.shape[-1]
    return {"T": x.numel() // D, "D": D, "E": cfg.n_experts, "k": cfg.moe_top_k,
            "F": cfg.d_ff, "Fs": cfg.shared_ff, "dtype": str(x.dtype).replace("torch.", "")}


@contextlib.contextmanager
def sites(calls: Dict[str, List[dict]]):
    """For the duration, each of :data:`SITES` the program has wrapped in
    its ``portbench::<site>`` range, each call's shapes kept in ``calls``."""
    from torch.profiler import record_function

    saved = []
    for site, (mod_name, attr) in SITES.items():
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        fn = getattr(mod, attr, None)
        if fn is None:
            continue

        def wrapper(*args, _site=site, _fn=fn, **kwargs):
            calls.setdefault(_site, []).append(_meta(_site, args))
            with record_function(PREFIX + _site):
                return _fn(*args, **kwargs)

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapper)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def build(ctx: Run):
    """The program's model, built bare and given the seed's weights."""
    from repro_torch.models.lm import build_model

    model = build_model(ctx.port_cfg, device="meta")
    params = gw.draw(ctx.model_cfg, ctx.cell.config["assumed"]["init"], ctx.seed, ctx.device)
    ctx.weights_sum = weights.checksum(params)
    weights.load(model, params)
    return model


def reference_params(ctx: Run) -> Dict[str, torch.Tensor]:
    """The seed's weights drawn again, as drawn (checked against the
    program's draw)."""
    params = gw.draw(ctx.model_cfg, ctx.cell.config["assumed"]["init"], ctx.seed, ctx.device)
    if weights.checksum(params) != ctx.weights_sum:
        raise RuntimeError("a second draw of the seed's weights differs from the first")
    return params


def reference_gaps(ctx: Run, picked: List[Tuple[torch.Tensor, torch.Tensor]],
                   precisions) -> Dict[str, float]:
    """``prefill.reference_gaps`` with Granite's reference and weights."""
    params = reference_params(ctx)
    gref.exact()
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
                best = gref.last_logits(params, ctx.model_cfg, toks)
                gap = prefill.served_gap(best, want).max()
                worst["served"] = max(worst["served"], float(gap))
                for p in precisions:
                    low = gref.last_logits(params, ctx.model_cfg, toks, precision=p)
                    gap = prefill.served_gap(best, low.argmax(-1)).max()
                    worst[p] = max(worst[p], float(gap))
    return worst


class Kind(prefill.Kind):
    def __init__(self, ctx: Run):
        super().__init__(ctx)
        self.site_calls: Dict[str, List[dict]] = {}

    def setup(self) -> None:
        ctx = self.ctx
        self.model = build(ctx)
        gen = ctx.generator(prefill.WARM_STREAM)
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
            work += gw.prefill_flops(ctx.model_cfg, B, L)
            units[L] += 1
            self.records.append((tokens, out))
        vocab = ctx.model_cfg["vocab"]
        failed = sum(int(((o < 0) | (o >= vocab)).any()) for _, out in self.records
                     for o in out)
        return ({"ttft_ms_p95": 1e3 * percentile(ttft, 95)}, len(ttft), failed,
                {"flops": work, "seconds": t_end - t_start, "units": units})

    def traced_part(self) -> None:
        self.site_calls = {}
        with sites(self.site_calls):
            super().traced_part()

    def traced_work(self) -> dict:
        return {**super().traced_work(), **self.site_calls}

    def check(self):
        ctx = self.ctx
        requests = [(tokens[i], out[i]) for tokens, out in self.records
                    for i in range(tokens.shape[0])]
        picked = ctx.sample(requests, ctx.traffic["check_requests"], lambda r: r[0].shape[-1])
        worst = reference_gaps(ctx, [(t, o[0]) for t, o in picked], ctx.controls)
        return ({"served_gap_max": worst["served"]},
                {p: {"served_gap_max": worst[p]} for p in ctx.controls})
