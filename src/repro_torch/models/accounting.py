"""Parameter and MODEL_FLOPS accounting (mirrors
``src/repro/models/accounting.py:40-109``).

MODEL_FLOPS is the *useful* work: 6·N_eff·D for training (fwd 2 + bwd 4),
2·N_eff·D for inference forward passes, where N_eff counts parameters
actually touched per token:

* dense:   all params (embedding gather excluded, unembed included once)
* MoE:     non-expert params + top_k / n_experts of expert params
* hybrid:  mamba params + (#applications) x shared-block params
* audio:   encoder params x frame tokens + decoder params x text tokens

plus the attention quadratic term 4·S_kv·d_model per token per attn
layer (score + PV), averaged over the causal triangle for training.

The counts come from the port's own model built on the ``meta`` device:
every parameter with its shape and dtype, no weight drawn and no memory
held, so a trillion-parameter config counts in a moment.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec
from .lm import build_model

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def param_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Exact parameter counts: ``total``, ``active`` per token and, for a
    MoE config, ``expert``."""
    params = dict(build_model(cfg, device="meta").named_parameters())
    total = sum(p.numel() for p in params.values())
    out = {"total": total}
    if cfg.family == "moe":
        expert = sum(p.numel() for k, p in params.items()
                     if k.split(".")[-2:-1] == ["moe"] and k.split(".")[-1] in _EXPERT_LEAVES)
        out["expert"] = expert
        out["active"] = total - expert + (expert * cfg.moe_top_k
                                          // max(cfg.n_experts, 1))
    elif cfg.family == "hybrid":
        shared = sum(p.numel() for k, p in params.items() if k.startswith("shared_attn."))
        n_apps = cfg.n_layers // cfg.attn_every
        out["active"] = total + (n_apps - 1) * shared
    else:
        out["active"] = total
    return out


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """MODEL_FLOPS (global, whole step) for the (arch, shape) cell."""
    counts = param_counts(cfg)
    n_eff = counts["active"]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        mult = 6.0
        s_ctx = S / 2            # causal average context
    elif shape.kind == "prefill":
        tokens = B * S
        mult = 2.0
        s_ctx = S / 2
    else:                        # decode: one token per sequence
        tokens = B
        mult = 2.0
        s_ctx = S                # full KV cache attended
    core = mult * n_eff * tokens
    # attention quadratic term: 4 * s_ctx * d_model per token per layer
    attn_layers = 0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        attn_layers = cfg.n_layers
    elif cfg.family == "hybrid":
        attn_layers = cfg.n_layers // cfg.attn_every
    attn = mult / 2.0 * 4.0 * s_ctx * cfg.d_model * tokens * attn_layers
    if cfg.family == "audio":
        # encoder runs over frame tokens (self-attn, bidirectional)
        enc_params = n_eff * cfg.n_encoder_layers / max(
            cfg.n_encoder_layers + cfg.n_layers, 1)
        frames = B * cfg.n_frames if shape.kind != "decode" else 0
        core += mult * enc_params * frames
    return {"model_flops": core + attn, "core": core, "attention": attn,
            "n_params": counts["total"], "n_active": n_eff}
