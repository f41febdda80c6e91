"""IBM Granite-4.0-H-Small (32B-A9B) — Mamba-2 and NoPE GQA layers, each
followed by 72 routed experts and a shared expert (the port's own
configuration: the JAX package has no counterpart).

[huggingface.co/ibm-granite/granite-4.0-h-small, config.json;
``model_type`` ``granitemoehybrid``]  40 layers of d_model 4096 in the
published ``layer_types``: 36 Mamba-2 mixers (128 heads of 64, state 128,
one B/C group, conv 4 with a bias, chunk 256) and 4 attention layers (5,
15, 25, 35: 32 query and 8 KV heads of 128, no position embedding, the
scores scaled by ``attention_multiplier`` 1/128).  After every mixer a
MoE feed-forward: 72 SwiGLU experts of 768, the top 10 by a softmax over
the ten best router logits, plus a shared SwiGLU expert of 1536.  muP
multipliers: the embedding x 12, both residual branches x 0.22, the
logits / 16.  RMSNorm eps 1e-5, vocab 100352, the unembedding tied,
131072 positions.  Built by
:class:`repro_torch.models.granite_hybrid.GraniteHybridModel`.
"""

from .base import ModelConfig, register

#: the published ``layer_types``: an attention layer at 5, 15, 25 and 35
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))

CONFIG = register(ModelConfig(
    name="granite-4.0-h-small",
    family="granite_hybrid",
    n_layers=40,
    layer_types=LAYER_TYPES,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    shared_ff=1536,
    n_experts=72,
    moe_top_k=10,
    mlp="swiglu",
    vocab=100352,
    pad_vocab_multiple=1,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv_width=4,
    ssm_chunk=256,
    norm="rmsnorm",
    norm_eps=1e-5,
    rope_theta=0.0,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    ssm_mm_dtype="compute",
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small",
    notes="position_embedding_type nope: no rotation (rope_theta 10000 is published but "
          "unused); serving only (training state does not fit one card)",
))
