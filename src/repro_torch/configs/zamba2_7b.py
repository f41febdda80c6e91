"""Zamba2-7B-Instruct — Mamba-2 mixers with two shared attention blocks
(the port's own configuration: the JAX package has no counterpart).

[arXiv:2411.15242; huggingface.co/Zyphra/Zamba2-7B-Instruct, config.json]
81 layers of d_model 3584; each a Mamba-2 mixer of 112 heads of 64, state
64, two B/C groups, conv 4, chunk 256.  Before the mixers of the 13
``hybrid_layer_ids`` a shared block runs, blocks 0 and 1 in turn: RMSNorm
over [hidden, embedding] (7168 wide), 32 heads of 224 with rope over all
224 dimensions and the score scale (224 / 2)^-1/2, RMSNorm, a gated GELU
MLP of 14336 whose gate|up projection adds the application's rank-128
adapter, then the application's own d_model x d_model linear; its output
joins the mixer's input, not the residual.  Every RMSNorm has eps 1e-5;
vocab 32000, the unembedding tied, 4096 positions.  Built by
:class:`repro_torch.models.zamba2.Zamba2Model`.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    mlp="gelu",
    vocab=32000,
    pad_vocab_multiple=1,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=2,
    conv_width=4,
    ssm_chunk=256,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_shared_blocks=2,
    adapter_rank=128,
    attn_width=7168,
    norm_eps=1e-5,
    norm="rmsnorm",
    rope_theta=1e4,
    ssm_mm_dtype="compute",
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
    notes="shared attention: 2 blocks over 13 applications, MLP adapters of rank 128; "
          "serving only (training state does not fit one card)",
))
