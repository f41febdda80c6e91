"""OLMo-1B — non-parametric LayerNorm (mirrors
``src/repro/configs/olmo_1b.py``).  [arXiv:2402.00838; hf]

16L d_model=2048 16H (kv=16, i.e. MHA) d_ff=8192 vocab=50304.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparametric",      # OLMo: LN without affine params
    mlp="swiglu",
    rope_theta=1e4,
    tie_embeddings=True,
    source="arXiv:2402.00838",
))
