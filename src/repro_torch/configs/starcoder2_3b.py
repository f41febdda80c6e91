"""StarCoder2-3B — GQA kv=2, RoPE, GELU FFN (mirrors
``src/repro/configs/starcoder2_3b.py``).  [arXiv:2402.19173; hf]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    norm="layernorm",
    mlp="gelu",
    rope_theta=1e5,
    attn_impl="ring",   # the reference's sequence-parallel attention over a
                        # tensor axis that 24 heads / kv 2 cannot shard; on one
                        # card it computes what every other impl computes
                        # (models/attention.py::self_attention)
    source="arXiv:2402.19173",
))
