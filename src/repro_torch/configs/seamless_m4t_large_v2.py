"""SeamlessM4T-large-v2 — encoder-decoder, multimodal (audio) (mirrors
``src/repro/configs/seamless_m4t_large_v2.py``).

[arXiv:2308.11596; hf]  24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206.

Enc-dec interpretation of the assigned "24L": 24 encoder layers
(speech/w2v-BERT side, bidirectional self-attention over precomputed
frame embeddings — the modality frontend is a STUB per assignment) and
24 decoder layers (causal self-attention + cross-attention to the
encoder output).  ``input_specs()`` provides the frame embeddings
(B, n_frames, d_model) directly.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,               # decoder layers
    n_encoder_layers=24,       # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    n_frames=1024,
    norm="layernorm",
    mlp="swiglu",
    rope_theta=1e4,
    source="arXiv:2308.11596",
    notes="audio frontend stubbed (precomputed frame embeddings); "
          "decode steps run the decoder with a fixed encoder memory",
))
