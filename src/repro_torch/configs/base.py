"""Model/config registry (mirrors ``src/repro/configs/base.py``).

Each architecture file registers one :class:`ModelConfig` with the exact
published hyperparameters; ``reduced()`` derives the small same-family
config used by CPU tests; ``SHAPES`` are the reference's dry-run input
shapes, which ``models.accounting.model_flops`` and ``launch.dryrun``
take, and ``cell_applicable`` says which (arch, shape) cells run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | ssm | hybrid | zamba2 |
                                   # granite_hybrid | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    norm: str = "rmsnorm"          # rmsnorm | layernorm | nonparametric
    mlp: str = "swiglu"            # swiglu | gelu
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 6            # hybrid: shared attn block per N ssm blocks
    ssm_groups: int = 1            # B/C groups of the Mamba-2 mixers
    # --- zamba2: Zyphra's shared blocks ---
    hybrid_layer_ids: Tuple[int, ...] = ()  # layers whose mixer a shared block precedes
    n_shared_blocks: int = 0       # shared blocks, applied in turn
    adapter_rank: int = 0          # rank of each application's MLP adapter
    attn_width: int = 0            # the shared attention's width (its input is
                                   # [hidden, embedding], 2 x d_model wide)
    norm_eps: float = 1e-6         # every RMSNorm's epsilon
    # --- granite_hybrid: IBM's Granite-4.0-H layers ---
    layer_types: Tuple[str, ...] = ()  # each layer's mixer: "mamba" | "attention"
    shared_ff: int = 0             # the shared expert's width (0: none)
    embedding_multiplier: float = 1.0  # the embedding's output is scaled by it
    residual_multiplier: float = 1.0   # every residual branch is scaled by it
    logits_scaling: float = 1.0    # the logits are divided by it
    attention_multiplier: float = 0.0  # the attention scores' scale; 0: Dh^-1/2
    # --- VLM ---
    cross_every: int = 0           # a cross-attn layer every N layers
    n_media_tokens: int = 1600     # stub vision tokens (frontend is a stub)
    # --- audio enc-dec ---
    n_encoder_layers: int = 0
    n_frames: int = 1024           # stub speech-frame embeddings
    # --- compute policy ---
    dtype: str = "bfloat16"        # params/activations
    attn_impl: str = "blockwise"
    q_block: int = 512
    kv_block: int = 1024
    moe_impl: str = "sharded"      # sharded | dense (smoke/reference)
    moe_schedule: str = "2d"       # 2d | ep_tp | auto
    ssm_mm_dtype: str = "float32"  # the reference's SSD matmul dtype; the
                                   # port's SSD multiplies in float32 always
    norm_impl: str = "lean"        # lean | f32 stats
    pad_vocab_multiple: int = 128  # pad embedding rows to a lane multiple
    remat: str = "block"           # none | block  (activation checkpointing)
    scan_layers: bool = True
    source: str = ""
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        m = max(self.pad_vocab_multiple, 1)
        return -(-self.vocab // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """True when 500k-token decode is feasible (SSM/hybrid state)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _c  # noqa: F401  (registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    from repro_torch import configs as _c  # noqa: F401
    return dict(_REGISTRY)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        vocab=256,
        dtype="float32",
        ssm_chunk=16,
        q_block=16,
        kv_block=16,
        n_media_tokens=8,
        n_frames=8,
        moe_impl="dense",
        remat="none",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
                  d_ff=128)
    if cfg.n_experts:
        kw.update(n_experts=4, moe_top_k=min(2, cfg.moe_top_k))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, attn_every=2)
    if cfg.cross_every:
        kw.update(cross_every=2, n_layers=4)
    if cfg.hybrid_layer_ids:
        kw.update(n_layers=6, hybrid_layer_ids=(1, 2, 4, 5), adapter_rank=8, attn_width=128,
                  ssm_groups=min(cfg.ssm_groups, 2))
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2)
    if cfg.layer_types:                # both kinds of mixer, each with its MoE
        kw.update(n_layers=3, layer_types=("mamba", "attention", "mamba"), shared_ff=96,
                  n_experts=6, moe_top_k=3)
    return cfg.replace(**kw)


# --------------------------------------------------------------------------
# input shapes of the reference's dry-run cells (4 shapes x 10 archs)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell, and why not if not
    (reference ``src/repro/configs/base.py:155-160``)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 512k dense-attention decode "
                       "is out of scope per assignment (sub-quadratic only)")
    return True, ""
