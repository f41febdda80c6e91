"""The model's work from the configuration's own widths, for ``mfu``.

Counted from the architecture, not from what the program executes: 2 x
the matmul parameters a token uses, plus the SSD's products, in a
forward; 3 x the forward's work in a training step (the forward and the
two products of each backward), nothing for a recompute.  The
unembedding counts once per logit row the entry produces: the last
position of a prefill, every trained position.
"""

from __future__ import annotations

from typing import Mapping

from . import rooflines


def mamba_params(cfg: Mapping) -> int:
    """Matmul parameters of one Mamba-2 block: in- and out-projection."""
    d, N, P = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * d
    return d * (2 * di + 2 * N + di // P) + di * d


def body_params(cfg: Mapping) -> int:
    """Matmul parameters a token uses, the unembedding aside."""
    return cfg["n_layers"] * mamba_params(cfg)


def unembed_params(cfg: Mapping) -> int:
    return cfg["d_model"] * cfg["vocab"]


def _ssd_heads(cfg: Mapping):
    d, P = cfg["d_model"], cfg["ssm_head_dim"]
    return cfg["ssm_expand"] * d // P, P, cfg["ssm_state"]


def _ssd_flops(cfg: Mapping, B: int, S: int) -> float:
    H, P, N = _ssd_heads(cfg)
    return cfg["n_layers"] * rooflines.ssd_flops(B, S, H, P, N, min(cfg["ssm_chunk"], S))


def prefill_flops(cfg: Mapping, B: int, S: int) -> float:
    """A prefill of B prompts of S tokens, to the last position's logits."""
    return 2.0 * B * S * body_params(cfg) + 2.0 * B * unembed_params(cfg) + _ssd_flops(cfg, B, S)


def train_flops(cfg: Mapping, B: int, S: int) -> float:
    """One training step of B rows of S tokens with the loss at every
    position: 6 x the parameters a token uses, the unembedding included,
    and 3 x the SSD's products."""
    return 6.0 * B * S * (body_params(cfg) + unembed_params(cfg)) + 3.0 * _ssd_flops(cfg, B, S)
