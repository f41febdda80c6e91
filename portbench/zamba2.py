"""Zamba2's parameters drawn from a seed, its work, and the bounds of its
flash-attention and grouped-SSD calls.

The parameter set (names, shapes, the dtypes they are served in) is
worked out from the configuration file's widths under the program's
parameter names, as ``weights.shapes`` does for Mamba-2; each leaf's
initialisation is the configuration's ``assumed.init`` rule for its leaf
name, drawn in a few large calls on one generator on the device.

The work counts the architecture, not what the program executes: 2 x the
matmul parameters a token uses, the unembedding once per logit row, the
causal attention's products (2 B H S^2 Dh, counting the kept pairs
S (S + 1) / 2 exactly) and the SSD's products with its G groups of B and
C.  A bound is ``rooflines.bound_s``: each input byte read once, each
output byte written once.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from . import rooflines, weights

Shape = Tuple[int, ...]


def attn_head_dim(cfg: Mapping) -> int:
    return cfg["attn_width"] // cfg["n_heads"]


def _mixer_dims(cfg: Mapping):
    """(d_inner, heads, head dim, state, groups) of a Mamba-2 mixer."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    P = cfg["ssm_head_dim"]
    return di, di // P, P, cfg["ssm_state"], cfg["ssm_groups"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def shapes(cfg: Mapping) -> Dict[str, Shape]:
    """Every parameter's shape, by the program's parameter names."""
    if cfg["family"] != "zamba2":
        raise ValueError(f"no zamba2 parameter set for family {cfg['family']!r}")
    d, A, F, r = cfg["d_model"], cfg["attn_width"], cfg["d_ff"], cfg["adapter_rank"]
    di, H, P, N, G = _mixer_dims(cfg)
    conv = di + 2 * G * N
    out: Dict[str, Shape] = {"embed.table": (weights.padded_vocab(cfg), d)}
    for i in range(cfg["n_layers"]):
        b = f"blocks.{i}."
        out.update({b + "ln.scale": (d,),
                    b + "mamba.w_in": (d, 2 * di + 2 * G * N + H),
                    b + "mamba.conv_w": (cfg["conv_width"], conv),
                    b + "mamba.conv_b": (conv,),
                    b + "mamba.a_log": (H,), b + "mamba.dt_bias": (H,),
                    b + "mamba.d_skip": (H,),
                    b + "mamba.norm_scale": (di,),
                    b + "mamba.w_out": (di, d)})
    out["ln_f.scale"] = (d,)
    for k in range(cfg["n_shared_blocks"]):
        s = f"shared.{k}."
        out.update({s + "ln_in": (2 * d,), s + "w_qkv": (2 * d, 3 * A), s + "w_o": (A, d),
                    s + "ln_ff": (d,), s + "w_gate_up": (d, 2 * F), s + "w_down": (F, d)})
    for j in range(len(cfg["hybrid_layer_ids"])):
        a = f"apps.{j}."
        out.update({a + "adapter_a": (d, r), a + "adapter_b": (r, 2 * F), a + "linear": (d, d)})
    return out


def _fixed(rule, shape: Shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A leaf its rule sets without drawing."""
    if rule[0] == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if rule[0] == "log_arange":           # A_log = log(1 .. H)
        return torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                      device=device)).to(dtype)
    raise ValueError(f"unknown init rule {rule!r}")


def draw(cfg: Mapping, init: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``cfg`` drawn from ``seed`` on ``device``.  Rules:
    ``normal`` (N(0, std), with an optional row set to zero: the
    embedding's padding row), ``uniform`` (U(-bound, bound)), ``dt_bias``
    (``weights``'), and the fixed ``ones`` and ``log_arange``."""
    gen = torch.Generator(device=device).manual_seed((seed ^ weights.WEIGHT_STREAM) % 2**63)
    leaves = shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[Tuple[str, torch.dtype], list] = {}
    for name, shape in leaves.items():
        rule = init[name.rsplit(".", 1)[-1]]
        dtype = weights.dtype_of(name, cfg)
        if rule[0] in ("normal", "uniform", "dt_bias"):
            groups.setdefault((rule[0], dtype), []).append(name)
        else:
            out[name] = _fixed(rule, shape, dtype, device)
    for (kind, dtype), names in sorted(groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        sizes = [math.prod(leaves[n]) for n in names]
        sample = torch.randn if kind == "normal" else torch.rand
        flat = sample(sum(sizes), generator=gen, device=device, dtype=dtype)
        for name, part in zip(names, torch.split(flat, sizes)):
            rule = init[name.rsplit(".", 1)[-1]]
            leaf = weights._finish(rule[:2] if kind == "normal" else rule,
                                   part.view(leaves[name]), leaves[name], cfg)
            if kind == "normal" and len(rule) > 2:
                leaf[rule[2]] = 0
            out[name] = leaf.to(dtype)
    return {name: out[name] for name in leaves}


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------

def mixer_params(cfg: Mapping) -> int:
    """Matmul parameters of one mixer: in- and out-projection."""
    d = cfg["d_model"]
    di, H, _, N, G = _mixer_dims(cfg)
    return d * (2 * di + 2 * G * N + H) + di * d


def application_params(cfg: Mapping) -> int:
    """Matmul parameters of one application of a shared block: q|k|v, o,
    gate|up, down, the adapter and the application's linear."""
    d, A, F, r = cfg["d_model"], cfg["attn_width"], cfg["d_ff"], cfg["adapter_rank"]
    return 2 * d * 3 * A + A * d + d * 2 * F + F * d + d * r + r * 2 * F + d * d


def body_params(cfg: Mapping) -> int:
    """Matmul parameters a token uses, the unembedding aside."""
    return (cfg["n_layers"] * mixer_params(cfg)
            + len(cfg["hybrid_layer_ids"]) * application_params(cfg))


def attention_flops(B: int, S: int, H: int, Dh: int) -> float:
    """Causal q k^T and p v: 2 x 2 Dh a kept pair, S (S + 1) / 2 pairs a
    row and head."""
    return 2.0 * B * H * Dh * S * (S + 1)


def ssd_flops(B: int, L: int, H: int, P: int, N: int, G: int, chunk: int) -> float:
    """The chunked dual form's products: C B^T within a chunk once per
    group, the masked product with x, the chunk states and their term."""
    per_chunk = 2.0 * chunk * chunk * N * G + H * (2.0 * chunk * chunk * P + 4.0 * chunk * N * P)
    return B * (L // chunk) * per_chunk


def prefill_flops(cfg: Mapping, B: int, S: int) -> float:
    """A prefill of B prompts of S tokens, to the last position's logits."""
    _, H, P, N, G = _mixer_dims(cfg)
    n_apps = len(cfg["hybrid_layer_ids"])
    return (2.0 * B * S * body_params(cfg) + 2.0 * B * cfg["d_model"] * cfg["vocab"]
            + cfg["n_layers"] * ssd_flops(B, S, H, P, N, G, min(cfg["ssm_chunk"], S))
            + n_apps * attention_flops(B, S, cfg["n_heads"], attn_head_dim(cfg)))


# ---------------------------------------------------------------------------
# bounds of the kernels' calls (shapes from the benchmark's call sites)
# ---------------------------------------------------------------------------

def flash_bound_s(m: Mapping) -> float:
    """A causal flash call (B, S, H, Dh): q, k, v and o each moved once."""
    nbytes = 4 * rooflines.ITEMSIZE[m["dtype"]] * m["B"] * m["S"] * m["H"] * m["Dh"]
    return rooflines.bound_s(nbytes, attention_flops(m["B"], m["S"], m["H"], m["Dh"]),
                             m["dtype"])


def ssd_bytes(B: int, L: int, H: int, P: int, N: int, G: int, dtype: str) -> float:
    """x, dt, A and the G groups of B and C read; y and the final state
    written."""
    it = rooflines.ITEMSIZE[dtype]
    return (2 * it * B * L * H * P + 4 * B * L * H + 4 * H + 2 * it * B * L * G * N
            + 4 * B * H * N * P)


def ssd_bound_s(m: Mapping, G: int) -> float:
    """An SSD call with the shapes its call site saw and G groups."""
    B, L, H, P, N, Q = m["B"], m["L"], m["H"], m["P"], m["N"], m["chunk"]
    return rooflines.bound_s(ssd_bytes(B, L, H, P, N, G, m["dtype"]),
                             ssd_flops(B, L, H, P, N, G, Q), m["dtype"])
