"""Granite-4.0-H's parameters drawn from a seed, its work, and the bounds of
its feed-forward and flash-attention calls.

The parameter set (names, shapes, the dtypes they are served in) is
worked out from the configuration file's widths under the program's
parameter names, as ``zamba2.shapes`` does for Zamba2; each leaf's
initialisation is the configuration's ``assumed.init`` rule for its name's
last two parts (``attn.wq``, ``moe.w_gate``) where one is given, else for
its leaf name, drawn in a few large calls on one generator on the device.

The work counts the architecture, not what the program executes: 2 x the
matmul parameters a token uses (the router, the k chosen experts and the
shared expert in every layer), the unembedding once per logit row, the
causal attention's products and the SSD's.  A bound is
``rooflines.bound_s``: each input byte read once, each output byte
written once.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from . import rooflines, weights
from . import zamba2 as zw

Shape = Tuple[int, ...]
#: leaves the program keeps in float32 whatever the configuration's dtype
FLOAT32_LEAVES = weights.FLOAT32_LEAVES + ("router",)


def kinds(cfg: Mapping):
    """The published ``layer_types`` of the configuration's layers."""
    return list(cfg["layer_types"][:cfg["n_layers"]])


def _mixer_dims(cfg: Mapping):
    """(d_inner, heads, head dim, state, groups) of a Mamba-2 mixer."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    P = cfg["ssm_head_dim"]
    return di, di // P, P, cfg["ssm_state"], cfg["ssm_groups"]


def head_dim(cfg: Mapping) -> int:
    return cfg["d_model"] // cfg["n_heads"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def shapes(cfg: Mapping) -> Dict[str, Shape]:
    """Every parameter's shape, by the program's parameter names."""
    if cfg["family"] != "granite_hybrid":
        raise ValueError(f"no granite_hybrid parameter set for family {cfg['family']!r}")
    d, E, F, Fs = cfg["d_model"], cfg["n_experts"], cfg["d_ff"], cfg["shared_ff"]
    H, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    di, Hm, P, N, G = _mixer_dims(cfg)
    conv = di + 2 * G * N
    layer_kinds = kinds(cfg)
    out: Dict[str, Shape] = {"embed.table": (weights.padded_vocab(cfg), d)}
    for j in range(layer_kinds.count("mamba")):
        b = f"blocks.{j}."
        out.update({b + "ln.scale": (d,),
                    b + "mamba.w_in": (d, 2 * di + 2 * G * N + Hm),
                    b + "mamba.conv_w": (cfg["conv_width"], conv),
                    b + "mamba.conv_b": (conv,),
                    b + "mamba.a_log": (Hm,), b + "mamba.dt_bias": (Hm,),
                    b + "mamba.d_skip": (Hm,),
                    b + "mamba.norm_scale": (di,),
                    b + "mamba.w_out": (di, d)})
    out["ln_f.scale"] = (d,)
    for j in range(layer_kinds.count("attention")):
        a = f"attn.{j}."
        out.update({a + "ln.scale": (d,), a + "attn.wq": (d, H, Dh), a + "attn.wk": (d, KV, Dh),
                    a + "attn.wv": (d, KV, Dh), a + "attn.wo": (H, Dh, d)})
    for i in range(len(layer_kinds)):
        f = f"ffn.{i}."
        out.update({f + "ln.scale": (d,), f + "moe.router": (d, E),
                    f + "moe.w_gate": (E, d, F), f + "moe.w_up": (E, d, F),
                    f + "moe.w_down": (E, F, d),
                    f + "shared.w_up": (d, Fs), f + "shared.w_down": (Fs, d),
                    f + "shared.w_gate": (d, Fs)})
    return out


def dtype_of(name: str, cfg: Mapping) -> torch.dtype:
    leaf = name.rsplit(".", 1)[-1]
    return torch.float32 if leaf in FLOAT32_LEAVES else weights.DTYPES[cfg["dtype"]]


def rule_of(name: str, init: Mapping):
    """The ``assumed.init`` rule of a parameter: its name's last two parts'
    where the configuration gives one, else its leaf name's."""
    parts = name.split(".")
    return init.get(".".join(parts[-2:]), init.get(parts[-1]))


def draw(cfg: Mapping, init: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``cfg`` drawn from ``seed`` on ``device``, by the
    rules of ``zamba2.draw`` and ``weights``' ``log_uniform``."""
    gen = torch.Generator(device=device).manual_seed((seed ^ weights.WEIGHT_STREAM) % 2**63)
    leaves = shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[Tuple[str, torch.dtype], list] = {}
    for name, shape in leaves.items():
        rule = rule_of(name, init)
        dtype = dtype_of(name, cfg)
        if rule[0] in ("normal", "uniform", "dt_bias", "log_uniform"):
            groups.setdefault((rule[0], dtype), []).append(name)
        else:
            out[name] = zw._fixed(rule, shape, dtype, device)
    for (kind, dtype), names in sorted(groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        sizes = [math.prod(leaves[n]) for n in names]
        sample = torch.randn if kind == "normal" else torch.rand
        flat = sample(sum(sizes), generator=gen, device=device, dtype=dtype)
        for name, part in zip(names, torch.split(flat, sizes)):
            rule = rule_of(name, init)
            out[name] = weights._finish(rule[:2] if kind == "normal" else rule,
                                        part.view(leaves[name]), leaves[name], cfg).to(dtype)
    return {name: out[name] for name in leaves}


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------

def mixer_params(cfg: Mapping) -> int:
    """Matmul parameters of one Mamba-2 mixer: in- and out-projection."""
    d = cfg["d_model"]
    di, H, _, N, G = _mixer_dims(cfg)
    return d * (2 * di + 2 * G * N + H) + di * d


def attention_params(cfg: Mapping) -> int:
    """Matmul parameters of one attention layer: q, k, v and o."""
    d, Dh = cfg["d_model"], head_dim(cfg)
    return d * Dh * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])


def ffn_params(cfg: Mapping) -> int:
    """Matmul parameters of one feed-forward a token uses: the router, its
    k experts and the shared expert."""
    d = cfg["d_model"]
    return d * cfg["n_experts"] + 3 * d * (cfg["moe_top_k"] * cfg["d_ff"] + cfg["shared_ff"])


def body_params(cfg: Mapping) -> int:
    """Matmul parameters a token uses, the unembedding aside."""
    k = kinds(cfg)
    return (k.count("mamba") * mixer_params(cfg) + k.count("attention") * attention_params(cfg)
            + len(k) * ffn_params(cfg))


def prefill_flops(cfg: Mapping, B: int, S: int) -> float:
    """A prefill of B prompts of S tokens, to the last position's logits."""
    _, H, P, N, G = _mixer_dims(cfg)
    k = kinds(cfg)
    return (2.0 * B * S * body_params(cfg) + 2.0 * B * cfg["d_model"] * cfg["vocab"]
            + k.count("mamba") * zw.ssd_flops(B, S, H, P, N, G, min(cfg["ssm_chunk"], S))
            + k.count("attention") * zw.attention_flops(B, S, cfg["n_heads"], head_dim(cfg)))


# ---------------------------------------------------------------------------
# bounds of the calls (shapes from the benchmark's call sites)
# ---------------------------------------------------------------------------

def moe_flops(m: Mapping) -> float:
    """A feed-forward call over T tokens: 2 x 3 D F a routed pair, 2 x 3 D
    F_shared and the router's 2 D E a token."""
    T, D, E, k, F, Fs = m["T"], m["D"], m["E"], m["k"], m["F"], m["Fs"]
    return 2.0 * 3 * D * F * T * k + 2.0 * 3 * D * Fs * T + 2.0 * D * E * T


def moe_bytes(m: Mapping) -> float:
    """The weights of each expert that received a row (all E once the call
    has T k >= E pairs; fewer only where it has fewer pairs than experts),
    the shared expert's and the float32 router's weights, x read and y
    written."""
    T, D, E, k, F, Fs = m["T"], m["D"], m["E"], m["k"], m["F"], m["Fs"]
    it = rooflines.ITEMSIZE[m["dtype"]]
    return it * (min(E, T * k) * 3 * D * F + 3 * D * Fs + 2 * T * D) + 4 * D * E


def moe_bound_s(m: Mapping) -> float:
    return rooflines.bound_s(moe_bytes(m), moe_flops(m), m["dtype"])


def flash_bound_s(m: Mapping) -> float:
    """A causal flash call (B, S, H query heads, KV heads, Dh): q and o at
    H heads, k and v at KV heads, each moved once; the causal products."""
    nbytes = (2 * rooflines.ITEMSIZE[m["dtype"]] * m["B"] * m["S"] * m["Dh"]
              * (m["H"] + m["KV"]))
    return rooflines.bound_s(nbytes, zw.attention_flops(m["B"], m["S"], m["H"], m["Dh"]),
                             m["dtype"])
