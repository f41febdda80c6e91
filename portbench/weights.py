"""Every parameter of a configuration, drawn from the seed on the device.

The parameter set (names, shapes and the dtypes they are served in) is
worked out here from the configuration file's widths, under the names the
program's modules give them; :func:`load` refuses a model whose
parameters differ.  Each leaf's initialisation is the configuration's
``assumed.init`` rule for its leaf name.  The draws are a few large calls
on one ``torch.Generator`` on the device: one per (rule kind, dtype), cut
into the leaves in name order.  The same seed on the same kind of device
gives the same tensors, so the reference is handed the same weights by
drawing them again once the program's are freed.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

Shape = Tuple[int, ...]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: leaves the program keeps in float32 whatever the configuration's dtype
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")
#: the stream a seed's weights come from (tokens use others)
WEIGHT_STREAM = 0x5EED_0001


def padded_vocab(cfg: Mapping) -> int:
    m = max(cfg.get("pad_vocab_multiple", 1), 1)
    return -(-cfg["vocab"] // m) * m


def shapes(cfg: Mapping) -> Dict[str, Shape]:
    """Every parameter's shape, by the program's parameter names."""
    if cfg["family"] != "ssm":
        raise ValueError(f"no parameter set for family {cfg['family']!r}")
    d, L = cfg["d_model"], cfg["n_layers"]
    out: Dict[str, Shape] = {"embed.table": (padded_vocab(cfg), d)}
    N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * d
    H = di // P
    conv = di + 2 * N
    for i in range(L):
        b = f"blocks.{i}."
        out.update({b + "ln.scale": (d,),
                    b + "mamba.w_in": (d, 2 * di + 2 * N + H),
                    b + "mamba.conv_w": (cfg["conv_width"], conv),
                    b + "mamba.conv_b": (conv,),
                    b + "mamba.a_log": (H,), b + "mamba.dt_bias": (H,),
                    b + "mamba.d_skip": (H,),
                    b + "mamba.norm_scale": (di,),
                    b + "mamba.w_out": (di, d)})
    out["ln_f.scale"] = (d,)
    return out


def dtype_of(name: str, cfg: Mapping) -> torch.dtype:
    leaf = name.rsplit(".", 1)[-1]
    return torch.float32 if leaf in FLOAT32_LEAVES else DTYPES[cfg["dtype"]]


def _finish(rule, u: torch.Tensor, shape: Shape, cfg: Mapping) -> torch.Tensor:
    """A leaf from its share ``u`` of its group's draw."""
    kind = rule[0]
    if kind == "normal":                  # N(0, std)
        return u.mul_(rule[1])
    if kind == "uniform":                 # U(-bound, bound)
        return u.mul_(2).sub_(1).mul_(rule[1])
    if kind == "uniform_fan_in":          # nn.Linear's default, over / sqrt(div)
        div = cfg[rule[1]] if len(rule) > 1 else 1
        return u.mul_(2).sub_(1).mul_(1 / math.sqrt(shape[0] * div))
    if kind == "log_uniform":             # log(U(lo, hi)): A_log
        lo, hi = rule[1], rule[2]
        return torch.log(u.mul_(hi - lo).add_(lo))
    if kind == "dt_bias":                 # softplus^-1 of a log-uniform dt, floored
        lo, hi, floor = rule[1], rule[2], rule[3]
        dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo)).clamp(min=floor)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init rule {rule!r}")


def draw(cfg: Mapping, init: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``cfg`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed((seed ^ WEIGHT_STREAM) % 2**63)
    leaves = shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[Tuple[str, torch.dtype], list] = {}
    for name, shape in leaves.items():
        rule = init[name.rsplit(".", 1)[-1]]
        dtype = dtype_of(name, cfg)
        if rule[0] == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            groups.setdefault((rule[0], dtype), []).append(name)
    for (kind, dtype), names in sorted(groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        sizes = [math.prod(leaves[n]) for n in names]
        sample = torch.randn if kind == "normal" else torch.rand
        flat = sample(sum(sizes), generator=gen, device=device, dtype=dtype)
        for name, part in zip(names, torch.split(flat, sizes)):
            rule = init[name.rsplit(".", 1)[-1]]
            out[name] = _finish(rule, part.view(leaves[name]), leaves[name], cfg).to(dtype)
    return {name: out[name] for name in leaves}


def load(model: torch.nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Make ``params`` the model's parameters (no copy).  Refuses a model
    whose parameter names, shapes or dtypes differ from the drawn set."""
    have = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    want = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the model's parameters differ from the drawn set: {diff}")
    model.load_state_dict(dict(params), strict=True, assign=True)


def checksum(params: Mapping[str, torch.Tensor]) -> float:
    """One number that a second draw must give again."""
    return float(sum(p.float().sum() * (i + 1) for i, p in enumerate(params.values())))
