"""Language-model assembly (mirrors ``src/repro/models/lm.py``; the SSM
family so far).

:class:`SSMModel` keeps the reference's serving API, with the parameters
inside the module instead of a pytree argument:

  init_cache(batch_size, seq_len)  -> cache dict
  prefill(batch, max_len)          -> (last logits, cache)
  decode_step(tokens, cache)       -> (logits, cache)

``build_model(cfg, device, generator)`` is the factory; families whose
path is not ported yet raise ``NotImplementedError``.  Entry points run
on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from . import mamba2 as m2
from .common import apply_norm, embed_init, init_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


def _frozen(params: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


class SSMBlock(nn.Module):
    """Pre-norm residual block around one Mamba-2 mixer."""

    def __init__(self, cfg: ModelConfig, scfg: m2.SSMConfig,
                 gen: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.ln = _frozen(init_norm(cfg.d_model, cfg.norm, dtype, gen.device))
        self.mamba = m2.Mamba2(scfg, gen, dtype)


class SSMModel(nn.Module):
    """Embedding, a stack of Mamba-2 blocks and a final norm; the
    unembedding is tied to the (row-padded) embedding table.  The
    weights are drawn from ``generator`` (seed 0 on ``device`` if None)."""

    def __init__(self, cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = _device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        self.cfg = cfg
        self.dtype = _dtype(cfg)
        scfg = self.ssm_cfg()
        self.embed = _frozen({"table": embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), self.dtype)})
        self.blocks = nn.ModuleList(
            [SSMBlock(cfg, scfg, generator, self.dtype)
             for _ in range(cfg.n_layers)])
        self.ln_f = _frozen(init_norm(cfg.d_model, cfg.norm, self.dtype, dev))

    def ssm_cfg(self) -> m2.SSMConfig:
        cfg = self.cfg
        return m2.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                            conv_width=cfg.conv_width, chunk=cfg.ssm_chunk)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """(B, D) -> (B, vocab) float32 logits against the tied table."""
        table = self.embed["table"]
        logits = torch.matmul(h.float(), table.float().t())
        return logits[:, :self.cfg.vocab]

    def init_cache(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        scfg = self.ssm_cfg()
        L, dev = self.cfg.n_layers, self.device
        conv = torch.zeros((L, batch_size, scfg.conv_width - 1, scfg.conv_dim),
                           dtype=self.dtype, device=dev)
        ssm = torch.zeros((L, batch_size, scfg.n_heads, scfg.d_state,
                           scfg.head_dim), dtype=torch.float32, device=dev)
        return {"conv": conv, "ssm": ssm,
                "pos": torch.zeros(batch_size, dtype=torch.int32, device=dev)}

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """batch["tokens"]: (B, S) -> (last logits (B, vocab), cache)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        x = self.embed["table"][tokens]
        convs, ssms = [], []
        for blk in self.blocks:
            h = apply_norm(blk.ln, x, cfg.norm, impl=cfg.norm_impl)
            y, (cs, ss) = blk.mamba(h, return_state=True)
            x = x + y
            convs.append(cs)
            ssms.append(ss)
        h = apply_norm(self.ln_f, x, cfg.norm, impl=cfg.norm_impl)
        logits = self._logits(h[:, -1])
        B, S = tokens.shape
        return logits, {"conv": torch.stack(convs).to(self.dtype),
                        "ssm": torch.stack(ssms),
                        "pos": torch.full((B,), S, dtype=torch.int32,
                                          device=self.device)}

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens: (B,) -> (logits (B, vocab), new cache)."""
        cfg = self.cfg
        x = self.embed["table"][tokens.to(self.device)]           # (B, D)
        convs, ssms = [], []
        for i, blk in enumerate(self.blocks):
            h = apply_norm(blk.ln, x, cfg.norm, impl=cfg.norm_impl)
            y, (cs, ss) = blk.mamba.decode_step(h, (cache["conv"][i],
                                                    cache["ssm"][i]))
            x = x + y
            convs.append(cs)
            ssms.append(ss)
        h = apply_norm(self.ln_f, x, cfg.norm, impl=cfg.norm_impl)
        return self._logits(h), {"conv": torch.stack(convs),
                                 "ssm": torch.stack(ssms),
                                 "pos": cache["pos"] + 1}


def build_model(cfg: ModelConfig, device: str = "cuda",
                generator: Optional[torch.Generator] = None) -> nn.Module:
    if cfg.family == "ssm":
        return SSMModel(cfg, device=device, generator=generator)
    raise NotImplementedError(f"model family {cfg.family!r} ({cfg.name}) is "
                              f"not ported yet; the port serves: ssm")
