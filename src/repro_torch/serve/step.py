"""Serving steps: prefill / decode with batched requests and sampling
(mirrors ``src/repro/serve/step.py``).

The model holds its parameters, so the steps take no ``params``
argument.  Temperature sampling draws from a ``torch.Generator``; greedy
decoding (``temperature <= 0``) is deterministic.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch


def make_prefill_step(model, max_len: Optional[int] = None) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch, max_len=max_len)
    return prefill_step


def make_decode_step(model, temperature: float = 0.0) -> Callable:
    """(tokens (B,), cache, generator) -> (next tokens, cache)."""

    def decode_step(tokens, cache, generator=None):
        logits, cache = model.decode_step(tokens, cache)
        return _sample(logits, temperature, generator), cache

    return decode_step


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, batch: Dict[str, torch.Tensor], n_tokens: int,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             times: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Greedy/temperature generation loop (host-side driver); returns
    (B, n_tokens) int32.  The first token is the prefill's argmax whatever
    the temperature, as in the reference; decode steps sample.  If
    ``times`` is given, it receives the seconds
    of the prefill (``prefill_s``) and of the decode steps (``decode_s``),
    each ending in a device synchronise."""
    B, S = batch["tokens"].shape
    max_len = max_len or (S + n_tokens)
    dev = model.device
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(model, max_len)(batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)   # as the reference, at any temperature
    _sync(dev)
    t1 = time.perf_counter()
    decode = make_decode_step(model, temperature)
    out = [tok]
    for _ in range(n_tokens - 1):
        tok, cache = decode(tok, cache, generator)
        out.append(tok)
    tokens = torch.stack(out, dim=1)
    _sync(dev)
    if times is not None:
        times["prefill_s"] = t1 - t0
        times["decode_s"] = time.perf_counter() - t1
    return tokens
