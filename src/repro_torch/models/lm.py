"""Language-model assembly (mirrors ``src/repro/models/lm.py``).

:class:`Model` (dense and MoE), :class:`VLMModel`, :class:`SSMModel`,
:class:`HybridModel` and :class:`EncDecModel` keep the reference's API,
with the parameters inside the module instead of a pytree argument:

  hidden(batch)                    -> (final-norm hidden states, aux)
  loss(batch)                      -> (scalar, {"ce", "aux"})
  init_cache(batch_size, seq_len)  -> cache dict
  prefill(batch, max_len)          -> (last logits, cache)
  decode_step(tokens, cache)       -> (logits, cache)

The reference scans over stacked layers; here a Python loop runs a flat
``ModuleList`` of blocks.  Every parameter is trainable; serving runs
under ``torch.inference_mode``.  With ``cfg.remat == "block"`` and grad
mode on, ``hidden``/``loss`` recompute each block in the backward
(``torch.utils.checkpoint``), where the reference wraps its scanned
blocks in ``jax.checkpoint``; the hybrid also wraps each supercell, as
the reference does.  Cross-entropy runs over sequence chunks
(:func:`chunked_ce_loss`), so the (B, S, vocab) logits are never held.
The MoE ffn returns the router's load-balancing loss, summed over the
layers as ``aux``; ``loss`` adds 0.01 x aux.  ``build_model(cfg, device,
generator, mesh)`` is the factory.  Entry points run on the card unless
``device="cpu"`` is asked for; ``device="meta"`` builds the parameters'
shapes only, drawing nothing (``models.accounting``).

On a mesh (``mesh=`` a ``DeviceMesh``; one process per coordinate) the
model trains as the reference's does under GSPMD, computing the same
function:

* the parameters are drawn whole from the same seed on every rank, as
  the one-device model draws them, and are then placed as DTensors by
  ``sharding.param_shardings`` (``launch.train`` does so; a sharded init
  is later work); each block gathers its own parameters whole just
  before it runs and drops them after (ZeRO-3), so its gradients come
  back reduce-scattered onto the shards (``distributed.collectives``);
* ``hidden`` and ``loss`` take the global batch as DTensors
  (``sharding.shard_batch``) and compute on this rank's batch shard over
  (pod, data); activations are plain local tensors, checked at the
  reference's block boundaries (``sharding.constrain_batch``), so the
  kernels take plain tensors as on one device;
* ``loss`` returns this rank's share of the global loss: the
  cross-entropy's sum over its tokens over the global token count, and
  its share of the load-balancing loss, so that the shares summed over
  the batch shards are the reference's loss and the gradients summed
  there its gradients;
* ``attn_impl="ring"`` runs ``distributed.ring_attention`` over the
  ``model`` axis where the sequence divides it;
* ``moe_impl="sharded"`` runs ``moe.apply_moe_sharded`` on any mesh, one
  device included, as the reference does: its expert weights (and
  router) stay out of the block's gather, and the dispatch takes its own
  shards of them;
* serving (``prefill``, ``decode_step``) takes the global batch as
  DTensors, or plain tensors of this rank's shard, and serves this
  rank's batch shard through the same gathered blocks; the logits and
  every cache hold this rank's rows, and decode takes and writes them.

Without a mesh every path is the one-device path, unchanged.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import batch_sum, gather_param, local_of
from repro_torch.sharding.rules import constrain_batch, placements, shard_batch_spec
from repro_torch.tracing import span
from . import attention as attn
from . import mamba2 as m2
from . import mlp as mlpm
from . import moe as moem
from .common import NoDraw, Params, apply_norm, embed_init, init_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CE_CHUNK = 512


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


def _generator(dev: torch.device,
               generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or seed 0 on ``dev`` if None; on the ``meta`` device,
    where no generator can live, :class:`NoDraw`."""
    if dev.type == "meta":
        if generator is not None and not isinstance(generator, NoDraw):
            raise ValueError("a build on the meta device draws nothing; "
                             "pass no generator")
        return NoDraw()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return generator


@contextlib.contextmanager
def _gathered(mesh, *modules: nn.Module, keep: tuple = ()):
    """For the duration, each DTensor parameter of ``modules`` gathered
    whole as a plain tensor in its module's place (ZeRO-3), except those
    of the modules in ``keep``; nothing without a mesh."""
    swapped = []
    if mesh is not None:
        kept = {id(sub) for mod in keep for sub in mod.modules()}
        for mod in modules:
            for sub in mod.modules():
                if id(sub) in kept:
                    continue
                swapped += [(sub, name, p) for name, p in sub._parameters.items()
                            if isinstance(p, DTensor)]
        for sub, name, p in swapped:
            sub._parameters[name] = gather_param(p)
    try:
        yield
    finally:
        for sub, name, p in swapped:
            sub._parameters[name] = p


def _serving(fn):
    """Run ``fn`` under ``torch.inference_mode``, with the model's
    embedding and final norm gathered on a mesh."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with torch.inference_mode(), _gathered(self.mesh, self.embed, self.ln_f):
            return fn(self, *args, **kwargs)
    return wrapper


def _batch_shard(v: DTensor, mesh) -> torch.Tensor:
    """This rank's shard of a global-batch DTensor, over (pod, data)."""
    return local_of(v, placements(shard_batch_spec(mesh, v.shape), mesh))


def _sharded_moe(blk: nn.Module, cfg: ModelConfig, mesh) -> tuple:
    """The block's MoE, whose parameters the sharded dispatch shards
    itself (:func:`_apply_ffn`), as a ``keep`` for :func:`_gathered`."""
    if mesh is not None and cfg.moe_impl == "sharded" and hasattr(blk, "moe"):
        return (blk.moe,)
    return ()


def _pad_kv(kv: torch.Tensor, max_len: Optional[int]) -> torch.Tensor:
    """Pad a stacked KV cache (..., S, KV, Dh) with zeros along S to
    ``max_len`` so decode steps have room to append."""
    S = kv.shape[-3]
    if max_len is None or S >= max_len:
        return kv
    out = kv.new_zeros(kv.shape[:-3] + (max_len,) + kv.shape[-2:])
    out[..., :S, :, :] = kv
    return out


def _attn_cfg(cfg: ModelConfig, causal: bool = True) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, causal=causal,
        q_block=cfg.q_block, kv_block=cfg.kv_block)


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

def chunked_ce_loss(table: torch.Tensor, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int = CE_CHUNK,
                    valid_vocab: Optional[int] = None, mesh=None) -> torch.Tensor:
    """hidden: (B, S, D); labels: (B, S) (-1 = masked).  Mean NLL over the
    unmasked labels, float32, computed ``chunk`` positions at a time.  On a
    mesh, this batch shard's summed NLL over the global count of unmasked
    labels: its share of the global mean.

    ``valid_vocab``: when the embedding table is padded to a lane multiple
    (``cfg.pad_vocab_multiple``), rows >= valid_vocab get a -1e30 logit so
    the padding never enters the softmax."""
    B, S, D = hidden.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"cross-entropy chunk {c}")
    tf = table.float()
    V = table.shape[0]
    pad = None
    if valid_vocab is not None and valid_vocab < V:
        pad = torch.arange(V, device=table.device) >= valid_vocab
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, c):
        logits = torch.matmul(hidden[:, s0:s0 + c].float(), tf.t())   # (B, c, V)
        if pad is not None:
            logits = logits.masked_fill(pad, -1e30)
        lab = labels[:, s0:s0 + c]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.clamp(min=0).long()[..., None])[..., 0]
        mask = (lab >= 0).float()
        tot = tot + torch.sum((logz - gold) * mask)
        cnt = cnt + torch.sum(mask)
    if mesh is not None:
        cnt = batch_sum(cnt, mesh)
    return tot / torch.clamp(cnt, min=1.0)


class SSMBlock(nn.Module):
    """Pre-norm residual block around one Mamba-2 mixer."""

    def __init__(self, cfg: ModelConfig, scfg: m2.SSMConfig,
                 gen: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.ln = nn.ParameterDict(init_norm(cfg.d_model, cfg.norm, dtype, gen.device))
        self.mamba = m2.Mamba2(scfg, gen, dtype)


# ---------------------------------------------------------------------------
# transformer block (dense / moe ffn)
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """A block's named parts, each a parameter dict (a tensor part, the
    VLM's scalar ``gate``, is one parameter), under the reference's names."""

    def __init__(self, parts: Dict[str, Any]):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, nn.Parameter(part) if isinstance(part, torch.Tensor)
                    else nn.ParameterDict(part))


def init_tblock(gen: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype) -> Dict[str, Params]:
    """``ln1``, ``attn``, ``ln2`` and ``moe`` (a MoE config) or ``mlp``."""
    dev = gen.device
    p = {"ln1": init_norm(cfg.d_model, cfg.norm, dtype, dev),
         "attn": attn.init_attention(gen, _attn_cfg(cfg), dtype),
         "ln2": init_norm(cfg.d_model, cfg.norm, dtype, dev)}
    if cfg.n_experts:
        p["moe"] = moem.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                 cfg.moe_top_k, dtype)
    else:
        p["mlp"] = mlpm.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype)
    return p


class TBlock(Block):
    """Pre-norm attention + MLP (or MoE) block."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype):
        super().__init__(init_tblock(gen, cfg, dtype))


def _apply_ffn(p: Block, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """(y, aux): the MoE and its load-balancing loss, or the MLP and None.
    ``moe_impl="sharded"`` on a mesh, one device included, runs the
    sharded dispatch, whose capacity drops make another function than the
    dense one (reference ``src/repro/models/lm.py:131-141``); without a
    mesh, or with ``moe_impl="dense"``, the dense dispatch runs."""
    if cfg.n_experts:
        if cfg.moe_impl == "sharded" and mesh is not None:
            return moem.apply_moe_sharded(p.moe, x, cfg.moe_top_k, cfg.n_experts, mesh,
                                          schedule=cfg.moe_schedule)
        return moem.apply_moe_dense(p.moe, x, cfg.moe_top_k, cfg.n_experts, mesh)
    return mlpm.apply_mlp(p.mlp, x, cfg.mlp), None


def apply_tblock(p: TBlock, x: torch.Tensor, cfg: ModelConfig, mesh=None,
                 global_batch: Optional[int] = None):
    """x: (B, S, D) -> (x', aux), the full-sequence block; aux is a float32
    0 for the MLP.  On a mesh x is this rank's batch shard of
    ``global_batch`` rows and p's parameters are whole (gathered)."""
    x = constrain_batch(x, mesh, global_batch)
    h = apply_norm(p.ln1, x, cfg.norm, impl=cfg.norm_impl)
    x = x + attn.self_attention(p.attn, h, _attn_cfg(cfg), impl=cfg.attn_impl, mesh=mesh)
    x = constrain_batch(x, mesh, global_batch)
    h = apply_norm(p.ln2, x, cfg.norm, impl=cfg.norm_impl)
    y, aux = _apply_ffn(p, h, cfg, mesh)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return constrain_batch(x + y, mesh, global_batch), aux


def prefill_tblock(p: TBlock, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """x: (B, S, D) -> (x', (k, v)); the MoE's aux is dropped.  On a mesh
    x is this rank's batch shard and p's parameters are gathered (but a
    sharded MoE's)."""
    with _gathered(mesh, p, keep=_sharded_moe(p, cfg, mesh)):
        x = constrain_batch(x, mesh)
        h = apply_norm(p.ln1, x, cfg.norm, impl=cfg.norm_impl)
        a, kv = attn.prefill_attention(p.attn, h, _attn_cfg(cfg), impl=cfg.attn_impl,
                                       mesh=mesh)
        x = x + a
        h = apply_norm(p.ln2, x, cfg.norm, impl=cfg.norm_impl)
        return x + _apply_ffn(p, h, cfg, mesh)[0], kv


def decode_tblock(p: TBlock, x: torch.Tensor, kv_cache, pos: torch.Tensor,
                  cfg: ModelConfig, mesh=None):
    """x: (B, 1, D); the k/v cache is written at ``pos`` in place."""
    with _gathered(mesh, p, keep=_sharded_moe(p, cfg, mesh)):
        h = apply_norm(p.ln1, x, cfg.norm, impl=cfg.norm_impl)
        a, kv_cache = attn.decode_attention(p.attn, h, kv_cache, pos, _attn_cfg(cfg))
        x = x + a
        h = apply_norm(p.ln2, x, cfg.norm, impl=cfg.norm_impl)
        return x + _apply_ffn(p, h, cfg, mesh)[0], kv_cache


# ---------------------------------------------------------------------------
# dense model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """Embedding, a stack of transformer blocks (dense or MoE ffn) and a
    final norm; the unembedding is the (row-padded) embedding table, in
    float32, whatever ``tie_embeddings`` says, as in the reference.  The
    weights are drawn from ``generator`` (seed 0 on ``device`` if None).
    On the card every attention prefill runs the CUDA flash-attention
    kernel once per layer.  ``mesh``: see the module docstring."""

    def __init__(self, cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        dev = _device(device)
        generator = _generator(dev, generator)
        self.cfg = cfg
        self.mesh = mesh
        self.dtype = _dtype(cfg)
        self.embed = nn.ParameterDict({"table": embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), self.dtype)})
        self.blocks = nn.ModuleList([self._block(generator)
                                     for _ in range(self._n_blocks())])
        self.ln_f = nn.ParameterDict(init_norm(cfg.d_model, cfg.norm, self.dtype, dev))

    def _block(self, gen: torch.Generator) -> nn.Module:
        return TBlock(self.cfg, gen, self.dtype)

    def _n_blocks(self) -> int:
        return self.cfg.n_layers

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., vocab) float32 logits against the tied table."""
        logits = torch.matmul(h.float(), self.embed["table"].float().t())
        return logits[..., :self.cfg.vocab]

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D) hidden after the last block -> (B, vocab) logits."""
        cfg = self.cfg
        return self._logits(apply_norm(self.ln_f, x, cfg.norm, impl=cfg.norm_impl))

    # -- full-sequence forward ----------------------------------------------
    def _remat(self, fn, *args):
        """``fn(*args)``, recomputed in the backward when ``cfg.remat`` is
        "block" and grad mode is on."""
        if self.cfg.remat == "block" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _tblock(self, blk: nn.Module, x: torch.Tensor, gb: Optional[int]):
        """A transformer block with its parameters gathered on a mesh (but
        a sharded MoE's)."""
        with _gathered(self.mesh, blk, keep=_sharded_moe(blk, self.cfg, self.mesh)):
            return apply_tblock(blk, x, self.cfg, self.mesh, gb)

    def _backbone(self, x: torch.Tensor, batch: Dict[str, torch.Tensor],
                  gb: Optional[int] = None):
        """The blocks over the embedded tokens -> (x, aux summed over the
        layers); ``gb`` is the global batch on a mesh."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x, a = self._remat(self._tblock, blk, x, gb)
            aux = aux + a
        return x, aux

    def _local_batch(self, batch: Dict[str, torch.Tensor]):
        """(batch, global batch size): without a mesh the batch as it is and
        None; on a mesh each entry, a DTensor of the global batch, as this
        rank's shard over (pod, data)."""
        if self.mesh is None:
            return batch, None
        out = {}
        for k, v in batch.items():
            if not isinstance(v, DTensor):
                raise TypeError(f"on a mesh batch[{k!r}] must be a DTensor of the "
                                f"global batch (sharding.shard_batch), not a "
                                f"{type(v).__name__}")
            out[k] = _batch_shard(v, self.mesh)
        return out, batch["tokens"].shape[0]

    def _serve_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """On a mesh, this rank's shard of each entry: a DTensor of the
        global batch as its local shard over (pod, data), a plain tensor
        as it is (this rank's rows already)."""
        if self.mesh is None:
            return batch
        return {k: _batch_shard(v, self.mesh) if isinstance(v, DTensor) else v
                for k, v in batch.items()}

    def _hidden(self, batch: Dict[str, torch.Tensor], gb: Optional[int]):
        cfg = self.cfg
        with _gathered(self.mesh, self.embed, self.ln_f):
            x = self.embed["table"][batch["tokens"].to(self.device)]
            x, aux = self._backbone(x, batch, gb)
            return apply_norm(self.ln_f, x, cfg.norm, impl=cfg.norm_impl), aux

    def hidden(self, batch: Dict[str, torch.Tensor]):
        """batch["tokens"]: (B, S), plus ``media`` (vlm) or ``frames``
        (audio) -> (final-norm hidden (B, S, D), aux); on a mesh this rank's
        batch shard of the hidden states and its share of aux."""
        return self._hidden(*self._local_batch(batch))

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Mean cross-entropy of ``batch["labels"]`` (-1 = masked) plus
        0.01 x aux; returns (loss, {"ce", "aux"}).  On a mesh each is this
        rank's share, summing over the batch shards to the global value."""
        batch, gb = self._local_batch(batch)
        with _gathered(self.mesh, self.embed):
            h, aux = self._hidden(batch, gb)
            ce = chunked_ce_loss(self.embed["table"], h, batch["labels"].to(self.device),
                                 valid_vocab=self.cfg.vocab, mesh=self.mesh)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "pos": torch.zeros(batch_size, dtype=torch.int32, device=self.device)}

    @_serving
    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """batch["tokens"]: (B, S) -> (last logits (B, vocab), cache); the
        k/v caches (L, B, S, KV, Dh) are zero-padded along S to ``max_len``."""
        tokens = self._serve_batch(batch)["tokens"].to(self.device)
        x = self.embed["table"][tokens]
        ks, vs = [], []
        for blk in self.blocks:
            x, (k, v) = prefill_tblock(blk, x, self.cfg, self.mesh)
            ks.append(k)
            vs.append(v)
        B, S = tokens.shape
        return self._final(x[:, -1]), {
            "k": _pad_kv(torch.stack(ks), max_len), "v": _pad_kv(torch.stack(vs), max_len),
            "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}

    @_serving
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens: (B,) -> (logits (B, vocab), new cache).  The k/v caches
        are written at ``pos`` in place and returned as they are."""
        tokens = self._serve_batch({"tokens": tokens})["tokens"]
        x = self.embed["table"][tokens.to(self.device)][:, None]     # (B, 1, D)
        pos = cache["pos"]
        for i, blk in enumerate(self.blocks):
            x, _ = decode_tblock(blk, x, (cache["k"][i], cache["v"][i]), pos, self.cfg,
                                 self.mesh)
        return self._final(x[:, 0]), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# VLM: self layers + periodic cross-attention layers
# ---------------------------------------------------------------------------

def init_xblock(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                self_attn: bool) -> Dict[str, Any]:
    """A block with cross attention over a memory (``xattn``): the VLM's
    tanh-gated cross block (``ln1``, ``xattn``, ``ln2``, ``mlp``, the scalar
    ``gate``, 0 at init) or, with ``self_attn``, the enc-dec decoder's
    block (``ln1``, causal ``attn``, ``lnx``, ``xattn``, ``ln2``, ``mlp``)."""
    dev, d = gen.device, cfg.d_model
    p: Dict[str, Any] = {"ln1": init_norm(d, cfg.norm, dtype, dev)}
    if self_attn:
        p["attn"] = attn.init_attention(gen, _attn_cfg(cfg), dtype)
        p["lnx"] = init_norm(d, cfg.norm, dtype, dev)
    p["xattn"] = attn.init_attention(gen, _attn_cfg(cfg, causal=False), dtype)
    p["ln2"] = init_norm(d, cfg.norm, dtype, dev)
    p["mlp"] = mlpm.init_mlp(gen, d, cfg.d_ff, cfg.mlp, dtype)
    if not self_attn:
        p["gate"] = torch.zeros((), dtype=dtype, device=dev)
    return p


class VLMModel(Model):
    """Supercells of ``cross_every - 1`` self blocks and one tanh-gated
    cross block over the media tokens (Llama-3.2-Vision's layout).
    ``blocks[s * n_self + j]`` is self block j of supercell s and
    ``cross[s]`` its cross block.  Under remat the self blocks are
    recomputed, the cross blocks not, as in the reference.  The cache
    holds the self blocks' k/v per (supercell, block) and the media."""

    def __init__(self, cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None):
        if cfg.cross_every < 2 or cfg.n_layers % cfg.cross_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not make "
                             f"supercells of cross_every={cfg.cross_every}")
        generator = _generator(_device(device), generator)
        super().__init__(cfg, device=device, generator=generator, mesh=mesh)
        self.cross = nn.ModuleList([Block(init_xblock(generator, cfg, self.dtype, False))
                                    for _ in range(self.n_super)])

    @property
    def n_super(self) -> int:
        return self.cfg.n_layers // self.cfg.cross_every

    @property
    def n_self(self) -> int:
        return self.cfg.cross_every - 1

    def _n_blocks(self) -> int:
        return self.n_super * self.n_self

    def _apply_cross(self, cp: Block, x: torch.Tensor,
                     media: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with _gathered(self.mesh, cp):
            h = apply_norm(cp.ln1, x, cfg.norm, impl=cfg.norm_impl)
            x = x + torch.tanh(cp.gate) * attn.cross_attention(
                cp.xattn, h, media, _attn_cfg(cfg, causal=False))
            h = apply_norm(cp.ln2, x, cfg.norm, impl=cfg.norm_impl)
            return x + mlpm.apply_mlp(cp.mlp, h, cfg.mlp)

    def _backbone(self, x: torch.Tensor, batch: Dict[str, torch.Tensor],
                  gb: Optional[int] = None):
        media = batch["media"].to(self.device, self.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(self.n_super):
            for j in range(self.n_self):
                x, a = self._remat(self._tblock, self.blocks[s * self.n_self + j], x, gb)
                aux = aux + a
            x = self._apply_cross(self.cross[s], x, media)
        return x, aux

    def init_cache(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        shape = (self.n_super, self.n_self, batch_size, seq_len, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "media": torch.zeros((batch_size, cfg.n_media_tokens, cfg.d_model),
                                     dtype=self.dtype, device=self.device),
                "pos": torch.zeros(batch_size, dtype=torch.int32, device=self.device)}

    @_serving
    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """batch["tokens"]: (B, S), batch["media"]: (B, M, D) -> (last logits
        (B, vocab), cache); the k/v caches (n_super, n_self, B, S, KV, Dh)
        are zero-padded along S to ``max_len``."""
        batch = self._serve_batch(batch)
        tokens = batch["tokens"].to(self.device)
        media = batch["media"].to(self.device, self.dtype)
        x = self.embed["table"][tokens]
        ks, vs = [], []
        for s in range(self.n_super):
            for j in range(self.n_self):
                x, (k, v) = prefill_tblock(self.blocks[s * self.n_self + j], x, self.cfg,
                                           self.mesh)
                ks.append(k)
                vs.append(v)
            x = self._apply_cross(self.cross[s], x, media)
        lead = (self.n_super, self.n_self)
        B, S = tokens.shape
        return self._final(x[:, -1]), {
            "k": _pad_kv(torch.stack(ks).reshape(lead + ks[0].shape), max_len),
            "v": _pad_kv(torch.stack(vs).reshape(lead + vs[0].shape), max_len),
            "media": media,
            "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}

    @_serving
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens: (B,) -> (logits (B, vocab), new cache); the k/v caches are
        written at ``pos`` in place."""
        tokens = self._serve_batch({"tokens": tokens})["tokens"]
        x = self.embed["table"][tokens.to(self.device)][:, None]     # (B, 1, D)
        pos = cache["pos"]
        for s in range(self.n_super):
            for j in range(self.n_self):
                x, _ = decode_tblock(self.blocks[s * self.n_self + j], x,
                                     (cache["k"][s, j], cache["v"][s, j]), pos, self.cfg,
                                     self.mesh)
            x = self._apply_cross(self.cross[s], x, cache["media"])
        return self._final(x[:, 0]), {"k": cache["k"], "v": cache["v"],
                                      "media": cache["media"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# SSM (mamba2) model
# ---------------------------------------------------------------------------

class SSMModel(Model):
    """Embedding, a stack of Mamba-2 blocks and a final norm; the
    unembedding is tied to the (row-padded) embedding table."""

    def _block(self, gen: torch.Generator) -> nn.Module:
        return SSMBlock(self.cfg, self.ssm_cfg(), gen, self.dtype)

    def ssm_cfg(self) -> m2.SSMConfig:
        cfg = self.cfg
        return m2.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                            conv_width=cfg.conv_width, chunk=cfg.ssm_chunk)

    def _mamba(self, i: int, x: torch.Tensor, gb: Optional[int] = None) -> torch.Tensor:
        """Block i over the full sequence, without its states (its
        parameters gathered on a mesh)."""
        cfg, blk, mesh = self.cfg, self.blocks[i], self.mesh
        with span("model.block", layer=i), _gathered(mesh, blk):
            x = constrain_batch(x, mesh, gb)
            y = x + blk.mamba(apply_norm(blk.ln, x, cfg.norm, impl=cfg.norm_impl))
            return constrain_batch(y, mesh, gb)

    def _backbone(self, x: torch.Tensor, batch: Dict[str, torch.Tensor],
                  gb: Optional[int] = None):
        for i in range(self.cfg.n_layers):
            x = self._remat(self._mamba, i, x, gb)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def init_cache(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        scfg = self.ssm_cfg()
        L, dev = self.cfg.n_layers, self.device
        conv = torch.zeros((L, batch_size, scfg.conv_width - 1, scfg.conv_dim),
                           dtype=self.dtype, device=dev)
        ssm = torch.zeros((L, batch_size, scfg.n_heads, scfg.d_state,
                           scfg.head_dim), dtype=torch.float32, device=dev)
        return {"conv": conv, "ssm": ssm,
                "pos": torch.zeros(batch_size, dtype=torch.int32, device=dev)}

    def _mamba_prefill(self, i: int, x: torch.Tensor, convs: list, ssms: list):
        """Block i over the full sequence (its parameters gathered on a
        mesh); appends its conv and SSM states."""
        cfg, blk, mesh = self.cfg, self.blocks[i], self.mesh
        with span("model.block", layer=i):
            with _gathered(mesh, blk):
                x = constrain_batch(x, mesh)
                h = apply_norm(blk.ln, x, cfg.norm, impl=cfg.norm_impl)
                y, (cs, ss) = blk.mamba(h, return_state=True)
            convs.append(cs)
            ssms.append(ss)
            return constrain_batch(x + y, mesh)

    def _mamba_decode(self, i: int, x: torch.Tensor, cache, convs: list, ssms: list):
        """Block i for one token; appends its new conv and SSM states."""
        cfg, blk = self.cfg, self.blocks[i]
        with span("model.block", layer=i):
            with _gathered(self.mesh, blk):
                h = apply_norm(blk.ln, x, cfg.norm, impl=cfg.norm_impl)
                y, (cs, ss) = blk.mamba.decode_step(h, (cache["conv"][i], cache["ssm"][i]))
            convs.append(cs)
            ssms.append(ss)
            return x + y

    @_serving
    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """batch["tokens"]: (B, S) -> (last logits (B, vocab), cache)."""
        tokens = self._serve_batch(batch)["tokens"].to(self.device)
        x = self.embed["table"][tokens]
        convs, ssms = [], []
        for i in range(self.cfg.n_layers):
            x = self._mamba_prefill(i, x, convs, ssms)
        B, S = tokens.shape
        return self._final(x[:, -1]), {
            "conv": torch.stack(convs).to(self.dtype), "ssm": torch.stack(ssms),
            "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}

    @_serving
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens: (B,) -> (logits (B, vocab), new cache)."""
        tokens = self._serve_batch({"tokens": tokens})["tokens"]
        x = self.embed["table"][tokens.to(self.device)]           # (B, D)
        convs, ssms = [], []
        for i in range(self.cfg.n_layers):
            x = self._mamba_decode(i, x, cache, convs, ssms)
        return self._final(x), {"conv": torch.stack(convs),
                                "ssm": torch.stack(ssms),
                                "pos": cache["pos"] + 1}


# ---------------------------------------------------------------------------
# hybrid (zamba2): mamba backbone + one shared attention block
# ---------------------------------------------------------------------------

class HybridModel(SSMModel):
    """Supercells of (shared attention block + ``attn_every`` Mamba-2
    blocks) plus trailing Mamba-2 blocks; the attention block's weights
    are SHARED by all its applications (Zamba's parameter-sharing trick).
    ``blocks[s * attn_every + j]`` is block j of supercell s, and the
    trailing blocks follow.  On the card each application of the shared
    block runs the CUDA flash-attention kernel once per prefill."""

    def __init__(self, cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None):
        generator = _generator(_device(device), generator)
        super().__init__(cfg, device=device, generator=generator, mesh=mesh)
        self.n_super = cfg.n_layers // cfg.attn_every
        self.n_trail = cfg.n_layers - self.n_super * cfg.attn_every
        self.shared_attn = TBlock(cfg, generator, self.dtype)

    def init_cache(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        cache = super().init_cache(batch_size, seq_len)
        shape = (self.n_super, batch_size, seq_len, self.cfg.n_kv_heads,
                 self.cfg.head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        cache["attn_v"] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return cache

    def _supercell(self, s: int, x: torch.Tensor, gb: Optional[int] = None) -> torch.Tensor:
        """The shared attention block, then supercell s's Mamba-2 blocks
        (each one recomputed on its own under remat)."""
        ne = self.cfg.attn_every
        x = self._tblock(self.shared_attn, x, gb)[0]
        for j in range(ne):
            x = self._remat(self._mamba, s * ne + j, x, gb)
        return x

    def _backbone(self, x: torch.Tensor, batch: Dict[str, torch.Tensor],
                  gb: Optional[int] = None):
        for s in range(self.n_super):
            x = self._remat(self._supercell, s, x, gb)
        for t in range(self.n_trail):
            x = self._remat(self._mamba, self.n_super * self.cfg.attn_every + t, x, gb)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    @_serving
    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """batch["tokens"]: (B, S) -> (last logits (B, vocab), cache); the
        k/v caches are zero-padded along S to ``max_len``."""
        cfg, ne = self.cfg, self.cfg.attn_every
        tokens = self._serve_batch(batch)["tokens"].to(self.device)
        x = self.embed["table"][tokens]
        convs, ssms, ks, vs = [], [], [], []
        for s in range(self.n_super):
            x, (k, v) = prefill_tblock(self.shared_attn, x, cfg, self.mesh)
            ks.append(k)
            vs.append(v)
            for j in range(ne):
                x = self._mamba_prefill(s * ne + j, x, convs, ssms)
        for t in range(self.n_trail):
            x = self._mamba_prefill(self.n_super * ne + t, x, convs, ssms)
        B, S = tokens.shape
        return self._final(x[:, -1]), {
            "conv": torch.stack(convs).to(self.dtype), "ssm": torch.stack(ssms),
            "attn_k": _pad_kv(torch.stack(ks), max_len),
            "attn_v": _pad_kv(torch.stack(vs), max_len),
            "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}

    @_serving
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens: (B,) -> (logits (B, vocab), new cache).  The k/v caches
        are written at ``pos`` in place and returned as they are."""
        cfg, ne = self.cfg, self.cfg.attn_every
        tokens = self._serve_batch({"tokens": tokens})["tokens"]
        x = self.embed["table"][tokens.to(self.device)]           # (B, D)
        pos = cache["pos"]
        convs, ssms = [], []
        for s in range(self.n_super):
            y, _ = decode_tblock(self.shared_attn, x[:, None],
                                 (cache["attn_k"][s], cache["attn_v"][s]), pos, cfg,
                                 self.mesh)
            x = y[:, 0]
            for j in range(ne):
                x = self._mamba_decode(s * ne + j, x, cache, convs, ssms)
        for t in range(self.n_trail):
            x = self._mamba_decode(self.n_super * ne + t, x, cache, convs, ssms)
        return self._final(x), {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                                "attn_k": cache["attn_k"], "attn_v": cache["attn_v"],
                                "pos": pos + 1}


# ---------------------------------------------------------------------------
# encoder-decoder (seamless): stubbed frame embeddings -> text decoder
# ---------------------------------------------------------------------------

class EncDecModel(Model):
    """An encoder of ``n_encoder_layers`` blocks with non-causal
    self-attention over the frame embeddings (the speech frontend is a
    stub: ``batch["frames"]`` (B, F, D)), then ``n_layers`` decoder blocks
    with causal self-attention and cross attention to the encoder's
    output.  ``blocks`` are the decoder's, ``enc_blocks`` and ``enc_ln``
    the encoder's.  On the card each prefill runs the flash-attention
    kernel once per encoder layer (non-causal) and once per decoder layer;
    decode steps reuse the cached memory and run the encoder no more.
    Under remat every encoder and decoder block is recomputed."""

    def __init__(self, cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None):
        generator = _generator(_device(device), generator)
        super().__init__(cfg, device=device, generator=generator, mesh=mesh)
        self.enc_blocks = nn.ModuleList([
            Block(init_tblock(generator, cfg, self.dtype))
            for _ in range(cfg.n_encoder_layers)])
        self.enc_ln = nn.ParameterDict(init_norm(cfg.d_model, cfg.norm, self.dtype,
                                                 generator.device))

    def _block(self, gen: torch.Generator) -> nn.Module:
        return Block(init_xblock(gen, self.cfg, self.dtype, True))

    def _enc_block(self, blk: Block, x: torch.Tensor, gb: Optional[int] = None) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        with _gathered(mesh, blk):
            x = constrain_batch(x, mesh, gb)
            h = apply_norm(blk.ln1, x, cfg.norm, impl=cfg.norm_impl)
            x = x + attn.self_attention(blk.attn, h, _attn_cfg(cfg, causal=False),
                                        impl=cfg.attn_impl, mesh=mesh)
            h = apply_norm(blk.ln2, x, cfg.norm, impl=cfg.norm_impl)
            return constrain_batch(x + mlpm.apply_mlp(blk.mlp, h, cfg.mlp), mesh, gb)

    def encode(self, frames: torch.Tensor, gb: Optional[int] = None) -> torch.Tensor:
        """frames: (B, F, D) stubbed speech embeddings -> memory (B, F, D)."""
        cfg = self.cfg
        x = frames.to(self.device, self.dtype)
        for blk in self.enc_blocks:
            x = self._remat(self._enc_block, blk, x, gb)
        with _gathered(self.mesh, self.enc_ln):
            return apply_norm(self.enc_ln, x, cfg.norm, impl=cfg.norm_impl)

    def _cross_mlp(self, blk: Block, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """A decoder block's cross attention and MLP."""
        cfg = self.cfg
        h = apply_norm(blk.lnx, x, cfg.norm, impl=cfg.norm_impl)
        x = x + attn.cross_attention(blk.xattn, h, memory, _attn_cfg(cfg, causal=False))
        h = apply_norm(blk.ln2, x, cfg.norm, impl=cfg.norm_impl)
        return x + mlpm.apply_mlp(blk.mlp, h, cfg.mlp)

    def _dec_block(self, blk: Block, x: torch.Tensor, memory: torch.Tensor,
                   gb: Optional[int] = None) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        with _gathered(mesh, blk):
            x = constrain_batch(x, mesh, gb)
            h = apply_norm(blk.ln1, x, cfg.norm, impl=cfg.norm_impl)
            x = x + attn.self_attention(blk.attn, h, _attn_cfg(cfg), impl=cfg.attn_impl,
                                        mesh=mesh)
            return self._cross_mlp(blk, x, memory)

    def _backbone(self, x: torch.Tensor, batch: Dict[str, torch.Tensor],
                  gb: Optional[int] = None):
        memory = self.encode(batch["frames"], gb)
        for blk in self.blocks:
            x = self._remat(self._dec_block, blk, x, memory, gb)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def init_cache(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        cache = super().init_cache(batch_size, seq_len)
        cache["memory"] = torch.zeros((batch_size, self.cfg.n_frames, self.cfg.d_model),
                                      dtype=self.dtype, device=self.device)
        return cache

    @_serving
    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """batch["tokens"]: (B, S), batch["frames"]: (B, F, D) -> (last
        logits (B, vocab), cache); the k/v caches (L, B, S, KV, Dh) are
        zero-padded along S to ``max_len``; the cache keeps the memory."""
        cfg, mesh = self.cfg, self.mesh
        batch = self._serve_batch(batch)
        tokens = batch["tokens"].to(self.device)
        memory = self.encode(batch["frames"])
        x = self.embed["table"][tokens]
        ks, vs = [], []
        for blk in self.blocks:
            with _gathered(mesh, blk):
                x = constrain_batch(x, mesh)
                h = apply_norm(blk.ln1, x, cfg.norm, impl=cfg.norm_impl)
                a, (k, v) = attn.prefill_attention(blk.attn, h, _attn_cfg(cfg),
                                                   impl=cfg.attn_impl, mesh=mesh)
                x = self._cross_mlp(blk, x + a, memory)
            ks.append(k)
            vs.append(v)
        B, S = tokens.shape
        return self._final(x[:, -1]), {
            "k": _pad_kv(torch.stack(ks), max_len), "v": _pad_kv(torch.stack(vs), max_len),
            "memory": memory,
            "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}

    @_serving
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens: (B,) -> (logits (B, vocab), new cache); the k/v caches are
        written at ``pos`` in place; the encoder does not run."""
        cfg = self.cfg
        tokens = self._serve_batch({"tokens": tokens})["tokens"]
        x = self.embed["table"][tokens.to(self.device)][:, None]     # (B, 1, D)
        pos, memory = cache["pos"], cache["memory"]
        for i, blk in enumerate(self.blocks):
            with _gathered(self.mesh, blk):
                h = apply_norm(blk.ln1, x, cfg.norm, impl=cfg.norm_impl)
                a, _ = attn.decode_attention(blk.attn, h, (cache["k"][i], cache["v"][i]),
                                             pos, _attn_cfg(cfg))
                x = self._cross_mlp(blk, x + a, memory)
        return self._final(x[:, 0]), {"k": cache["k"], "v": cache["v"],
                                      "memory": memory, "pos": pos + 1}


_FAMILIES = {"dense": Model, "moe": Model, "vlm": VLMModel, "ssm": SSMModel,
             "hybrid": HybridModel, "audio": EncDecModel}


def build_model(cfg: ModelConfig, device: str = "cuda",
                generator: Optional[torch.Generator] = None, mesh=None) -> nn.Module:
    """The model of ``cfg.family``; ``mesh`` is kept on it (module
    docstring); its parameters are plain tensors until placed
    (``sharding.place_params``)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name}); "
                         f"have {', '.join(_FAMILIES)}")
    return _FAMILIES[cfg.family](cfg, device=device, generator=generator, mesh=mesh)
