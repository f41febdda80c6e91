"""Serving driver: batched prefill + greedy decode (mirrors
``src/repro/launch/serve.py``).

Serves every registered arch: the dense transformers (``olmo-1b``,
``yi-9b``, ``starcoder2-3b``, ``deepseek-67b``), the MoE
``granite-moe-1b-a400m`` and ``kimi-k2-1t-a32b``, ``mamba2-1.3b``
(attention-free), ``zamba2-1.2b`` (hybrid: Mamba-2 blocks and one shared
attention block), ``zamba2-7b`` (Zyphra's two shared blocks over grouped
Mamba-2 mixers; the port's own family), the VLM ``llama-3.2-vision-90b``
and the enc-dec ``seamless-m4t-large-v2``.  Requests come from the synthetic
``TokenPipeline``; the weights are random, drawn on the device from
``--seed``; the VLM's media and the enc-dec's frames are zeros of the
reference's shapes (the modality frontends are stubs).  On the card the
prefill of every Mamba-2 layer runs the CUDA conv1d and SSD kernels, and
every self-attention layer (the encoder's too, and every application of
the shared attention block) the CUDA flash-attention kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
      --batch 4 --prompt-len 1024 --gen 32          # full width, on the card
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import PORT_ARCHS, get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.serve import generate


def stub_inputs(cfg, batch: int, device) -> dict:
    """The stubbed modality inputs of a batch, as the reference's launchers
    make them: float32 zeros, ``media`` (B, n_media_tokens, D) for a VLM
    and ``frames`` (B, n_frames, D) for an enc-dec model."""
    shape = {"vlm": ("media", cfg.n_media_tokens),
             "audio": ("frames", cfg.n_frames)}.get(cfg.family)
    if shape is None:
        return {}
    return {shape[0]: torch.zeros((batch, shape[1], cfg.d_model), dtype=torch.float32,
                                  device=device)}


def main(argv=None) -> dict:
    """Returns the generated tokens, the timings and the model served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b", choices=PORT_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, device=args.device, generator=gen)

    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                                    global_batch=args.batch))
    batch = {"tokens": torch.from_numpy(pipe.batch_at(0)["tokens"]).long().to(dev),
             **stub_inputs(cfg, args.batch, dev)}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = {}
    t0 = time.perf_counter()
    out = generate(model, batch, n_tokens=args.gen,
                   temperature=args.temperature, generator=gen,
                   max_len=args.prompt_len + args.gen, times=times)
    out = out.cpu().numpy()
    wall = time.perf_counter() - t0
    tps = args.batch * args.gen / wall
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)
    decode_ms = 1e3 * times["decode_s"] / max(args.gen - 1, 1)
    print(f"[serve] {args.batch} requests x {args.gen} tokens "
          f"in {wall:.2f}s ({tps:.1f} tok/s)")
    print(f"[serve] {cfg.name} on {dev.type}: prefill {args.batch}x"
          f"{args.prompt_len} {1e3 * times['prefill_s']:.1f} ms, decode "
          f"{decode_ms:.2f} ms/token"
          + (f", peak {peak_gib:.2f} GiB" if peak_gib is not None else ""))
    print("sample continuation:", out[0][:12].tolist())
    return {"tokens": out, "wall_s": wall, "tok_per_s": tps,
            "prefill_ms": 1e3 * times["prefill_s"], "decode_ms_per_token": decode_ms,
            "peak_gib": peak_gib, "model": model, "batch": batch}


if __name__ == "__main__":
    main()
