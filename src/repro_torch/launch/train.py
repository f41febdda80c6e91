"""End-to-end training entry point (mirrors ``src/repro/launch/train.py``).

The reference's loop on one device: the deterministic, resumable
``TokenPipeline``, a train step (``train.make_train_step``: loss,
backward, AdamW), async atomic checkpoints in the reference's format
every ``--ckpt-every`` steps and at the end, resume from the latest one,
and the heartbeat and straggler hooks.  The weights are drawn on the
device from seed 0.  On the card every forward runs the port's kernels
(flash attention per attention layer; conv1d and the SSD per Mamba-2
layer), and the backward differentiates their plain versions.  Trains
every registered arch; the VLM's media and the enc-dec's frames are
zeros of the reference's shapes.  Any mesh other than 1x1 waits for the
distributed part of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --reduced --device cpu --steps 20 --ckpt-dir /tmp/ck --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --batch 4 --seq 1024 --steps 6        # full width, on the card
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.interop import load_train_state, train_state_tree
from repro_torch.launch.serve import stub_inputs
from repro_torch.models import build_model
from repro_torch.runtime import Heartbeat, StragglerDetector
from repro_torch.train import OptConfig, init_opt_state, make_train_step


def main(argv=None) -> dict:
    """Returns the first and last loss, every step's loss, the steps, the
    wall seconds, the median step ms after the first step, the peak GiB
    on the card (None on the CPU) and the trained model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data x model mesh; only 1x1 is ported")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: sharding across devices waits "
                                  f"for the distributed part of the port; use 1x1")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    model = build_model(cfg, device=args.device,
                        generator=torch.Generator(device=dev).manual_seed(0))
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    opt_state = init_opt_state(dict(model.named_parameters()))

    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum)

    start_step = 0
    store: Optional[CheckpointStore] = None
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir)
        if args.resume:
            hit = store.restore_latest(train_state_tree(cfg, model, opt_state))
            if hit is not None:
                start_step, tree, _ = hit
                opt_state = load_train_state(cfg, model, opt_state, tree)
                print(f"[resume] from step {start_step}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    hb = Heartbeat(["host0"])
    straggler = StragglerDetector()
    losses, step_s = [], []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in pipe.batch_at(step).items()}
        batch.update(stub_inputs(cfg, args.batch, dev))
        t0 = time.time()
        opt_state, metrics = step_fn(opt_state, batch)
        loss = float(metrics["loss"])             # waits for the step
        step_s.append(time.time() - t0)
        losses.append(loss)
        hb.beat("host0", step)
        straggler.observe_step({"host0": step_s[-1]})
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{step_s[-1]:.2f}s")
        if store and (step + 1) % args.ckpt_every == 0:
            store.save_async(step + 1, train_state_tree(cfg, model, opt_state),
                             extra={"data_step": step + 1})
    if store:
        store.wait()
        store.save(args.steps, train_state_tree(cfg, model, opt_state),
                   extra={"data_step": args.steps})
    wall = time.time() - t_start
    step_ms = 1e3 * statistics.median(step_s[1:]) if len(step_s) > 1 else None
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)
    if losses:
        print(f"[done] {args.steps - start_step} steps in {wall:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None, "losses": losses,
            "steps": args.steps, "wall_s": wall, "step_ms": step_ms,
            "peak_gib": peak_gib, "model": model}


if __name__ == "__main__":
    main()
