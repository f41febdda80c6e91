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
zeros of the reference's shapes.

``--mesh DxM`` trains on a (data, model) mesh under a process group of
D x M ranks, one process per mesh coordinate (``torchrun`` starts them;
its environment is read when no group exists yet): the model is built
with the mesh, its parameters placed by ``sharding.param_shardings``,
each rank fed its shard of the global batch (``sharding.shard_batch``),
and checkpoints saved whole and resumed onto the parameters' placements.
``--mesh 1x1`` is the one-device path, as the reference's is (it builds
its model without a mesh there).  ``--mesh DxM`` without D x M ranks
raises.  On the CPU the ranks run over gloo, on cards over NCCL, one card
per rank.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --reduced --device cpu --steps 20 --ckpt-dir /tmp/ck --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --batch 4 --seq 1024 --steps 6        # full width, on the card
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --mesh 2x2 --reduced --device cpu --steps 20      # 4 gloo ranks
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.interop import load_train_state, train_state_tree
from repro_torch.launch.mesh import BACKENDS, make_mesh
from repro_torch.launch.serve import stub_inputs
from repro_torch.models import build_model
from repro_torch.runtime import Heartbeat, StragglerDetector
from repro_torch.sharding import place_params, shard_batch
from repro_torch.train import OptConfig, init_opt_state, make_train_step


def build(cfg, device: torch.device, lr: float, steps: int, accum: int = 1, mesh=None):
    """(model, opt_state, train step): the weights drawn on ``device`` from
    seed 0 and, with a mesh, placed by ``param_shardings``."""
    model = build_model(cfg, device=str(device),
                        generator=torch.Generator(device=device).manual_seed(0), mesh=mesh)
    if mesh is not None:
        place_params(model, mesh)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    opt_state = init_opt_state(dict(model.named_parameters()))
    return model, opt_state, make_train_step(model, opt_cfg, accum_steps=accum, mesh=mesh)


def batch_at(pipe: TokenPipeline, step: int, cfg, device: torch.device, mesh=None) -> dict:
    """Step ``step``'s global batch on ``device`` (the same on every rank),
    with the stubbed modality inputs; with a mesh, sharded as DTensors."""
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in pipe.batch_at(step).items()}
    batch.update(stub_inputs(cfg, batch["tokens"].shape[0], device))
    return batch if mesh is None else shard_batch(batch, mesh)


def state_placements(tree):
    """The placements of a train-state tree's DTensor leaves (None for the
    others), for restoring a checkpoint onto them."""
    if isinstance(tree, dict):
        return {k: state_placements(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[state_placements(v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_placements(v) for v in tree)
    return list(tree.placements) if isinstance(tree, DTensor) else None


def _process_group(device_type: str) -> bool:
    """Start the default process group from ``torchrun``'s environment when
    none exists; True if started here (and so to be destroyed here)."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(BACKENDS[device_type])
    return True


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
                    help="DxM data x model mesh (needs D x M ranks)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    d, m = (int(x) for x in args.mesh.split("x"))
    started = d * m > 1 and _process_group(dev.type)
    try:
        mesh = None
        if d * m > 1:
            mesh = make_mesh((d, m), ("data", "model"), dev.type)
            if dev.type == "cuda":
                dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
                torch.cuda.set_device(dev)
        return _train(args, cfg, dev, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, dev: torch.device, mesh) -> dict:
    model, opt_state, step_fn = build(cfg, dev, args.lr, args.steps, args.accum, mesh)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    rank0 = mesh is None or dist.get_rank() == 0

    start_step = 0
    store: Optional[CheckpointStore] = None
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir)
        if args.resume:
            like = train_state_tree(cfg, model, opt_state)
            hit = store.restore_latest(like, state_placements(like), mesh)
            if hit is not None:
                start_step, tree, _ = hit
                opt_state = load_train_state(cfg, model, opt_state, tree)
                if rank0:
                    print(f"[resume] from step {start_step}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    hb = Heartbeat(["host0"])
    straggler = StragglerDetector()
    losses, step_s = [], []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = batch_at(pipe, step, cfg, dev, mesh)
        t0 = time.time()
        opt_state, metrics = step_fn(opt_state, batch)
        loss = float(metrics["loss"])             # waits for the step
        step_s.append(time.time() - t0)
        losses.append(loss)
        hb.beat("host0", step)
        straggler.observe_step({"host0": step_s[-1]})
        if rank0 and (step % args.log_every == 0 or step == args.steps - 1):
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
    if losses and rank0:
        print(f"[done] {args.steps - start_step} steps in {wall:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None, "losses": losses,
            "steps": args.steps, "wall_s": wall, "step_ms": step_ms,
            "peak_gib": peak_gib, "model": model}


if __name__ == "__main__":
    main()
