"""Multi-pod dry run: one rank's view of every (arch x shape x mesh) cell
(mirrors ``src/repro/launch/dryrun.py``).

For each cell of ``SHAPES`` this builds, in one process and with no
card, what rank 0 of the production mesh, (16, 16) or (2, 16, 16) with
``--multi-pod``, holds and runs:

* a ``fake`` process group of 256 or 512 ranks (``FakeStore``: every
  collective returns at once) and the mesh on it;
* the model on the ``meta`` device, its parameters DTensors placed by
  ``sharding.rules_for``: shapes and dtypes, no memory;
* the batch, and for decode the cache, as rank 0's shards (the
  counterpart of the reference's ``input_specs`` and ``cache_specs``);
* then the real step: ``train_step`` (forward, backward and AdamW),
  ``prefill`` or ``decode_step``.  On ``meta`` every kernel entry point
  takes its plain version (``kernels.autograd.PLAIN_DEVICES``).

Each cell records exact per-rank argument bytes (parameters, float32
moments, batch, cache), the parameter count, per-rank matmul FLOPs from
``FlopCounterMode`` beside ``models.accounting.model_flops`` over the
ranks, collective counts and operand bytes by kind (:class:`CommCounter`)
and the wall seconds.  Temp and activation bytes need a compiler and are
recorded as null.  The reference compiles each cell and parses its HLO
(``launch/hlo_analysis.py``); here the counters read the step as it runs,
so :func:`measure` gives the same counts on a real mesh of gloo ranks,
which is how the tests hold the fake run to a real one.

  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes

Results go to ``build/dryrun/<mesh>/<arch>__<shape>.json``; a cell whose
file exists is skipped unless ``--force``.  A cell that errors is
recorded with its error, and the command exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import build_model
from repro_torch.models.accounting import param_counts, model_flops
from repro_torch.sharding import place_params, shard_batch
from repro_torch.sharding.rules import BATCH_AXES, rules_for
from repro_torch.train import OptConfig, init_opt_state, make_train_step

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "send/recv",
         "broadcast")
_KIND_OF = (("allgather", "all-gather"), ("all_gather", "all-gather"),
            ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"), ("alltoall", "all-to-all"),
            ("all_to_all", "all-to-all"), ("broadcast", "broadcast"))


def _kind(func) -> Optional[str]:
    """The collective kind of a c10d or functional-collective op, or None
    (a receive counts with its send, a wait is no collective)."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd"):
        return None
    name = func._overloadpacket.__name__
    if name == "send":
        return "send/recv"
    for key, kind in _KIND_OF:
        if key in name:
            return kind
    return None


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


class CommCounter(CommDebugMode):
    """``CommDebugMode``'s collectives, plus point-to-point sends, which it
    does not count, each with the bytes of its input operand on this rank
    (a send's tensor), by kind: ``counts`` and ``bytes``.  DTensor's own
    redistributions are counted as the collectives they run."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (not any(t is DTensor for t in types)
                and not isinstance(func, torch._ops.HigherOrderOperator)):
            kind = _kind(func)
            if kind is not None:
                schema = func._schema.arguments
                names = [a.name for a in schema]
                pick = next((i for i, n in enumerate(names) if n.startswith("input")),
                            names.index("tensors") if "tensors" in names else 0)
                operand = args[pick] if pick < len(args) else (kwargs or {}).get(names[pick])
                self.counts[kind] += 1
                self.bytes[kind] += _tensor_bytes(operand)
        return super().__torch_dispatch__(func, types, args, kwargs)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh: (16, 16) ``("data",
    "model")``, or (2, 16, 16) with a ``pod`` axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def fake_mesh(shape, axes):
    """A ``shape`` mesh named ``axes`` on a ``fake`` process group of as
    many ranks, this process rank 0; the group is started here if none
    of that size is."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _local_bytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _batch_shards(mesh) -> int:
    return math.prod(mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)
                     if n in BATCH_AXES)


def global_batch(cfg: ModelConfig, shape: ShapeSpec, device) -> Dict[str, torch.Tensor]:
    """The step's global batch (zeros): tokens (and labels for training)
    for train and prefill, the modality inputs of a VLM or an enc-dec
    model in the parameters' dtype (the reference's ``input_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    batch: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        batch["tokens"] = torch.zeros((B, S), dtype=torch.long, device=device)
        if shape.kind == "train":
            batch["labels"] = torch.zeros((B, S), dtype=torch.long, device=device)
    if cfg.family == "vlm":
        batch["media"] = torch.zeros((B, cfg.n_media_tokens, cfg.d_model), dtype=dtype,
                                     device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((B, cfg.n_frames, cfg.d_model), dtype=dtype,
                                      device=device)
    return batch


def measure(cfg: ModelConfig, shape: ShapeSpec, mesh, device) -> Dict[str, Any]:
    """Build ``cfg`` on ``device`` with ``mesh``, place its parameters by
    ``rules_for``, run ``shape``'s step on this rank's shards under the
    counters, and return the per-rank bytes, FLOPs and collectives.  On
    ``meta`` with a fake group this is the dry run; on a real group the
    same step computes (with zero weights)."""
    model = build_model(cfg, device=str(device), mesh=mesh,
                        generator=None if str(device) == "meta"
                        else torch.Generator(device=device).manual_seed(0))
    place_params(model, mesh, rules_for(cfg, mesh))
    params = dict(model.named_parameters())
    batch = shard_batch(global_batch(cfg, shape, device), mesh)
    mem = {"param_bytes": sum(_local_bytes(p) for p in params.values()),
           "opt_bytes": 0, "cache_bytes": 0,
           "batch_bytes": sum(_local_bytes(v) for v in batch.values())}
    flops, comms = FlopCounterMode(display=False), CommCounter()
    if shape.kind == "train":
        opt = init_opt_state(params)
        mem["opt_bytes"] = sum(_local_bytes(m) for m in (*opt.mu.values(), *opt.nu.values()))
        step = make_train_step(model, OptConfig())
        with flops, comms:
            step(opt, batch)
    elif shape.kind == "prefill":
        with flops, comms:
            model.prefill(batch)
    else:                           # decode: one new token against a seq_len cache
        B = shape.global_batch
        n = _batch_shards(mesh)
        local_b = B // n if B % n == 0 else B
        cache = model.init_cache(local_b, shape.seq_len)
        tokens = torch.zeros((local_b,), dtype=torch.long, device=device)
        mem["cache_bytes"] = sum(_local_bytes(v) for v in cache.values())
        mem["batch_bytes"] = _local_bytes(tokens)
        with flops, comms:
            model.decode_step(tokens, cache)
    mem["argument_bytes"] = sum(mem.values())
    mem["temp_bytes"] = None
    return {"memory": mem,
            "n_params": sum(p.numel() for p in params.values()),
            "n_local_params": sum(_local(p).numel() for p in params.values()),
            "matmul_flops": flops.get_total_flops(),
            "collective_count": {k: comms.counts.get(k, 0) for k in KINDS},
            "collective_bytes": {k: comms.bytes.get(k, 0) for k in KINDS}}


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               cfg_override: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """One cell: ``skipped`` where ``cell_applicable`` says so, else the
    per-rank record of :func:`measure` on the fake production mesh."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    t0 = time.time()
    mesh = fake_mesh(*production_shape(multi_pod))
    n_dev = mesh.size()
    res = measure(cfg, shape, mesh, torch.device("meta"))
    mf = model_flops(cfg, shape)
    counts = param_counts(cfg)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", "n_devices": n_dev,
            **res,
            "model_flops_per_device": mf["model_flops"] / n_dev,
            "accounting_params": counts["total"],
            "wall_s": time.time() - t0}


def run(archs, shapes, multi_pod: bool, force: bool = False,
        out_dir: Optional[pathlib.Path] = None) -> int:
    """Every cell of ``archs`` x ``shapes`` on one mesh, each written to
    its own JSON file; returns the number of cells that errored."""
    out_dir = out_dir or OUT_DIR
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    (out_dir / mesh_tag).mkdir(parents=True, exist_ok=True)
    errors = 0
    for arch in archs:
        for shape_name in shapes:
            path = out_dir / mesh_tag / f"{arch}__{shape_name}.json"
            if path.exists() and not force:
                print(f"[skip] {arch} x {shape_name} ({mesh_tag}) cached")
                continue
            print(f"[cell] {arch} x {shape_name} ({mesh_tag}) ...", flush=True)
            try:
                res = lower_cell(arch, shape_name, multi_pod)
            except Exception as e:  # noqa: BLE001 -- recorded, and counted
                errors += 1
                res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
            path.write_text(json.dumps(res, indent=2))
            if "skipped" in res:
                print(f"  skipped: {res['skipped']}", flush=True)
            elif "error" not in res:
                mem = res["memory"]
                print(f"  ok: {res['wall_s']:.1f}s  args/dev {mem['argument_bytes'] / 1e9:.2f} GB"
                      f"  flops/dev {res['matmul_flops']:.3e}"
                      f"  coll {sum(res['collective_count'].values())}"
                      f" ({sum(res['collective_bytes'].values()) / 1e9:.2f} GB)", flush=True)
    return errors


def summary(out_dir: Optional[pathlib.Path] = None) -> str:
    """A markdown table of the cells recorded under ``out_dir``: a row per
    arch, a column per shape, each cell "per-rank argument GB / matmul
    TFLOP / collective GB / wall s" on (16, 16), then on (2, 16, 16)."""
    out_dir = out_dir or OUT_DIR
    rows = ["| Arch | " + " | ".join(SHAPES) + " |", "| --- |" + " --- |" * len(SHAPES)]
    for arch in ARCHS:
        cells = []
        for shape in SHAPES:
            parts = []
            for mesh_tag in ("16x16", "2x16x16"):
                path = out_dir / mesh_tag / f"{arch}__{shape}.json"
                c = json.loads(path.read_text()) if path.exists() else {"error": "not run"}
                if "skipped" in c or "error" in c:
                    parts.append("skipped" if "skipped" in c else "error")
                    continue
                parts.append(f"{c['memory']['argument_bytes'] / 1e9:.3g}/"
                             f"{c['matmul_flops'] / 1e12:.4g}/"
                             f"{sum(c['collective_bytes'].values()) / 1e9:.3g}/"
                             f"{c['wall_s']:.1f}")
            cells.append(parts[0] if parts[0] == parts[1] == "skipped" else "; ".join(parts))
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS, help="single arch id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES), help="single shape id")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=None, help=f"default {OUT_DIR}")
    ap.add_argument("--summary", action="store_true",
                    help="print a table of the recorded cells and run none")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    out = pathlib.Path(args.out_dir) if args.out_dir else None
    if args.summary:
        print(summary(out))
        return 0
    pods = (False, True) if args.both_meshes else (args.multi_pod,)
    try:
        errors = sum(run(archs, shapes, multi_pod=p, force=args.force, out_dir=out)
                     for p in pods)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
