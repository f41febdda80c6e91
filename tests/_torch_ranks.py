"""Rank bodies for ``tests/test_torch_distributed.py``,
``tests/test_torch_moe_sharded.py``, ``tests/test_torch_mesh_serve.py``
and ``tests/test_torch_dryrun.py``.

``python tests/_torch_ranks.py CASE WORLD DIR`` starts WORLD processes
(``torch.multiprocessing``, spawn), each a rank of a gloo process group
that meets through a file in DIR, and runs ``CASES[CASE](rank, DIR)`` on
each.  The inputs a case needs, made by the test from a seed (and the
reference's values where a rank compares them), are in ``DIR/in.npz``;
each rank writes what it computed to ``DIR/out_<rank>.npz``.  The port
alone is imported here: the JAX package runs in the test's own process.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def _inputs(d):
    return dict(np.load(os.path.join(d, "in.npz")))


def _save(d, rank, **arrays):
    np.savez(os.path.join(d, f"out_{rank}.npz"),
             **{k: (v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in arrays.items()})


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _model(cfg, mesh, inp, prefix="sd/"):
    """The port's model of ``cfg`` on ``mesh`` holding the state dict in
    ``inp`` (keys ``prefix + name``), placed by ``param_shardings``."""
    from repro_torch.models import build_model
    from repro_torch.sharding import place_params
    model = build_model(cfg, device="cpu", mesh=mesh)
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in inp.items() if k.startswith(prefix)}
    model.load_state_dict(sd)
    return place_params(model, mesh)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def ring(rank, d):
    """ring_attention on (2, 4), causal and not, and its input gradients."""
    from repro_torch.distributed import ring_attention
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    inp, out = _inputs(d), {}
    w = torch.from_numpy(inp["w"])
    for causal in (True, False):
        q, k, v = (torch.from_numpy(inp[n]).requires_grad_() for n in "qkv")
        o = ring_attention(q, k, v, mesh, axis="model", causal=causal)
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        out[f"out_{causal}"] = o
        out.update({f"g{n}_{causal}": g for n, g in zip("qkv", grads)})
    _save(d, rank, **out)


def ring_model(rank, d):
    """Reduced starcoder2-3b's hidden states on (2, 4), ring and blockwise."""
    from repro_torch.sharding import shard_batch
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    inp = _inputs(d)
    cfg0 = reduced(get_config("starcoder2-3b")).replace(q_block=8, kv_block=8)
    toks = torch.from_numpy(inp["tokens"]).long()
    out = {"data_rank": mesh.get_local_rank("data")}
    for impl in ("blockwise", "ring"):
        model = _model(cfg0.replace(attn_impl=impl), mesh, inp)
        with torch.no_grad():
            h, _ = model.hidden(shard_batch({"tokens": toks, "labels": toks}, mesh))
        out[impl] = h
    _save(d, rank, **out)


def fsdp(rank, d):
    """Reduced olmo-1b's loss on (4, 2), the batches seen inside the blocks
    recorded, against the single-process value."""
    import repro_torch.models.lm as lm
    from repro_torch.distributed.collectives import batch_sum
    from repro_torch.sharding import shard_batch
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    inp = _inputs(d)
    seen = []
    real = lm.apply_tblock

    def spy(p, x, cfg, mesh=None, global_batch=None):
        seen.append(x.shape[0])
        y, aux = real(p, x, cfg, mesh, global_batch)
        seen.append(y.shape[0])
        return y, aux

    lm.apply_tblock = spy
    try:
        model = _model(reduced(get_config("olmo-1b")), mesh, inp)
        batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens", "labels")}
        with torch.no_grad():
            loss, _ = model.loss(shard_batch(batch, mesh))
    finally:
        lm.apply_tblock = real
    _save(d, rank, loss=batch_sum(loss, mesh), seen=np.array(seen))


def pipeline(rank, d):
    """pipeline_apply over 4 stages, and the gradients of its output."""
    from repro_torch.distributed import pipeline_apply
    mesh = make_mesh((4,), ("stage",), "cpu")
    inp = _inputs(d)
    W = torch.from_numpy(inp["W"]).requires_grad_()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    out = pipeline_apply(lambda w, x: torch.tanh(x @ w), W, x, mesh)
    gW, gx = torch.autograd.grad((out * torch.from_numpy(inp["w"])).sum(), (W, x),
                                 allow_unused=True, materialize_grads=True)
    _save(d, rank, out=out, gW=gW, gx=gx, stage=mesh.get_local_rank("stage"))


def compression(rank, d):
    """pod_compressed_mean and ef_compressed_mean of a gradient every rank
    holds alike on (2, 2, 2); and this rank's slice of a batch laid out
    over (pod, data)."""
    from repro_torch.distributed import ef_compressed_mean, pod_compressed_mean
    from repro_torch.sharding import shard_batch
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    inp = _inputs(d)
    g = {"w": torch.from_numpy(inp["g"])}
    gm = pod_compressed_mean(g, mesh)
    r0 = {"w": torch.zeros_like(g["w"])}
    gm2, r1 = ef_compressed_mean(g, r0, mesh)
    local = shard_batch({"x": torch.from_numpy(inp["batch"])}, mesh)["x"].to_local()
    coords = [mesh.get_local_rank(a) for a in ("pod", "data", "model")]
    _save(d, rank, pod=gm["w"], ef=gm2["w"], resid=r1["w"], local=local,
          coords=np.array(coords))


def checkpoint(rank, d):
    """A DTensor state saved on (2, 2), restored on (4, 1) and onto the
    (2, 2) placements again."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.checkpoint import CheckpointStore
    inp = _inputs(d)
    full = {k: torch.from_numpy(inp[k]) for k in ("a", "b")}
    m22 = make_mesh((2, 2), ("data", "model"), "cpu")
    state = {"a": distribute_tensor(full["a"], m22, [Shard(0), Shard(1)], src_data_rank=None),
             "b": distribute_tensor(full["b"], m22, [Replicate(), Shard(0)], src_data_rank=None),
             "n": torch.tensor(7)}
    store = CheckpointStore(os.path.join(d, "ck"))
    store.save(3, state, extra={"data_step": 3})
    m41 = make_mesh((4, 1), ("data", "model"), "cpu")
    pl = {"a": [Shard(1), Replicate()], "b": [Shard(0), Replicate()], "n": None}
    got, extra = store.restore(3, state, pl, m41)
    again = store.restore_latest(state, {k: (list(v.placements) if k != "n" else None)
                                         for k, v in state.items()}, m22)
    assert again[0] == 3 and extra == {"data_step": 3}
    assert got["a"].placements == (Shard(1), Replicate())
    _save(d, rank, a41=got["a"].full_tensor(), b41=got["b"].full_tensor(),
          a_local=got["a"].to_local(), a22=again[1]["a"].full_tensor(),
          b22_local=again[1]["b"].to_local(), b22_want=state["b"].to_local(), n=got["n"])


def _train_step(cfg, mesh, inp, compress=False, pod_mesh=None):
    """One train step of ``cfg`` on ``mesh`` from the state dict in ``inp``;
    returns the metrics, the gradients AdamW received and the parameters
    after the step, whole."""
    import repro_torch.train.step as tstep
    from repro_torch.sharding import shard_batch
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    model = _model(cfg, mesh, inp)
    seen = {}
    real = tstep.adamw_update

    def capture(opt_cfg, grads, state, params, ndims=None):
        seen.update({k: _whole(g).clone() for k, g in grads.items()})
        return real(opt_cfg, grads, state, params, ndims)

    tstep.adamw_update = capture
    try:
        step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=2, total_steps=10),
                               compress_pod_grads=compress, mesh=pod_mesh)
        batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens", "labels")}
        _, metrics = step(init_opt_state(dict(model.named_parameters())),
                          shard_batch(batch, mesh))
    finally:
        tstep.adamw_update = real
    params = {k: _whole(p).detach() for k, p in model.named_parameters()}
    return metrics, seen, params


def train(rank, d):
    """One train step on (2, 2) of the arch named in ``in.npz``."""
    inp = _inputs(d)
    cfg = reduced(get_config(str(inp["arch"])))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    metrics, grads, params = _train_step(cfg, mesh, inp)
    _save(d, rank, loss=metrics["loss"], grad_norm=metrics["grad_norm"],
          ce=metrics["ce"], aux=metrics["aux"],
          **{f"g/{k}": v for k, v in grads.items()}, **{f"p/{k}": v for k, v in params.items()})


def compress(rank, d):
    """One olmo-1b train step on a (2, 1, 2) pod mesh with and without
    compress_pod_grads."""
    inp = _inputs(d)
    cfg = reduced(get_config("olmo-1b"))
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    out = {}
    for on in (False, True):
        metrics, grads, _ = _train_step(cfg, mesh, inp, compress=on, pod_mesh=mesh)
        out[f"loss_{on}"] = metrics["loss"]
        out.update({f"g{int(on)}/{k}": v for k, v in grads.items()})
    _save(d, rank, **out)


def launch(rank, d):
    """launch.train --mesh 2x2 for 3 steps; then 2 steps with a checkpoint
    and a resume to the third."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--mesh", "2x2",
            "--batch", "8", "--seq", "32", "--log-every", "1"]
    straight = ttrain.main(argv + ["--steps", "3"])["losses"]
    ck = ["--ckpt-dir", os.path.join(d, "ck"), "--ckpt-every", "1"]
    first = ttrain.main(argv + ["--steps", "2"] + ck)["losses"]
    resumed = ttrain.main(argv + ["--steps", "3", "--resume"] + ck)["losses"]
    _save(d, rank, straight=np.array(straight), first=np.array(first),
          resumed=np.array(resumed))


def one_rank(rank, d):
    """Three steps of launch.train's functions on a (1, 1) mesh and without
    one, for the archs named in ``in.npz``: losses and parameters."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as ttrain
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    out = {}
    for arch in _inputs(d)["archs"]:
        cfg = reduced(get_config(str(arch))).replace(remat="block")
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
        for tag, m in (("one", None), ("mesh", mesh)):
            model, state, step = ttrain.build(cfg, torch.device("cpu"), 3e-3, 10, mesh=m)
            losses = []
            for i in range(3):
                state, met = step(state, ttrain.batch_at(pipe, i, cfg, torch.device("cpu"), m))
                losses.append(float(met["loss"]))
            out[f"{arch}/{tag}/losses"] = np.array(losses)
            out.update({f"{arch}/{tag}/p/{k}": _whole(p).detach()
                        for k, p in model.named_parameters()})
    _save(d, rank, **out)


# ---------------------------------------------------------------------------
# the sharded MoE dispatch (tests/test_torch_moe_sharded.py)
# ---------------------------------------------------------------------------

MOE_SCHEDULES = ("2d", "ep_tp", "2d_dshard")


def _moe_params(inp, tag, mesh):
    """The MoE weights ``tag/<name>`` of ``in.npz`` as DTensor leaves laid
    out by the default rules."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.rules import placements, resolve_spec
    axes = {"router": ("embed", "expert"), "w_gate": ("expert", "embed", "ff"),
            "w_up": ("expert", "embed", "ff"), "w_down": ("expert", "ff", "embed")}
    out = {}
    for n, ax in axes.items():
        full = torch.from_numpy(inp[f"{tag}/{n}"])
        pl = placements(resolve_spec(tuple(full.shape), ax, mesh), mesh)
        out[n] = distribute_tensor(full, mesh, pl, src_data_rank=None).requires_grad_()
    return out


def _generate(model, batch, n):
    """Greedy: the prefill's last logits, and those of ``n - 1`` decode
    steps, each fed the previous argmax; and the argmax tokens."""
    logits, cache = model.prefill(batch, max_len=batch["tokens"].shape[1] + n)
    steps, toks = [logits], [logits.argmax(-1)]
    for _ in range(n - 1):
        logits, cache = model.decode_step(toks[-1], cache)
        steps.append(logits)
        toks.append(logits.argmax(-1))
    return torch.stack(steps, 1), torch.stack(toks, 1)


def moe_fn(rank, d):
    """On (4, 2): apply_moe_sharded per (schedule, capacity factor) with
    the gradients of sum(y^2) + aux and each dispatch's slots; the S = 1
    case; then the reduced granite (moe_impl="sharded") per schedule:
    the prefill's logits, one decode step's and the loss."""
    from repro_torch.distributed.collectives import batch_sum
    from repro_torch.models.moe import apply_moe_sharded, route_log
    from repro_torch.sharding import shard_batch
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    inp, out = _inputs(d), {}
    E, k = int(inp["E"]), int(inp["k"])
    rows = slice(2 * mesh.get_local_rank("data"), 2 * mesh.get_local_rank("data") + 2)
    for sched in MOE_SCHEDULES:
        tag = "ds" if sched == "2d_dshard" else "f"
        for cf in inp["cfs"]:
            p = _moe_params(inp, tag, mesh)
            x = torch.from_numpy(inp["x"][rows]).requires_grad_()
            with route_log() as log:
                y, aux = apply_moe_sharded(p, x, k, E, mesh, capacity_factor=float(cf),
                                           schedule=sched)
            ((y ** 2).sum() + aux).backward()
            key = f"{sched}/{cf:g}"
            out.update({f"{key}/y": y, f"{key}/aux": batch_sum(aux, mesh), f"{key}/gx": x.grad,
                        f"{key}/slot": log[0]["slot"], f"{key}/keep": log[0]["keep"],
                        **{f"{key}/g_{n}": t.grad.full_tensor() for n, t in p.items()}})
        with torch.no_grad():
            y1, _ = apply_moe_sharded(_moe_params(inp, tag, mesh),
                                      torch.from_numpy(inp["x1"][rows]), k, E, mesh,
                                      capacity_factor=E / k, schedule=sched)
        out[f"{sched}/y1"] = y1
    toks = torch.from_numpy(inp["tokens"]).long()
    base = reduced(get_config("granite-moe-1b-a400m")).replace(moe_impl="sharded")
    for sched in MOE_SCHEDULES:
        model = _model(base.replace(moe_schedule=sched), mesh, inp)
        logits, tokens = _generate(model, shard_batch({"tokens": toks}, mesh), 2)
        with torch.no_grad():
            loss, metrics = model.loss(shard_batch({"tokens": toks, "labels": toks}, mesh))
        out.update({f"{sched}/logits": logits, f"{sched}/tokens": tokens,
                    f"{sched}/loss": batch_sum(loss, mesh),
                    f"{sched}/aux_model": batch_sum(metrics["aux"], mesh)})
    _save(d, rank, data_rank=mesh.get_local_rank("data"), **out)


def moe_train(rank, d):
    """One train step of the reduced granite (moe_impl="sharded") on
    (2, 2) per schedule: the loss and the gradients AdamW received."""
    inp = _inputs(d)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    base = reduced(get_config("granite-moe-1b-a400m")).replace(moe_impl="sharded")
    out = {}
    for sched in MOE_SCHEDULES:
        metrics, grads, _ = _train_step(base.replace(moe_schedule=sched), mesh, inp)
        out[f"{sched}/loss"] = metrics["loss"]
        out.update({f"{sched}/g/{k}": v for k, v in grads.items()})
    _save(d, rank, **out)


def moe_one(rank, d):
    """The reduced granite (moe_impl="sharded") on a (1, 1) mesh: the
    prefill's logits and the loss of the batches in ``in.npz``."""
    from repro_torch.sharding import shard_batch
    inp = _inputs(d)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    model = _model(reduced(get_config("granite-moe-1b-a400m")).replace(moe_impl="sharded"),
                   mesh, inp)
    out = {}
    for key in inp["cases"]:
        toks = torch.from_numpy(inp[f"{key}/tokens"]).long()
        batch = shard_batch({"tokens": toks, "labels": toks}, mesh)
        with torch.no_grad():
            logits, _ = model.prefill(batch)
            loss, _ = model.loss(batch)
        out.update({f"{key}/logits": logits, f"{key}/loss": loss})
    _save(d, rank, **out)


# ---------------------------------------------------------------------------
# serving on a mesh (tests/test_torch_mesh_serve.py)
# ---------------------------------------------------------------------------

def mesh_serve(rank, d):
    """On (2, 2), per arch named in ``in.npz``: the prefill's logits and one
    decode step's (``_generate``, fed this rank's rows as plain tensors),
    and three greedy tokens through ``serve.generate`` (fed the batch as
    DTensors), for this rank's rows."""
    from repro_torch.serve import generate
    from repro_torch.sharding import shard_batch
    inp = _inputs(d)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {"data_rank": mesh.get_local_rank("data")}
    for arch in inp["archs"]:
        arch = str(arch)
        model = _model(reduced(get_config(arch)), mesh, inp, prefix=f"{arch}/sd/")
        batch = shard_batch({k.split("/", 2)[2]: torch.from_numpy(v)
                             for k, v in inp.items() if k.startswith(f"{arch}/in/")}, mesh)
        logits, _ = _generate(model, {k: v.to_local() for k, v in batch.items()}, 2)
        out[f"{arch}/logits"] = logits
        out[f"{arch}/tokens"] = generate(model, batch, 3)      # the DTensor batch
    _save(d, rank, **out)


# ---------------------------------------------------------------------------
# the dry run's counters on real ranks (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------

def dryrun_gloo(rank, d):
    """``launch.dryrun.measure`` on a real (2, 2) mesh for the reduced
    cells named in ``in.npz``: per-rank bytes, FLOPs and collectives."""
    import json
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import measure
    inp = _inputs(d)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for cell in json.loads(str(inp["cells"])):
        cfg = reduced(get_config(cell["arch"])).replace(**cell["cfg"])
        res = measure(cfg, ShapeSpec(**cell["shape"]), mesh, torch.device("cpu"))
        out[cell["name"]] = json.dumps(res)
    _save(d, rank, **out)


CASES = {f.__name__: f for f in (ring, ring_model, fsdp, pipeline, compression,
                                 checkpoint, train, compress, launch, one_rank,
                                 moe_fn, moe_train, moe_one, mesh_serve, dryrun_gloo)}


def _entry(rank, case, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'pg')}",
                            rank=rank, world_size=world)
    try:
        CASES[case](rank, d)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, world, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_entry, args=(case, world, d), nprocs=world, join=True)
