"""The port's mesh path on gloo ranks, against the JAX package and the
single-process port on the CPU: ring attention, the pipeline, gradient
compression, the batch constraint, a batch's layout over (pod, data), a
checkpoint restored onto another mesh, whole train steps on a (2, 2)
mesh, pod compression inside a train step, and ``launch.train --mesh``.

Each multi-rank case runs in a subprocess of its own (``tests/_torch_ranks.py``)
with its own timeout, so this process never starts a process group; the
reference's values are computed here, on one device, and handed over
through a file.  The reference's own tests (``tests/test_distributed.py``)
hold its mesh functions equal to those one-device functions.

Tolerances are the reference's: ring attention 1e-5 (its gradient too),
the ring through the model 1e-4, the pipeline 1e-6, the compression
bound ``max|g| / 127 + 1e-7``.  A train step on a mesh computes the
single-process function in another summation order (per batch shard,
then summed), so losses, gradients and parameters agree to float32
rounding: 1e-5 of each leaf's largest, as in ``tests/test_torch_train.py``.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro.models.attention import AttnConfig, naive_attention
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.train.optim import first_step_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "_torch_ranks.py")
TIMEOUT = 300           # seconds per multi-rank case; each takes 10-40 here
RTOL = 1e-5             # of each leaf's largest (module docstring)


def _ranks(case: str, world: int, tmp_path, **inputs) -> list:
    """Run ``case`` on ``world`` gloo ranks; each rank's outputs.  The
    ranks are killed with their launcher if the case outlives TIMEOUT."""
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, RANKS, case, str(world), str(tmp_path)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{case} on {world} ranks outlived {TIMEOUT} s")
    assert proc.returncode == 0, err[-4000:]
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(world)]


def _near(got, want, rtol=RTOL):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _reference(arch: str):
    """The reference's reduced model of ``arch``, its seed-0 parameters
    (numpy) and the port's state dict holding them."""
    jm = jax_build_model(jax_reduced(jax_get_config(arch)))
    params = jax.tree_util.tree_map(np.asarray, unbox(jm.init(jax.random.PRNGKey(0))))
    sd = params_from_reference(reduced(get_config(arch)), params)
    return jm, params, sd


def _state_inputs(sd) -> dict:
    return {f"sd/{k}": v.numpy() for k, v in sd.items()}


def _batch(vocab: int, B: int, S: int, seed: int) -> dict:
    """Tokens and labels; a quarter of the labels masked, and more in the
    first half of the rows, so the batch shards hold different counts."""
    rng = np.random.default_rng(seed)
    data = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    data["labels"][:, ::4] = -1
    data["labels"][:B // 2, 1::4] = -1
    return data


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def test_ring_attention_matches_dense(tmp_path):
    """(2, 4) mesh, causal and not: every rank's output against the
    reference's ``naive_attention``, and the gradients of a weighted sum
    against ``jax.grad`` of the same, within 1e-5."""
    rng = np.random.default_rng(0)
    B, S, H, KV, Dh = 2, 32, 4, 2, 16
    qkv = {"q": rng.standard_normal((B, S, H, Dh)), "k": rng.standard_normal((B, S, KV, Dh)),
           "v": rng.standard_normal((B, S, KV, Dh))}
    qkv = {k: v.astype(np.float32) for k, v in qkv.items()}
    w = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    outs = _ranks("ring", 8, tmp_path, w=w, **qkv)
    for causal in (True, False):
        cfg = AttnConfig(d_model=H * Dh, n_heads=H, n_kv_heads=KV, head_dim=Dh,
                         rope_theta=0, causal=causal)
        ref = naive_attention(*(jnp.asarray(qkv[n]) for n in "qkv"), cfg)
        grads = jax.grad(lambda q, k, v: jnp.sum(naive_attention(q, k, v, cfg) * w),
                         argnums=(0, 1, 2))(*(jnp.asarray(qkv[n]) for n in "qkv"))
        for out in outs:
            assert np.abs(out[f"out_{causal}"] - np.asarray(ref)).max() < 1e-5
            for n, g in zip("qkv", grads):
                assert np.abs(out[f"g{n}_{causal}"] - np.asarray(g)).max() < 1e-5, (n, causal)


def test_ring_attention_model_integration(tmp_path):
    """attn_impl='ring' (starcoder2's default) equals blockwise through the
    whole model on a (2, 4) mesh within 1e-4, and both equal the
    reference's hidden states on each rank's rows."""
    cfg = reduced(get_config("starcoder2-3b"))
    jm0 = jax_build_model(jax_reduced(jax_get_config("starcoder2-3b")).replace(
        q_block=8, kv_block=8))
    params = jax.tree_util.tree_map(np.asarray, unbox(jm0.init(jax.random.PRNGKey(0))))
    sd = params_from_reference(cfg, params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    want, _ = jm0.hidden(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    want = np.asarray(want)
    for out in _ranks("ring_model", 8, tmp_path, tokens=toks, **_state_inputs(sd)):
        rows = slice(2 * int(out["data_rank"]), 2 * int(out["data_rank"]) + 2)
        assert np.abs(out["ring"] - out["blockwise"]).max() < 1e-4
        for impl in ("ring", "blockwise"):
            assert np.abs(out[impl] - want[rows]).max() < 1e-4


# ---------------------------------------------------------------------------
# the pipeline, compression, the batch layout
# ---------------------------------------------------------------------------

def test_pipeline_matches_sequential(tmp_path):
    """4 stages over 6 microbatches against the stages applied in turn,
    within 1e-6 on every rank; the gradients of a weighted sum of the
    output against the sequential ones (each stage's weight on its rank)."""
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32)
    x = rng.standard_normal((6, 3, 8)).astype(np.float32)
    w = rng.standard_normal((6, 3, 8)).astype(np.float32)
    Wt, xt = torch.from_numpy(W).requires_grad_(), torch.from_numpy(x).requires_grad_()
    seq = xt
    for i in range(4):
        seq = torch.tanh(seq @ Wt[i])
    gW, gx = torch.autograd.grad((seq * torch.from_numpy(w)).sum(), (Wt, xt))
    for out in _ranks("pipeline", 4, tmp_path, W=W, x=x, w=w):
        assert np.abs(out["out"] - seq.detach().numpy()).max() < 1e-6
        s = int(out["stage"])
        assert np.abs(out["gW"][s] - gW[s].numpy()).max() < 1e-5
        assert not out["gW"][np.arange(4) != s].any()
        if s == 0:
            assert np.abs(out["gx"] - gx.numpy()).max() < 1e-5


def _devices_indices(shape, mesh_shape, axes, spec) -> dict:
    """The reference's ``devices_indices_map`` of a ``spec`` layout, per mesh
    coordinate (a JAX subprocess with as many host devices)."""
    n = int(np.prod(mesh_shape))
    code = textwrap.dedent(f"""
        import os, json, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
        sys.path.insert(0, "src")
        import numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.launch.mesh import make_mesh
        mesh = make_mesh({tuple(mesh_shape)}, {tuple(axes)})
        idx = NamedSharding(mesh, P(*{spec!r})).devices_indices_map({tuple(shape)})
        out = {{}}
        for coord in np.ndindex(*mesh.devices.shape):
            sl = idx[mesh.devices[coord]]
            out[",".join(map(str, coord))] = [[s.start, s.stop] for s in sl]
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def compression_run(tmp_path_factory):
    """The (2, 2, 2) case, run once for the two tests that read it."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 32)).astype(np.float32)
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    return g, batch, _ranks("compression", 8, tmp_path_factory.mktemp("compression"),
                            g=g, batch=batch)


def test_compression_bounds_and_ef(compression_run):
    """A gradient every rank holds alike: its compressed mean over ``pod``
    is within the quantization step ``max|g| / 127 + 1e-7``, and with error
    feedback the mean sent plus the residual is the gradient."""
    g, _, outs = compression_run
    bound = np.abs(g).max() / 127 + 1e-7
    for out in outs:
        assert np.abs(out["pod"] - g).max() <= bound
        np.testing.assert_allclose(out["ef"] + out["resid"], g, rtol=1e-5, atol=1e-6)
        assert np.array_equal(out["ef"], outs[0]["ef"])


def test_batch_over_pod_and_data_is_the_reference_layout(compression_run):
    """A batch split over ``("pod", "data")`` on a (2, 2, 2) mesh: each
    rank's local rows are the slice the reference's ``NamedSharding``
    gives the device at the same mesh coordinate (pod-major)."""
    _, batch, outs = compression_run
    idx = _devices_indices(batch.shape, (2, 2, 2), ("pod", "data", "model"),
                           (("pod", "data"),))
    for out in outs:
        (r0, r1), _ = idx[",".join(str(int(c)) for c in out["coords"])]
        np.testing.assert_array_equal(out["local"], batch[r0:r1])


def test_fsdp_constraint_keeps_batch_sharded(tmp_path):
    """(4, 2) mesh, reduced olmo-1b: the loss summed over the batch shards
    equals the single-process port's and the reference's within 1e-5, and
    every block takes and returns activations of the local batch (2 of 8
    rows)."""
    jm, params, sd = _reference("olmo-1b")
    data = _batch(256, 8, 32, seed=1)
    want, _ = jm.loss(params, {k: jnp.asarray(v) for k, v in data.items()})
    model = build_model(reduced(get_config("olmo-1b")), device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        port, _ = model.loss({k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(float(port), float(want), rtol=1e-5)
    for out in _ranks("fsdp", 8, tmp_path, **data, **_state_inputs(sd)):
        np.testing.assert_allclose(float(out["loss"]), float(port), rtol=1e-5)
        assert out["seen"].size == 2 * 2 and set(out["seen"].tolist()) == {2}


def test_checkpoint_reshard_on_load(tmp_path):
    """DTensor leaves saved on (2, 2), once, in the reference's format:
    restored on (4, 1) with other placements, onto the (2, 2) placements
    again, and whole on one process, all equal."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal((4, 10)).astype(np.float32)
    outs = _ranks("checkpoint", 4, tmp_path, a=a, b=b)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["a41"], a)
        np.testing.assert_array_equal(out["b41"], b)
        np.testing.assert_array_equal(out["a_local"], a[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["a22"], a)
        np.testing.assert_array_equal(out["b22_local"], out["b22_want"])
        assert int(out["n"]) == 7
    store = CheckpointStore(str(tmp_path / "ck"))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_3"]
    like = {"a": torch.zeros(8, 8), "b": torch.zeros(4, 10), "n": torch.zeros((), dtype=torch.int64)}
    got, extra = store.restore(3, like)
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["b"].numpy(), b)
    assert extra == {"data_step": 3}


# ---------------------------------------------------------------------------
# train steps on a mesh
# ---------------------------------------------------------------------------

def _one_step(arch, sd, data, **kw):
    """The single-process port's train step: metrics, the gradients AdamW
    received, the parameters after."""
    import repro_torch.train.step as tstep
    model = build_model(reduced(get_config(arch)), device="cpu")
    model.load_state_dict(sd)
    seen = {}
    real = tstep.adamw_update

    def capture(opt_cfg, grads, state, params, ndims=None):
        seen.update({k: g.clone() for k, g in grads.items()})
        return real(opt_cfg, grads, state, params, ndims)

    tstep.adamw_update = capture
    try:
        step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=2, total_steps=10), **kw)
        _, metrics = step(init_opt_state(dict(model.named_parameters())),
                          {k: torch.from_numpy(v) for k, v in data.items()})
    finally:
        tstep.adamw_update = real
    return metrics, seen, {k: p.detach() for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-3b", "mamba2-1.3b",
                                  "granite-moe-1b-a400m"])
def test_train_step_on_mesh_matches_single_process(arch, tmp_path):
    """One train step on a (2, 2) mesh (starcoder2-3b through ring
    attention, granite's load-balancing loss over the global batch): the
    loss, the gradient norm and every gradient within 1e-5 of each leaf's
    largest of the single-process port's on the reference's weights, every
    parameter after the step within 1e-5 of its leaf's largest or, where
    the gradient is near AdamW's eps, within ``train.optim.first_step_bound``
    of that gradient agreement; and the loss within 1e-5 of the
    reference's."""
    jm, params, sd = _reference(arch)
    data = _batch(256, 8, 32, seed=2)
    want_loss, _ = jm.loss(params, {k: jnp.asarray(v) for k, v in data.items()})
    metrics, grads, after = _one_step(arch, sd, data)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-5)
    outs = _ranks("train", 4, tmp_path, arch=np.array(arch), **data, **_state_inputs(sd))
    for out in outs:
        for key in ("loss", "grad_norm", "ce", "aux"):
            _near(out[key], float(metrics[key]))
        np.testing.assert_allclose(float(out["loss"]), float(want_loss), rtol=1e-5)
        assert {k[2:] for k in out if k.startswith("g/")} == set(grads)
        scale = min(1.0, 1.0 / float(metrics["grad_norm"]))
        for k in grads:
            _near(out[f"g/{k}"], grads[k].numpy())
            # AdamW's first step is lr g / (|g| + eps): where |g| is near eps
            # the gradients' agreement allows more (first_step_bound)
            bound = first_step_bound(sd[k], after[k], grads[k], scale,
                                     float(metrics["lr"]), RTOL).numpy()
            tol = np.maximum(bound, RTOL * np.abs(after[k].numpy()).max())
            assert np.all(np.abs(out[f"p/{k}"] - after[k].numpy()) <= tol), k


def test_compress_pod_grads_within_the_quantization_bound(tmp_path):
    """A train step of reduced olmo-1b on a (2, 1, 2) pod mesh with
    ``compress_pod_grads``: each gradient AdamW receives is within
    ``max|g| / 127 + 1e-7`` of the uncompressed one, which equals the
    single-process port's; the loss is unchanged."""
    jm, params, sd = _reference("olmo-1b")
    data = _batch(256, 8, 32, seed=5)
    metrics, grads, _ = _one_step("olmo-1b", sd, data, compress_pod_grads=True)
    for out in _ranks("compress", 4, tmp_path, **data, **_state_inputs(sd)):
        _near(out["loss_True"], float(metrics["loss"]))
        _near(out["loss_False"], float(metrics["loss"]))
        for k, g in grads.items():
            plain = out[f"g0/{k}"]
            _near(plain, g.numpy())
            bound = np.abs(plain).max() / 127 + 1e-7
            assert np.abs(out[f"g1/{k}"] - plain).max() <= bound, k


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_mesh_matches_one_device(tmp_path):
    """``launch.train --mesh 2x2`` under 4 ranks: the losses of 3 steps
    equal ``--mesh 1x1``'s within 1e-5, and 2 steps with checkpoints then
    a resume give the third step's loss again; ``--mesh 2x2`` without
    ranks raises."""
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--batch", "8",
            "--seq", "32", "--steps", "3", "--log-every", "1"]
    want = ttrain.main(argv + ["--mesh", "1x1"])["losses"]
    with pytest.raises(RuntimeError, match="4 ranks"):
        ttrain.main(argv + ["--mesh", "2x2"])
    for out in _ranks("launch", 4, tmp_path):
        np.testing.assert_allclose(out["straight"], want, rtol=1e-5)
        np.testing.assert_allclose(out["first"], want[:2], rtol=1e-5)
        np.testing.assert_allclose(out["resumed"], want[2:], rtol=1e-5)


def test_one_rank_mesh_is_the_one_device_path(tmp_path):
    """On a (1, 1) mesh of one gloo rank, three steps through
    ``launch.train``'s mesh branch (DTensor parameters, per-block gathers
    under block recomputation, the sharded batch, the global aux loss for
    granite) give the one-device path's losses and parameters bit for
    bit.  (A ring arch is not bitwise: its mesh path runs the reference's
    ring algorithm where one device runs the flash kernel's.)"""
    archs = ["olmo-1b", "mamba2-1.3b", "granite-moe-1b-a400m"]
    (out,) = _ranks("one_rank", 1, tmp_path, archs=np.array(archs))
    for arch in archs:
        np.testing.assert_array_equal(out[f"{arch}/mesh/losses"], out[f"{arch}/one/losses"])
        names = [k.split("/p/", 1)[1] for k in out if k.startswith(f"{arch}/one/p/")]
        assert names
        for k in names:
            np.testing.assert_array_equal(out[f"{arch}/mesh/p/{k}"], out[f"{arch}/one/p/{k}"])
