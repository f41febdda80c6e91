"""The port's checkpoint store and fleet-health hooks (``checkpoint/store.py``,
``runtime/health.py``): the reference's substrate tests on the port, a
resume equal bit for bit to an uninterrupted run (through the store and
through ``launch.train --resume``), and checkpoints crossing between the
two packages in both directions, bf16 leaves included.

Across packages in bf16 the two train steps round at other places, so
the step after a cross-read is held to a bound, not to equality.  Each
side moves a parameter by ``lr * (u + wd * p)``, rounded to bf16, where
u = mhat / (sqrt(vhat) + eps) and the decay term is the same on both
sides; by Cauchy-Schwarz |u| <= U(t) = (1 - b1) / sqrt(1 - b2) *
sqrt(sum_k<t (b1^2 / b2)^k) * sqrt(1 - b2^t) / (1 - b1^t) (1.00 at
t = 3), so the two results differ by at most 2 lr U(t) plus one bf16 ulp
of the parameter (each side's rounding).  That bound holds whatever the
gradients; what ties the two steps to each other is that the loss agrees
to 1e-4 (bf16 forward, measured 5e-6) and the gradient norm to 1e-3
(measured 1.4e-4), and that at least 80 % of each leaf's elements come
out bit for bit equal (measured 93-99 %), which a restored state off by
a count or a swapped moment would not give."""

import json
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.checkpoint import CheckpointStore as JaxCheckpointStore
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro.train import OptConfig as JaxOptConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointStore, tree_flatten
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.interop import load_train_state, train_state_tree
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.runtime import Heartbeat, StragglerDetector, plan_elastic
from repro_torch.train import OptConfig, init_opt_state, make_train_step


# ---------------------------------------------------------------------------
# the reference's substrate tests, on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = {"p": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "n": torch.tensor(3), "h": torch.linspace(-2, 2, 5).to(torch.bfloat16)}
    store.save(10, state, extra={"data_step": 10})
    assert store.latest_step() == 10
    got, extra = store.restore(10, state)
    for k, v in state.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert extra["data_step"] == 10


def test_checkpoint_atomicity(tmp_path):
    """A half-written (no manifest) checkpoint is never 'latest'."""
    store = CheckpointStore(str(tmp_path))
    state = {"p": torch.ones(4)}
    store.save(1, state)
    broken = tmp_path / "step_2"                 # a crash mid-write of step 2
    broken.mkdir()
    (broken / "leaf_00000.npy").write_bytes(b"garbage")
    assert store.latest_step() == 1


def test_checkpoint_corruption_detected(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = {"p": torch.ones(4)}
    store.save(1, state)
    leaf = tmp_path / "step_1" / "leaf_00000.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(IOError):
        store.restore(1, state)


def test_checkpoint_async_and_gc(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = {"p": torch.ones(4)}
    for s in (1, 2, 3, 4):
        store.save_async(s, state)
    store.wait()
    assert store.latest_step() == 4
    store.gc(keep=2)
    assert store.latest_step() == 4
    assert not (tmp_path / "step_1").exists()


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    """The port updates parameters in place: what ``save_async`` writes is
    the state when it was called, not after a later in-place update."""
    store = CheckpointStore(str(tmp_path))
    state = {"p": torch.zeros(1 << 16)}
    store.save_async(1, state)
    state["p"] += 1.0
    store.wait()
    got, _ = store.restore(1, state)
    assert float(got["p"].abs().max()) == 0.0


def test_heartbeat_death_detection():
    hb = Heartbeat(["a", "b"], lease_s=10.0)
    hb.beat("a", 5, now=100.0)
    hb.beat("b", 5, now=100.0)
    assert hb.dead_hosts(now=105.0) == []
    hb.beat("a", 6, now=115.0)
    assert hb.dead_hosts(now=115.0) == ["b"]
    assert hb.watermark() == 5


def test_straggler_detection():
    det = StragglerDetector(threshold=1.5, patience=2)
    t_ok = {"a": 1.0, "b": 1.0, "c": 1.0}
    t_slow = {"a": 1.0, "b": 1.0, "c": 2.5}
    assert det.observe_step(t_ok) == []
    assert det.observe_step(t_slow) == []        # patience 1/2
    assert det.observe_step(t_slow) == ["c"]     # flagged
    assert det.observe_step(t_ok) == []          # streak reset


def test_elastic_plan():
    plan = plan_elastic([f"h{i}" for i in range(128)], chips_per_host=4, model_axis=16)
    assert plan.mesh_shape == (32, 16)           # 512 chips
    plan2 = plan_elastic([f"h{i}" for i in range(100)], chips_per_host=4)
    assert plan2.mesh_shape == (16, 16)          # shrink to 256 chips
    assert len(plan2.host_slices) == 64


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

def _batch(pipe, s):
    return {k: torch.from_numpy(v).long() for k, v in pipe.batch_at(s).items()}


def test_checkpoint_resume_bitwise(tmp_path):
    """Stop at step 10, save, restore into a fresh model and state, resume:
    the parameters and moments after 20 steps equal those of an
    uninterrupted run bit for bit (the reference's test holds them to
    1e-6; the port repeats the same operations on the CPU)."""
    cfg = reduced(get_config("olmo-1b"))
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))

    def run(model, state, lo, hi):
        step = make_train_step(model, opt)
        for s in range(lo, hi):
            state, _ = step(state, _batch(pipe, s))
        return state

    model_a = build_model(cfg, device="cpu")
    state_a = run(model_a, init_opt_state(dict(model_a.named_parameters())), 0, 20)
    model_b = build_model(cfg, device="cpu")
    state_b = run(model_b, init_opt_state(dict(model_b.named_parameters())), 0, 10)
    store = CheckpointStore(str(tmp_path))
    store.save(10, train_state_tree(cfg, model_b, state_b), extra={"data_step": 10})
    model_c = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    state_c = init_opt_state(dict(model_c.named_parameters()))
    tree, extra = store.restore(10, train_state_tree(cfg, model_c, state_c))
    state_c = load_train_state(cfg, model_c, state_c, tree)
    assert int(state_c.count) == 10
    state_c = run(model_c, state_c, extra["data_step"], 20)
    for (k, a), (_, c) in zip(model_a.named_parameters(), model_c.named_parameters()):
        assert torch.equal(a, c), k
    for k in state_a.mu:
        assert torch.equal(state_a.mu[k], state_c.mu[k]) and torch.equal(state_a.nu[k], state_c.nu[k])


def test_launch_train_resume_bitwise(tmp_path):
    """``launch.train`` with checkpoints every 3 of 6 steps; the step-6
    checkpoint removed, ``--resume`` continues from step 3 and ends on
    the parameters of the uninterrupted run, bit for bit."""
    argv = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu", "--steps", "6",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    full = ttrain.main(argv)["model"]
    assert CheckpointStore(str(tmp_path)).latest_step() == 6
    import shutil
    shutil.rmtree(tmp_path / "step_6")
    out = ttrain.main(argv + ["--resume"])
    assert len(out["losses"]) == 3
    for (k, a), (_, b) in zip(full.named_parameters(), out["model"].named_parameters()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _adam_ratio_bound(t: int, b1: float = 0.9, b2: float = 0.95) -> float:
    """U(t): the largest |mhat / sqrt(vhat)| after t updates (module
    docstring)."""
    s = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / math.sqrt(1 - b2) * math.sqrt(s) * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)


def _as_f32(tree):
    def f(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().numpy()
        x = np.asarray(x)
        return (x.view(ml_dtypes.bfloat16) if x.dtype.kind == "V" else x).astype(np.float32)
    return [f(x) for x in jax.tree_util.tree_leaves(tree)]


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _check_next_steps(port_params, ref_params, old_params, port_met, ref_met, count):
    np.testing.assert_allclose(float(port_met["loss"]), float(ref_met["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(port_met["grad_norm"]), float(ref_met["grad_norm"]),
                               rtol=1e-3)
    lr = float(ref_met["lr"])
    bound = 2 * lr * _adam_ratio_bound(count)
    for g, w, o in zip(_as_f32(port_params), _as_f32(ref_params), _as_f32(old_params)):
        ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(w), 1e-30))[1] - 8)
        assert np.all(np.abs(g - w) <= bound + ulp)
        assert np.mean(g == w) >= 0.8
        assert not np.array_equal(w, o)              # the step moved the leaf


def test_checkpoints_cross_between_packages(tmp_path):
    """Reduced OLMo in bf16.  The reference trains 2 steps and saves
    (params, OptState) with its store; the port restores every leaf bit
    for bit and takes step 3, which agrees with the reference's step 3.
    Then the port saves its state after step 3; the reference restores
    every leaf bit for bit, both take step 4, and they agree again."""
    jm = jax_build_model(jax_reduced(jax_get_config("olmo-1b")).replace(dtype="bfloat16"))
    cfg = reduced(get_config("olmo-1b")).replace(dtype="bfloat16")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    jstep = jax.jit(jax_make_train_step(jm, JaxOptConfig(**OPT)))
    jbatch = lambda s: {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
    params = unbox(jm.init(jax.random.PRNGKey(0)))
    jstate = jax_init_opt_state(params)
    for s in range(2):
        params, jstate, _ = jstep(params, jstate, jbatch(s))
    JaxCheckpointStore(str(tmp_path / "ref")).save(2, (params, jstate), extra={"data_step": 2})

    model = build_model(cfg, device="cpu")
    state = init_opt_state(dict(model.named_parameters()))
    step, tree, extra = CheckpointStore(str(tmp_path / "ref")).restore_latest(
        train_state_tree(cfg, model, state))
    assert (step, extra) == (2, {"data_step": 2})
    ref_leaves, _ = tree_flatten((params, jstate))
    got_leaves, _ = tree_flatten(tree)
    assert [_raw(x) for x in got_leaves] == [_raw(x) for x in ref_leaves]
    state = load_train_state(cfg, model, state, tree)
    assert model.embed["table"].dtype == torch.bfloat16 and int(state.count) == 2

    pstep = make_train_step(model, OptConfig(**OPT))
    state, pmet = pstep(state, _batch(pipe, 2))
    params3, jstate3, jmet = jstep(params, jstate, jbatch(2))
    port3 = train_state_tree(cfg, model, state)
    _check_next_steps(port3[0], params3, params, pmet, jmet, count=3)

    CheckpointStore(str(tmp_path / "port")).save(3, port3, extra={"data_step": 3})
    back, extra = JaxCheckpointStore(str(tmp_path / "port")).restore(3, (params3, jstate3))
    assert extra == {"data_step": 3}
    assert [_raw(x) for x in jax.tree_util.tree_leaves(back)] == \
        [_raw(x) for x in tree_flatten(port3)[0]]
    back = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.view(ml_dtypes.bfloat16) if x.dtype.kind == "V" else x), back)
    params4, _, jmet = jstep(*back, jbatch(3))
    state, pmet = pstep(state, _batch(pipe, 3))
    _check_next_steps(train_state_tree(cfg, model, state)[0], params4, back[0], pmet, jmet,
                      count=4)


def test_checkpoint_files_equal_the_reference(tmp_path):
    """The same bf16 train state saved by both stores: every leaf file and
    the manifest, its structure string included, are byte for byte the
    same."""
    cfg = reduced(get_config("zamba2-1.2b")).replace(n_layers=5, dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    state = init_opt_state(dict(model.named_parameters()))
    state = state._replace(count=torch.tensor(7, dtype=torch.int32))
    tree = train_state_tree(cfg, model, state)
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                              if t.dtype == torch.bfloat16 else t.numpy()), tree)
    CheckpointStore(str(tmp_path / "port")).save(7, tree, extra={"data_step": 7})
    JaxCheckpointStore(str(tmp_path / "ref")).save(7, jtree, extra={"data_step": 7})
    port, ref = tmp_path / "port" / "step_7", tmp_path / "ref" / "step_7"
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in port.iterdir())
    assert len(names) == 3 * 29 + 2                   # params, mu, nu, count, manifest
    for name in names:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    manifest = json.loads((ref / "MANIFEST.json").read_text())
    assert {m["dtype"] for m in manifest["leaves"]} == {"bfloat16", "float32", "int32"}
