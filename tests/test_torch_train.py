"""The port's training path against the JAX package on the CPU: AdamW, the
schedule and the global norm; gradients of ``loss`` against ``jax.grad``
of the reference's; a whole train step; gradient accumulation; the loss
falling; a gradient for every parameter; the kernels' autograd Function;
and ``launch.train``.

Tolerances.  In float32 at the reduced size the two packages compute the
same functions in other summation orders, so their losses and gradients
agree to float32 rounding: 1e-5 of each leaf's largest gradient, the
reference's model-parity tolerance, leaves room for that and catches a
missing term (a block's gradient dropped, a view not reached) at O(1) of
the leaf's scale.  AdamW's first update is ``lr * g / (|g| + eps)``
(weight decay aside, and equal on both sides), about +-lr wherever |g|
>> eps: a gradient error delta moves it by at most ``lr * eps * delta /
(|g| - delta)^2`` where |g| > delta, and by at most 2 lr where it does
not (|g / (|g| + eps)| <= 1); ``train.optim.first_step_bound`` holds
each parameter to that, plus float32 rounding of the parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro.train import OptConfig as JaxOptConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro.train.optim import OptState as JaxOptState
from repro.train.optim import adamw_update as jax_adamw_update
from repro.train.optim import global_norm as jax_global_norm
from repro.train.optim import lr_schedule as jax_lr_schedule
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.interop import params_from_reference, reference_tree
from repro_torch.kernels import conv1d as tconv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.autograd import PlainGrad, with_plain_grad
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models import lm
from repro_torch.train import OptConfig, OptState, adamw_update, init_opt_state, make_train_step
from repro_torch.train.optim import first_step_bound, global_norm, lr_schedule

GRAD_RTOL = 1e-5        # of each leaf's largest |gradient| (module docstring)
F32_RTOL = 1e-6         # float32 rounding of a value, with room for FMA contraction


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) at |x|."""
    return np.ldexp(1.0, np.frexp(np.maximum(np.abs(x), 1e-30))[1] - 8)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

LEAVES = {"a_vec": ((7,), "float32"), "b_mat": ((4, 6), "float32"),
          "c_vec": ((5,), "bfloat16"), "d_mat": ((3, 2, 4), "bfloat16")}


def _opt_case(clip: bool, count: int, seed: int):
    """The same params, gradients and state for both packages: numpy f32,
    bf16 leaves rounded by each side from the same f32 values (both round
    to nearest even)."""
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in LEAVES.items()}
    g = {k: (rng.standard_normal(s) * (5.0 if clip else 0.05)).astype(np.float32)
         for k, (s, _) in LEAVES.items()}
    g["a_vec"][0] = 0.0                                   # a zero gradient
    mu = {k: (0.0 if count == 0 else 0.01) * rng.standard_normal(s).astype(np.float32)
          for k, (s, _) in LEAVES.items()}
    nu = {k: (0.0 if count == 0 else 1e-4) * rng.random(s).astype(np.float32)
          for k, (s, _) in LEAVES.items()}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jp = {k: jnp.asarray(v, jdt[LEAVES[k][1]]) for k, v in p.items()}
    jg = {k: jnp.asarray(v, jdt[LEAVES[k][1]]) for k, v in g.items()}
    tp = {k: torch.from_numpy(v).to(tdt[LEAVES[k][1]]) for k, v in p.items()}
    tg = {k: torch.from_numpy(v).to(tdt[LEAVES[k][1]]) for k, v in g.items()}
    jstate = JaxOptState({k: jnp.asarray(v) for k, v in mu.items()},
                         {k: jnp.asarray(v) for k, v in nu.items()},
                         jnp.asarray(count, jnp.int32))
    tstate = OptState({k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                      {k: torch.from_numpy(v.copy()) for k, v in nu.items()},
                      torch.tensor(count, dtype=torch.int32))
    return (jp, jg, jstate), (tp, tg, tstate)


@pytest.mark.parametrize("count", [0, 11])
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_update_matches_reference(clip, count):
    """One update from count 0 (the first step, in warmup) and from 11
    (past the warmup of 5), with the global norm under and over the clip,
    on float32 and bf16 leaves of one, two and three dimensions.  float32
    leaves and the float32 moments agree to float32 rounding; a bf16
    parameter is the float32 result rounded to bf16, so a rounding tie
    broken the other way moves it by one bf16 ulp."""
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=40, clip_norm=1.0)
    (jp, jg, js), (tp, tg, ts) = _opt_case(clip, count, seed=count + 10 * clip)
    jp2, js2, jm = jax_adamw_update(JaxOptConfig(**cfg), jg, js, jp)
    tp2, ts2, tm = adamw_update(OptConfig(**cfg), tg, ts, tp)
    assert (float(tm["grad_norm"]) > 1.0) == clip
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=F32_RTOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=F32_RTOL)
    assert int(ts2.count) == int(js2.count) == count + 1
    for k, (_, dtype) in LEAVES.items():
        got, want = tp2[k].float().numpy(), np.asarray(jp2[k], np.float32)
        assert tp2[k].dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        atol = _bf16_ulp(want) if dtype == "bfloat16" else F32_RTOL * np.abs(want) + 1e-12
        assert np.all(np.abs(got - want) <= atol), k
        for tmom, jmom in ((ts2.mu, js2.mu), (ts2.nu, js2.nu)):
            assert tmom[k].dtype == torch.float32
            np.testing.assert_allclose(tmom[k].numpy(), np.asarray(jmom[k]),
                                       rtol=F32_RTOL, atol=1e-12)


def test_lr_schedule_and_global_norm_match_reference():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in list(range(0, 120, 7)) + [10, 100]:
        np.testing.assert_allclose(
            float(lr_schedule(OptConfig(**cfg), torch.tensor(s, dtype=torch.int32))),
            float(jax_lr_schedule(JaxOptConfig(**cfg), jnp.asarray(s, jnp.int32))),
            rtol=F32_RTOL)
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in [(3,), (4, 5), (2, 2, 2)]]
    np.testing.assert_allclose(float(global_norm(torch.from_numpy(x) for x in leaves)),
                               float(jax_global_norm([jnp.asarray(x) for x in leaves])),
                               rtol=F32_RTOL)


def test_adamw_decreases_quadratic():
    cfg = OptConfig(lr=0.1, warmup_steps=1, total_steps=100,
                    weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}       # d/dw ||w||^2
        params, state, _ = adamw_update(cfg, grads, state, params)
    assert float(params["w"].abs().sum()) < 0.5


def test_grad_clipping():
    cfg = OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=1, total_steps=10)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    _, _, metrics = adamw_update(cfg, {"w": torch.full((4,), 1e6)}, state, params)
    assert float(metrics["grad_norm"]) > 1e5   # reported pre-clip
    # clipped to norm 1: the first step is lr * g / (|g| + eps) all the same
    np.testing.assert_allclose(params["w"].numpy(), -1e-3 * np.ones(4), rtol=1e-6)


def test_lr_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(s))) for s in (0, 5, 10, 55, 100)]
    assert lrs[1] == pytest.approx(0.5)     # mid-warmup
    assert lrs[2] == pytest.approx(1.0)     # peak
    assert lrs[2] > lrs[3] > lrs[4]
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)


# ---------------------------------------------------------------------------
# gradients and train steps against the reference
# ---------------------------------------------------------------------------

def _carried(arch, **over):
    """(reference model, its numpy params, the port's model on the same
    weights, cfg); the hybrid keeps 5 layers (two supercells and a
    trailing block), the VLM 4 (two supercells), with its gates, 0 at
    init, set to 0.5 so that the cross blocks get gradients."""
    n_layers = {"hybrid": 5, "vlm": 4}.get(get_config(arch).family, 2)
    jm = jax_build_model(jax_reduced(jax_get_config(arch)).replace(n_layers=n_layers))
    params = jax.tree_util.tree_map(np.asarray, unbox(jm.init(jax.random.PRNGKey(0))))
    if "super_cross" in params:
        params["super_cross"]["gate"] = np.full_like(params["super_cross"]["gate"], 0.5)
    cfg = reduced(get_config(arch)).replace(n_layers=n_layers, **over)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, params))
    return jm, params, model, cfg


def _batch(cfg, B, S, seed):
    """Tokens, labels (a quarter masked) and the seeded media (vlm) or
    frames (audio), for both packages."""
    rng = np.random.default_rng(seed)
    data = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    data["labels"][:, ::4] = -1
    if cfg.family == "vlm":
        data["media"] = rng.standard_normal((B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        data["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v) for k, v in data.items()})


def _port_grads(model, cfg, batch):
    params = dict(model.named_parameters())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, reference_tree(cfg, dict(zip(params, grads)))


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree))


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's loss and gradient leaves per arch, computed once for
    both remat settings of the port."""
    cache = {}

    def get(arch, cfg, jm, params, jb):
        if arch not in cache:
            jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jb)[0])(params)
            cache[arch] = float(jl), _leaves(jg)
        return cache[arch]

    return get


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b", "zamba2-1.2b", "starcoder2-3b",
                                  "granite-moe-1b-a400m", "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_loss_gradients_match_reference(arch, remat, reference_grads):
    """Every parameter's gradient of ``loss`` against ``jax.grad`` of the
    reference's, leaf by leaf in the reference's layout, without and with
    block recomputation (nested per supercell in the hybrid); the MoE's
    router gets its gradient through the gate weights and the aux loss,
    the VLM's gates and cross blocks theirs through the tanh gate."""
    jm, params, model, cfg = _carried(arch, remat=remat)
    jb, tb = _batch(cfg, 2, 32, seed=3)
    jl, want = reference_grads(arch, cfg, jm, params, jb)
    tl, tg = _port_grads(model, cfg, tb)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    got = _leaves(tg)
    assert len(want) == len(got)
    assert sum(g.size for g in got) == sum(p.numel() for p in model.parameters())
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max())


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b", "granite-moe-1b-a400m"])
def test_train_step_matches_reference(arch):
    """One whole train step (loss, gradients, AdamW from a fresh state) on
    the same weights and batch: loss and gradient norm to float32
    rounding, every parameter within ``train.optim.first_step_bound`` of
    gradients that agree to GRAD_RTOL."""
    jm, params, model, cfg = _carried(arch)
    jb, tb = _batch(cfg, 4, 32, seed=4)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jp, js, jmet = jax.jit(jax_make_train_step(jm, JaxOptConfig(**opt)))(
        params, jax_init_opt_state(params), jb)
    state, tmet = make_train_step(model, OptConfig(**opt))(
        init_opt_state(dict(model.named_parameters())), tb)
    for key in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=F32_RTOL)
    assert int(state.count) == int(js.count) == 1
    grads = _leaves(jax.grad(lambda p: jm.loss(p, jb)[0])(params))
    scale = min(1.0, 1.0 / float(jmet["grad_norm"]))
    want, old = _leaves(jp), _leaves(params)
    got = _leaves(reference_tree(cfg, dict(model.named_parameters())))
    for w, g, o, gr in zip(want, got, old, grads):
        bound = first_step_bound(*(torch.from_numpy(x) for x in (o, w, gr)), scale,
                                 float(jmet["lr"]), GRAD_RTOL).numpy()
        assert np.all(np.abs(g - w) <= bound)


def test_grad_accumulation_equivalence():
    """accum_steps=2 over an 8-row batch == accum_steps=1 (the reference's
    test and tolerance, ``tests/test_train_integration.py``)."""
    cfg = reduced(get_config("olmo-1b"))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    batch = {k: torch.from_numpy(v).long() for k, v in pipe.batch_at(0).items()}
    outs = []
    for accum in (1, 2):
        model = build_model(cfg, device="cpu")
        step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                               accum_steps=accum)
        _, m = step(init_opt_state(dict(model.named_parameters())), batch)
        outs.append((dict(model.named_parameters()), float(m["loss"])))
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5)
    for k, p in outs[0][0].items():
        np.testing.assert_allclose(p.detach().numpy(), outs[1][0][k].detach().numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_training_reduces_loss():
    """The reference's ``test_training_reduces_loss``: reduced OLMo, 40
    steps of 8 x 64 tokens at lr 3e-3."""
    cfg = reduced(get_config("olmo-1b"))
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=3, total_steps=40))
    state = init_opt_state(dict(model.named_parameters()))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
    losses = []
    for s in range(40):
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in pipe.batch_at(s).items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_gets_a_gradient(arch):
    """Every parameter of the reduced model gets a finite gradient that is
    not zero everywhere (the reference's ``test_arch_smoke_train_step``,
    per parameter); the VLM's gates at 0.5, since a zero gate stops the
    cross attention's gradient."""
    cfg = reduced(get_config(arch)).replace(remat="block")
    model = build_model(cfg, device="cpu")
    for cross in getattr(model, "cross", ()):
        torch.nn.init.constant_(cross.gate, 0.5)
    _, tb = _batch(cfg, 2, 32, seed=6)
    params = dict(model.named_parameters())
    loss, _ = model.loss(tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert bool(torch.isfinite(loss))
    for name, g in zip(params, grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the kernels' autograd Function, with the plain version as the "kernel"
# ---------------------------------------------------------------------------

def _counting(fn):
    def kernel(*a):
        kernel.calls += 1
        with torch.no_grad():
            return fn(*a)
    kernel.calls = 0
    return kernel


def _check_plain_grad(name, plain, inputs, cotangent):
    """``PlainGrad`` with ``plain`` standing in for the kernel: one kernel
    call per forward and none in the backward; the gradients equal
    autograd of ``plain`` itself."""
    kernel = _counting(plain)
    out = with_plain_grad(name, kernel, plain, *inputs)
    assert kernel.calls == 1 and out[0].grad_fn is not None
    leaves = [t for t in inputs if t.requires_grad]
    got = torch.autograd.grad(cotangent(out), leaves)
    assert kernel.calls == 1
    want = torch.autograd.grad(cotangent(plain(*inputs)), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return got


def test_plain_grad_conv1d_reaches_the_column_view():
    """x is a column range of a wider tensor (the in-projection): its
    gradient lands in those columns and nowhere else."""
    rng = np.random.default_rng(0)
    proj = torch.from_numpy(rng.standard_normal((2, 37, 90)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((4, 40)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((2, 37, 40)).astype(np.float32))
    x = proj[..., 30:70]
    assert not x.is_contiguous()
    _check_plain_grad("conv1d", tconv.ref.causal_conv1d, (x, w, b), lambda y: (y[0] * cot).sum())
    y = with_plain_grad("conv1d", _counting(tconv.ref.causal_conv1d), tconv.ref.causal_conv1d,
                        x, w, b)
    (gproj,) = torch.autograd.grad((y * cot).sum(), [proj])
    assert float(gproj[..., :30].abs().max()) == 0 == float(gproj[..., 70:].abs().max())
    assert float(gproj[..., 30:70].abs().min()) >= 0 and float(gproj[..., 30:70].abs().max()) > 0


@pytest.mark.parametrize("use_state", [False, True])
def test_plain_grad_ssd(use_state):
    """y alone (the final state's cotangent None, as in training) and y with
    the final state; gradients for xh, dt, A, Bm and Cm."""
    rng = np.random.default_rng(1)
    B, L, H, P, N = 2, 32, 3, 8, 16
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    xh, Bm, Cm = f(B, L, H, P), f(B, L, 1, N), f(B, L, 1, N)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32))
    inputs = [t.requires_grad_() for t in (xh, dt, A, Bm, Cm)]
    cy, cs = f(B, L, H, P), f(B, H, N, P)
    plain = lambda *a: tssd.ref.ssd_chunked(*a, 16)
    cot = (lambda o: (o[0] * cy).sum() + (o[1] * cs).sum()) if use_state else \
        (lambda o: (o[0] * cy).sum())
    grads = _check_plain_grad("ssd", plain, inputs, cot)
    assert len(grads) == 5 and all(float(g.abs().max()) > 0 for g in grads)


def test_plain_grad_flash_attention_gqa_and_partial_inputs():
    """GQA (8 query heads over 2 kv heads), causal; only q and v need a
    gradient, so k gets none."""
    rng = np.random.default_rng(2)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v = f(2, 40, 8, 16).requires_grad_(), f(2, 40, 2, 16), f(2, 40, 2, 16).requires_grad_()
    cot = f(2, 40, 8, 16)
    _check_plain_grad("flash", lambda *a: tfa.ref.attention_ref(*a, causal=True), (q, k, v),
                      lambda o: (o * cot).sum())


def test_plain_grad_is_not_taken_without_grad():
    """No input needs a gradient, or grad mode is off: the kernel is called
    directly and its result has no graph."""
    x = torch.ones(1, 5, 4)
    w, b = torch.ones(4, 4, requires_grad=True), torch.zeros(4)
    kernel = _counting(tconv.ref.causal_conv1d)
    assert with_plain_grad("conv1d", kernel, tconv.ref.causal_conv1d, x, w.detach(),
                           b).grad_fn is None
    with torch.no_grad():
        assert with_plain_grad("conv1d", kernel, tconv.ref.causal_conv1d, x, w, b).grad_fn is None
    assert kernel.calls == 2
    assert PlainGrad.apply("conv1d", kernel, tconv.ref.causal_conv1d, x, w, b).grad_fn is not None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum", [("olmo-1b", 1), ("mamba2-1.3b", 2), ("zamba2-1.2b", 1),
                                        ("granite-moe-1b-a400m", 1), ("kimi-k2-1t-a32b", 1),
                                        ("seamless-m4t-large-v2", 2),
                                        ("llama-3.2-vision-90b", 1)])
def test_launch_train_runs_on_cpu(arch, accum):
    out = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "4",
                       "--batch", "4", "--seq", "32", "--accum", str(accum),
                       "--log-every", "2"])
    assert out["steps"] == 4 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"])) and out["first_loss"] == out["losses"][0]
    assert out["step_ms"] > 0 and out["peak_gib"] is None and out["wall_s"] > 0


class _Mesh:
    """What the sharded MoE dispatch reads of a mesh before its schedule."""
    mesh_dim_names = ("data", "model")

    def size(self, dim=None):
        return 2 if dim is not None else 4


def test_launch_train_refuses_what_is_not_ported():
    """A mesh without its ranks, an unknown arch and an unknown MoE
    schedule on a mesh raise; without a mesh ``moe_impl="sharded"`` runs
    the dense dispatch.  The multi-rank paths themselves are in
    tests/test_torch_distributed.py and tests/test_torch_moe_sharded.py."""
    with pytest.raises(RuntimeError, match="2 ranks"):
        ttrain.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--mesh", "2x1"])
    with pytest.raises(SystemExit):             # not a registered arch
        ttrain.main(["--arch", "no-such-arch", "--device", "cpu"])
    cfg = reduced(get_config("granite-moe-1b-a400m")).replace(moe_impl="sharded",
                                                              moe_schedule="3d")
    model = build_model(cfg, device="cpu")
    x = torch.zeros(2, 8, cfg.d_model)
    with pytest.raises(ValueError, match="unknown MoE schedule"):
        lm._apply_ffn(model.blocks[0], x, cfg, _Mesh())
    assert lm._apply_ffn(model.blocks[0], x, cfg)[0].shape == x.shape   # no mesh: dense
