"""The port's MoE family against the JAX package on the CPU: the router,
the load-balancing loss and the dense dispatch (``models/moe.py``) at
several (B, S, D, F, E, k), k = 1 and k = E included; then the reduced
``granite-moe-1b-a400m`` and ``kimi-k2-1t-a32b`` on the reference's
weights: ``hidden``, ``loss`` (ce and aux), prefill, one decode step and
greedy generation; the configs; the launcher; and a checkpoint round
trip of a MoE train state.

Tolerance: float32 at the reduced size, so the two packages agree to
float32 rounding; 1e-5 (``tests/test_torch_mamba2_serve.py``'s) leaves
room for summation order and catches any wrong term.  The router's
top-k is compared exactly: with continuous random inputs a near-tie
within float32 rounding has probability of order 1e-6 per token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models import unbox
from repro.serve import generate as jax_generate
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config, reduced
from repro_torch.interop import load_train_state, params_from_reference, train_state_tree
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, build_model
from repro_torch.models import moe
from repro_torch.serve import generate
from repro_torch.train import OptConfig, init_opt_state, make_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
NEW_ARCHS = MOE_ARCHS + ["seamless-m4t-large-v2", "llama-3.2-vision-90b"]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# router, aux loss and dispatch
# ---------------------------------------------------------------------------

# (B, S, D, F, E, k)
SHAPES = [(2, 8, 16, 32, 4, 2), (1, 5, 12, 20, 6, 1), (3, 4, 8, 16, 5, 5),
          (2, 16, 32, 24, 8, 3), (1, 3, 16, 8, 32, 8)]


def _moe_case(B, S, D, F, E, k, seed=0):
    rng = np.random.default_rng(seed + 17 * E + k)
    p = jax.tree_util.tree_map(
        np.asarray, unbox(jax_moe.init_moe(jax.random.PRNGKey(seed), D, F, E, k)))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("B,S,D,F,E,k", SHAPES)
def test_router_probs_matches_reference(B, S, D, F, E, k):
    p, x = _moe_case(B, S, D, F, E, k)
    jidx, jw, jlog = jax_moe.router_probs(jnp.asarray(p["router"]), jnp.asarray(x), k)
    idx, w, logits = moe.router_probs(torch.from_numpy(p["router"]), torch.from_numpy(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw)
    _close(logits, jlog)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("B,S,D,F,E,k", SHAPES)
def test_aux_loss_and_dense_dispatch_match_reference(B, S, D, F, E, k):
    p, x = _moe_case(B, S, D, F, E, k)
    jy, jaux = jax_moe.apply_moe_dense(jax.tree_util.tree_map(jnp.asarray, p),
                                       jnp.asarray(x), k, E)
    y, aux = moe.apply_moe_dense({n: torch.from_numpy(v) for n, v in p.items()},
                                 torch.from_numpy(x), k, E)
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    idx, _, logits = moe.router_probs(torch.from_numpy(p["router"]), torch.from_numpy(x), k)
    want = jax_moe.aux_load_balance_loss(jnp.asarray(logits.numpy()),
                                         jnp.asarray(idx.numpy()), E)
    got = moe.aux_load_balance_loss(logits, idx, E)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    if k == E:                       # every expert chosen: aux = E * sum(mean probs) = E
        np.testing.assert_allclose(float(aux), E, rtol=1e-5)


def test_dense_dispatch_is_the_weighted_sum_of_the_chosen_experts():
    """Token by token, y is the gate-weighted sum of the chosen experts'
    SwiGLU outputs: the function the dense dispatch computes."""
    p, x = _moe_case(2, 6, 16, 24, 8, 3)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    xt = torch.from_numpy(x)
    y, _ = moe.apply_moe_dense(tp, xt, 3, 8)
    idx, w, _ = moe.router_probs(tp["router"], xt, 3)
    for b in range(2):
        for s in range(6):
            want = sum(w[b, s, j] * (torch.nn.functional.silu(xt[b, s] @ tp["w_gate"][e])
                                     * (xt[b, s] @ tp["w_up"][e])) @ tp["w_down"][e]
                       for j, e in enumerate(idx[b, s].tolist()))
            torch.testing.assert_close(y[b, s], want, rtol=1e-5, atol=1e-5)


def test_router_stays_float32_in_a_bf16_model():
    cfg = reduced(get_config("granite-moe-1b-a400m")).replace(dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    sd = model.state_dict()
    assert sd["blocks.0.moe.router"].dtype == torch.float32
    assert sd["blocks.0.moe.w_gate"].dtype == torch.bfloat16
    assert tuple(sd["blocks.0.moe.w_down"].shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch, full):
    j, t = jax_get_config(arch), get_config(arch)
    if not full:
        j, t = jax_reduced(j), reduced(t)
    for f in j.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    for p in ("head_dim", "padded_vocab"):
        assert getattr(t, p) == getattr(j, p), p


# ---------------------------------------------------------------------------
# the reduced MoE models against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    """(jax model, jax params, port model) holding the same weights."""
    arch = request.param
    jm = jax_build_model(jax_reduced(jax_get_config(arch)))
    params = unbox(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, model


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_state_dict_covers_every_parameter(pair):
    _, params, model = pair
    assert isinstance(model, Model)
    n_ref = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_hidden_and_loss_match_reference(pair):
    """``hidden`` and ``loss`` with a quarter of the labels masked; aux
    is the sum over the layers of the router's load-balancing loss."""
    jm, params, model = pair
    toks = _tokens(model.cfg, 2, 32, seed=3)
    labels = _tokens(model.cfg, 2, 32, seed=4)
    labels[:, ::4] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jh, jaux = jm.hidden(params, jb)
    th, taux = model.hidden(tb)
    _close(th, jh)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    (jl, jmet), (tl, tmet) = jm.loss(params, jb), model.loss(tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL)
    assert float(tmet["aux"]) > 0
    np.testing.assert_allclose(float(tl), float(tmet["ce"]) + 0.01 * float(tmet["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("S,max_len", [(16, None), (48, 56)])
def test_prefill_matches_reference(pair, S, max_len):
    jm, params, model = pair
    toks = _tokens(model.cfg, 2, S, seed=S)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks)}, max_len=max_len)
    _close(tl, jl)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key])
    assert (tc["pos"].numpy() == np.asarray(jc["pos"])).all()


def test_decode_step_matches_reference(pair):
    jm, params, model = pair
    toks = _tokens(model.cfg, 2, 32, seed=1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=40)
    _, tc = model.prefill({"tokens": torch.from_numpy(toks)}, max_len=40)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl2, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc)
    tl2, tc2 = model.decode_step(torch.from_numpy(nxt), tc)
    _close(tl2, jl2)
    for key in ("k", "v"):
        _close(tc2[key], jc2[key])


def test_greedy_generate_matches_reference(pair):
    jm, params, model = pair
    toks = _tokens(model.cfg, 3, 48, seed=2)
    want = np.asarray(jax_generate(jm, params, {"tokens": jnp.asarray(toks)}, n_tokens=8))
    got = generate(model, {"tokens": torch.from_numpy(toks)}, n_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_impl_runs_the_dense_dispatch():
    """A config asking for the sharded dispatch runs, without a mesh, the
    dropless dispatch, which computes the dense one's function (here, at
    float32 on the CPU, bit for bit), as the reference runs the dense one
    without a mesh."""
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    dense = build_model(cfg, device="cpu")
    sharded = build_model(cfg.replace(moe_impl="sharded"), device="cpu")
    sharded.load_state_dict(dense.state_dict())
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=5))
    torch.testing.assert_close(sharded.prefill({"tokens": toks})[0],
                               dense.prefill({"tokens": toks})[0], rtol=0, atol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_serve_runs_on_cpu(arch, capsys):
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# a MoE train state through the checkpoint store
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_of_a_moe_state(tmp_path):
    """Two train steps of the reduced Granite (bf16 parameters, the float32
    router), saved, restored into a fresh model and state: every
    parameter, moment and the count bitwise equal, the router's moments
    float32 like the rest."""
    cfg = reduced(get_config("granite-moe-1b-a400m")).replace(dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    state = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    rng = np.random.default_rng(8)
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
        state, _ = step(state, {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    store = CheckpointStore(str(tmp_path))
    store.save(2, train_state_tree(cfg, model, state))
    fresh = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    fst = init_opt_state(dict(fresh.named_parameters()))
    tree, _ = store.restore(2, train_state_tree(cfg, fresh, fst))
    fst = load_train_state(cfg, fresh, fst, tree)
    assert int(fst.count) == 2
    for (k, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in state.mu:
        assert torch.equal(state.mu[k], fst.mu[k]) and torch.equal(state.nu[k], fst.nu[k]), k
    assert fst.mu["blocks.1.moe.router"].dtype == torch.float32
    assert float(fst.mu["blocks.1.moe.router"].abs().max()) > 0
