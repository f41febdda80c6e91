"""The port's dense-transformer serving path against the JAX package, on
the CPU at the reduced configs of all four dense archs (float32, 2
layers, Dh 16): OLMo-1B's non-parametric LayerNorm, Yi-9B's and
DeepSeek-67B's GQA with RMSNorm and SwiGLU, StarCoder2-3B's LayerNorm,
GELU MLP and ``attn_impl="ring"``.  The reference's initialized
parameters are carried over, then prefill (logits and k/v caches), the
empty cache, one decode step and greedy generation are compared; plus
the configs and the launcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro.serve import generate as jax_generate
from repro_torch.configs import get_config, reduced
from repro_torch.interop import dense_params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, build_model
from repro_torch.serve import generate

ARCHS = ["olmo-1b", "yi-9b", "starcoder2-3b", "deepseek-67b"]
# float32 at the reduced size: the two packages agree to float32
# rounding; 1e-5 leaves room for summation order and still catches any
# wrong term.
TOL = dict(rtol=1e-5, atol=1e-5)
CACHES = ("k", "v")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model) holding the same weights."""
    arch = request.param
    jm = jax_build_model(jax_reduced(jax_get_config(arch)))
    params = unbox(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(dense_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, model


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, full):
    j, t = jax_get_config(arch), get_config(arch)
    if not full:
        j, t = jax_reduced(j), reduced(t)
    for f in j.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    for p in ("head_dim", "padded_vocab"):
        assert getattr(t, p) == getattr(j, p), p


def test_state_dict_covers_every_parameter(pair):
    """Every reference leaf has exactly one key (none for OLMo's norms),
    and the parameter counts agree."""
    _, params, model = pair
    assert isinstance(model, Model)
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert set(dense_params_from_reference(model.cfg, tree)) == set(model.state_dict())
    n_ref = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    if model.cfg.norm == "nonparametric":
        assert not any(k.startswith("ln_f") or ".ln" in k for k in model.state_dict())


@pytest.mark.parametrize("S,max_len", [(16, None), (48, 56)])
def test_prefill_matches_reference(pair, S, max_len):
    """S = 16 is one attention block of the reference, 48 three; max_len
    pads the k/v caches."""
    jm, params, model = pair
    toks = _tokens(model.cfg, 2, S, seed=S)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks)}, max_len=max_len)
    _close(tl, jl)
    for key in CACHES:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key])
    assert (tc["pos"].numpy() == np.asarray(jc["pos"])).all()


def test_init_cache_matches_reference(pair):
    jm, _, model = pair
    want = jm.init_cache(3, 40)
    got = model.init_cache(3, 40)
    for key in (*CACHES, "pos"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert not got[key].any()
    assert got["k"].data_ptr() != got["v"].data_ptr()


def test_decode_step_matches_reference(pair):
    jm, params, model = pair
    toks = _tokens(model.cfg, 2, 32, seed=1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=40)
    _, tc = model.prefill({"tokens": torch.from_numpy(toks)}, max_len=40)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl2, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc)
    tl2, tc2 = model.decode_step(torch.from_numpy(nxt), tc)
    _close(tl2, jl2)
    for key in CACHES:
        _close(tc2[key], jc2[key])
    assert (tc2["pos"].numpy() == np.asarray(jc2["pos"])).all()


def test_greedy_generate_matches_reference(pair):
    jm, params, model = pair
    toks = _tokens(model.cfg, 3, 48, seed=2)
    want = np.asarray(jax_generate(jm, params, {"tokens": jnp.asarray(toks)},
                                   n_tokens=8))
    got = generate(model, {"tokens": torch.from_numpy(toks)}, n_tokens=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_launch_serve_runs_on_cpu(capsys):
    out = tserve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert isinstance(out["model"], Model)
    assert "[serve] olmo-1b on cpu" in capsys.readouterr().out
