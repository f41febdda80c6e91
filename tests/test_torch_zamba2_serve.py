"""The port's hybrid (Zamba2) serving path against the JAX package, on
the CPU at ``reduced(zamba2-1.2b)`` with 5 layers: two supercells of
(shared attention block + 2 Mamba-2 blocks) and one trailing block, so
the shared block's reuse and the trail are both exercised.  The
reference's initialized parameters are carried over, then prefill
(logits and all four caches), one decode step and greedy generation are
compared; plus the configs, the continuation of a prefill by decode
steps and the launcher."""

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
from repro_torch.interop import hybrid_params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import HybridModel, build_model
from repro_torch.serve import generate

ARCH = "zamba2-1.2b"
# float32 at the reduced size: the two packages agree to float32
# rounding; 1e-5 leaves room for summation order and still catches any
# wrong term.
TOL = dict(rtol=1e-5, atol=1e-5)
CACHES = ("conv", "ssm", "attn_k", "attn_v")


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) holding the same weights."""
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(n_layers=5)
    jm = jax_build_model(jcfg)
    params = unbox(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config(ARCH)).replace(n_layers=5)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(hybrid_params_from_reference(cfg, tree))
    return jm, params, model


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_structure(pair):
    jm, _, model = pair
    assert isinstance(model, HybridModel)
    assert (model.n_super, model.n_trail) == (jm.n_super, jm.n_trail) == (2, 1)


@pytest.mark.parametrize("full", [False, True])
def test_config_matches_reference(full):
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if not full:
        j, t = jax_reduced(j), reduced(t)
    for f in j.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    for p in ("head_dim", "padded_vocab"):
        assert getattr(t, p) == getattr(j, p), p


def test_state_dict_covers_every_parameter(pair):
    _, params, model = pair
    n_ref = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


@pytest.mark.parametrize("S,max_len", [(16, None), (48, 56)])
def test_prefill_matches_reference(pair, S, max_len):
    """S = 16 is one SSD chunk, 48 three; max_len pads the k/v caches."""
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
    assert got["attn_k"].data_ptr() != got["attn_v"].data_ptr()


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


def test_prefill_then_decode_continues_the_prefill(pair):
    """Prefill of S tokens equals prefill of S/2 plus S/2 decode steps,
    which holds the attention cache written by prefill and by decode."""
    _, _, model = pair
    toks = torch.from_numpy(_tokens(model.cfg, 2, 32, seed=4))
    want, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :16]}, max_len=32)
    for t in range(16, 32):
        logits, cache = model.decode_step(toks[:, t], cache)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


def test_launch_serve_runs_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert isinstance(out["model"], HybridModel)
    assert "[serve] zamba2-1.2b on cpu" in capsys.readouterr().out


def test_moe_ffn_is_not_ported():
    """The MoE ffn is ported: a hybrid whose shared block has one builds,
    and its prefill (the shared block's aux dropped, as the reference's
    ``apply_tblock(...)[0]``) and loss match the reference's."""
    over = dict(n_layers=5, n_experts=4, moe_top_k=2)
    jm = jax_build_model(jax_reduced(jax_get_config(ARCH)).replace(**over))
    params = unbox(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config(ARCH)).replace(**over)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(hybrid_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params)))
    assert "shared_attn.moe.router" in model.state_dict()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    jl, _ = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, _ = model.prefill({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (jloss, jmet) = jm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tmet = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
