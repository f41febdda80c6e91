"""The port's Mamba-2 serving path against the JAX package, at the
reduced mamba2-1.3b config on the CPU: the reference's initialized
parameters are carried over, then prefill (logits and caches), one
decode step and greedy generation are compared; plus the recurrent
decode against the full forward, the token pipeline and the launcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro.serve import generate as jax_generate
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.interop import ssm_params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import Mamba2, SSMConfig, build_model
from repro_torch.serve import generate

ARCH = "mamba2-1.3b"
# float32 at the reduced size: the port and the reference agree to within
# float32 rounding (about 3e-7 on logits of magnitude 0.6 here); 1e-5
# leaves room for summation order and still catches any wrong term.
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) holding the same weights."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    jm = jax_build_model(jcfg)
    params = unbox(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config(ARCH))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(ssm_params_from_reference(cfg, tree))
    return jm, params, model


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_config_matches_reference():
    for full in (False, True):
        j = jax_get_config(ARCH) if full else jax_reduced(jax_get_config(ARCH))
        t = get_config(ARCH) if full else reduced(get_config(ARCH))
        for f in ("n_layers", "d_model", "vocab", "ssm_state", "ssm_head_dim",
                  "ssm_expand", "conv_width", "ssm_chunk", "dtype", "norm",
                  "norm_impl", "padded_vocab"):
            assert getattr(t, f) == getattr(j, f), f


def test_state_dict_covers_every_parameter(pair):
    _, params, model = pair
    n_ref = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


@pytest.mark.parametrize("S", [16, 48])
def test_prefill_matches_reference(pair, S):
    """S = 16 is one SSD chunk, 48 three (the carried state)."""
    jm, params, model = pair
    toks = _tokens(model.cfg, 2, S, seed=S)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]), **TOL)
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]), **TOL)
    assert (tc["pos"].numpy() == np.asarray(jc["pos"])).all()


@pytest.mark.parametrize("S", [2, 48])
def test_conv_state_is_the_last_rows_of_the_conv_input(pair, monkeypatch, S):
    """The conv reads the in-projection's xin|B|C columns in place (a view,
    no concatenation), and the conv state a prefill returns is exactly the
    reference's ``concatenate([zeros, conv_in])[:, -(W - 1):]`` of each
    layer's conv input: the last W - 1 rows, zeros on the left only when
    S < W - 1 (S = 2).  Against the reference's cache, and the logits of
    the decode step that follows, within float32 rounding."""
    import repro_torch.models.mamba2 as m2

    jm, params, model = pair
    cfg = model.cfg
    W, C = cfg.conv_width, model.ssm_cfg().conv_dim
    seen = []
    real = m2.causal_conv1d

    def spy(x, w, b, **kw):
        seen.append(x)
        return real(x, w, b, **kw)

    monkeypatch.setattr(m2, "causal_conv1d", spy)
    toks = _tokens(cfg, 2, S, seed=S + 1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks)})
    assert len(seen) == cfg.n_layers
    for i, conv_in in enumerate(seen):
        d_in_proj = model.blocks[i].mamba.w_in.shape[1]
        # a view into the whole in-projection's storage
        assert conv_in.stride() == (S * d_in_proj, d_in_proj, 1)
        assert conv_in.untyped_storage().nbytes() == 2 * S * d_in_proj * 4
        want = jnp.concatenate([jnp.zeros((2, W - 1, C), jnp.float32),
                                jnp.asarray(conv_in.numpy())], axis=1)[:, -(W - 1):]
        np.testing.assert_array_equal(tc["conv"][i].numpy(), np.asarray(want))
    if S < W - 1:
        assert not tc["conv"][:, :, :W - 1 - S].any()
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]), **TOL)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl2, _ = jm.decode_step(params, jnp.asarray(nxt), jc)
    tl2, _ = model.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


def test_init_cache_matches_reference(pair):
    jm, _, model = pair
    want = jm.init_cache(3, 40)
    got = model.init_cache(3, 40)
    for key in ("conv", "ssm", "pos"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert not got[key].any()


def test_decode_step_matches_reference(pair):
    jm, params, model = pair
    toks = _tokens(model.cfg, 2, 32, seed=1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    _, tc = model.prefill({"tokens": torch.from_numpy(toks)})
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl2, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc)
    tl2, tc2 = model.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    np.testing.assert_allclose(tc2["ssm"].numpy(), np.asarray(jc2["ssm"]), **TOL)
    np.testing.assert_allclose(tc2["conv"].numpy(), np.asarray(jc2["conv"]), **TOL)


def test_greedy_generate_matches_reference(pair):
    jm, params, model = pair
    toks = _tokens(model.cfg, 3, 48, seed=2)
    want = np.asarray(jax_generate(jm, params, {"tokens": jnp.asarray(toks)},
                                   n_tokens=10))
    got = generate(model, {"tokens": torch.from_numpy(toks)}, n_tokens=10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_temperature_sampling_is_seeded(pair):
    _, _, model = pair
    batch = {"tokens": torch.from_numpy(_tokens(model.cfg, 2, 16, seed=3))}
    runs = [generate(model, batch, n_tokens=6, temperature=1.0,
                     generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < model.cfg.vocab


def test_first_token_at_temperature_is_the_prefill_argmax(pair):
    """At temperature 1.0 the first token is still the prefill's argmax,
    as the reference's ``generate`` takes it; the decode steps sample."""
    jm, params, model = pair
    toks = _tokens(model.cfg, 8, 16, seed=5)
    got = generate(model, {"tokens": torch.from_numpy(toks)}, n_tokens=4,
                   temperature=1.0, generator=torch.Generator().manual_seed(5))
    logits, _ = model.prefill({"tokens": torch.from_numpy(toks)})
    want = np.asarray(jax_generate(jm, params, {"tokens": jnp.asarray(toks)},
                                   n_tokens=1, temperature=1.0))[:, 0]
    np.testing.assert_array_equal(got[:, 0].numpy(), torch.argmax(logits, -1).numpy())
    np.testing.assert_array_equal(got[:, 0].numpy(), want)


def test_mamba_decode_equals_full():
    """The port of ``tests/test_models.py::test_mamba_decode_equals_full``,
    on the port's own init."""
    cfg = SSMConfig(d_model=32, d_state=16, head_dim=8, chunk=8)
    mixer = Mamba2(cfg, torch.Generator().manual_seed(0))
    B, L = 2, 16
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, L, 32)).astype(np.float32))
    full, (cs, ss) = mixer(x, return_state=True)
    st = (torch.zeros(B, cfg.conv_width - 1, cfg.conv_dim),
          torch.zeros(B, cfg.n_heads, cfg.d_state, cfg.head_dim))
    outs = []
    for t in range(L):
        o, st = mixer.decode_step(x[:, t], st)
        outs.append(o)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st[1], ss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st[0], cs, rtol=1e-6, atol=1e-6)


def test_prefill_then_decode_continues_the_prefill(pair):
    """Prefill of S tokens equals prefill of S/2 plus S/2 decode steps."""
    _, _, model = pair
    toks = torch.from_numpy(_tokens(model.cfg, 2, 32, seed=4))
    want, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :16]})
    for t in range(16, 32):
        logits, cache = model.decode_step(toks[:, t], cache)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_token_pipeline_matches_reference(seed):
    for vocab, S, B in ((256, 33, 4), (50280, 64, 2)):
        want = JaxTokenPipeline(JaxDataConfig(vocab, S, B, seed=seed))
        got = TokenPipeline(DataConfig(vocab, S, B, seed=seed))
        for step in (0, 5):
            w, g = want.batch_at(step), got.batch_at(step)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(g[key], w[key])
        np.testing.assert_array_equal(got.batch_at(1, host_slice=(1, 2))["tokens"],
                                      want.batch_at(1, host_slice=(1, 2))["tokens"])


def test_launch_serve_runs_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert "[serve] 2 requests x 4 tokens" in capsys.readouterr().out


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced(get_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", ARCH, "--reduced", "--batch", "1",
                     "--prompt-len", "16", "--gen", "2"])


def test_unported_families_raise():
    """Every family of the reference is ported; one no config has raises."""
    cfg = reduced(get_config(ARCH)).replace(name="retnet-1b", family="retnet")
    with pytest.raises(ValueError, match="unknown model family 'retnet'"):
        build_model(cfg, device="cpu")
