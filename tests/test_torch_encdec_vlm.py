"""The port's VLM and encoder-decoder families against the JAX package on
the CPU: ``cross_attention`` on both sides of its naive/blockwise switch;
the reduced ``llama-3.2-vision-90b`` and ``seamless-m4t-large-v2`` on the
reference's weights (``hidden``, ``loss``, prefill and its caches, the
empty cache, one decode step, greedy generation); the cross path itself;
the parameter accounting of all ten configs from a build on the
``meta`` device; and the decay mask's dimensions for every arch.

The VLM's gates are 0 at init, which makes every cross block's attention
a no-op; the tests set each gate to 0.5 in the reference's numpy tree
before carrying it to both sides (a change of inputs; the JAX package is
untouched).  Media and frames are seeded standard normals, as in the
reference's ``tests/test_models.py``.  Tolerance: float32 at the reduced
size, 1e-5, as ``tests/test_torch_mamba2_serve.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro.models.accounting import model_flops as jax_model_flops
from repro.models.accounting import param_counts as jax_param_counts
from repro.serve import generate as jax_generate
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.interop import params_from_reference, reference_ndims, reference_tree
from repro_torch.launch import serve as tserve
from repro_torch.models import EncDecModel, VLMModel, build_model
from repro_torch.models import attention as attn
from repro_torch.models.accounting import model_flops, param_counts
from repro_torch.serve import generate

TOL = dict(rtol=1e-5, atol=1e-5)
VLM, AUDIO = "llama-3.2-vision-90b", "seamless-m4t-large-v2"
GATE = 0.5
CACHES = {VLM: ("k", "v", "media"), AUDIO: ("k", "v", "memory")}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _with_gates(tree, value=GATE):
    """The reference's VLM tree with every cross block's gate set."""
    if "super_cross" in tree:
        tree["super_cross"]["gate"] = np.full_like(tree["super_cross"]["gate"], value)
    return tree


def _inputs(cfg, B, S, seed):
    """Tokens and the stubbed modality input, numpy, from one seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["media"] = rng.standard_normal((B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,M,path", [(7, 8, "naive"), (16, 1601, "naive"),
                                      (4096, 4096, "naive"), (4097, 4097, "blockwise")])
def test_cross_attention_matches_reference(S, M, path, monkeypatch):
    """Non-causal, no rope, GQA 4/2; the port takes the reference's path on
    each side of S * M = 4096^2 (the VLM's 1601 media rows included, which
    the flash kernel's non-causal contract would refuse)."""
    cfg = attn.AttnConfig(d_model=8, n_heads=4, n_kv_heads=2, head_dim=4,
                          q_block=512, kv_block=1024)
    jcfg = jax_attn.AttnConfig(**cfg._asdict())
    params = jax.tree_util.tree_map(
        np.asarray, unbox(jax_attn.init_attention(jax.random.PRNGKey(S), jcfg)))
    rng = np.random.default_rng(S + M)
    x = rng.standard_normal((1, S, 8)).astype(np.float32)
    mem = rng.standard_normal((1, M, 8)).astype(np.float32)
    taken = []
    for name in ("naive_attention", "blockwise_attention"):
        real = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda *a, _r=real, _n=name: taken.append(_n) or _r(*a))
    want = jax_attn.cross_attention(jax.tree_util.tree_map(jnp.asarray, params),
                                    jnp.asarray(x), jnp.asarray(mem), jcfg)
    got = attn.cross_attention({k: torch.from_numpy(v) for k, v in params.items()},
                               torch.from_numpy(x), torch.from_numpy(mem), cfg)
    assert taken == [f"{path}_attention"]
    _close(got, want)


# ---------------------------------------------------------------------------
# the reduced VLM and enc-dec models against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[VLM, AUDIO])
def pair(request):
    """(jax model, jax params, port model) holding the same weights, the
    VLM's gates at 0.5."""
    arch = request.param
    jm = jax_build_model(jax_reduced(jax_get_config(arch)))
    tree = _with_gates(jax.tree_util.tree_map(np.asarray, unbox(jm.init(jax.random.PRNGKey(0)))))
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, tree))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), model


def test_state_dict_covers_every_parameter(pair):
    _, params, model = pair
    assert isinstance(model, {"vlm": VLMModel, "audio": EncDecModel}[model.cfg.family])
    n_ref = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_hidden_and_loss_match_reference(pair):
    jm, params, model = pair
    data = _inputs(model.cfg, 2, 32, seed=3)
    data["labels"] = _inputs(model.cfg, 2, 32, seed=4)["tokens"]
    data["labels"][:, ::4] = -1
    jb, tb = _both(data)
    jh, _ = jm.hidden(params, jb)
    th, taux = model.hidden(tb)
    _close(th, jh)
    assert float(taux) == 0.0
    (jl, jmet), (tl, tmet) = jm.loss(params, jb), model.loss(tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), **TOL)


@pytest.mark.parametrize("S,max_len", [(16, None), (48, 56)])
def test_prefill_matches_reference(pair, S, max_len):
    jm, params, model = pair
    jb, tb = _both(_inputs(model.cfg, 2, S, seed=S))
    jl, jc = jm.prefill(params, jb, max_len=max_len)
    tl, tc = model.prefill(tb, max_len=max_len)
    _close(tl, jl)
    for key in CACHES[model.cfg.name]:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key])
    assert (tc["pos"].numpy() == np.asarray(jc["pos"])).all()


def test_init_cache_matches_reference(pair):
    jm, _, model = pair
    want, got = jm.init_cache(3, 40), model.init_cache(3, 40)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert not got[key].any()


def test_decode_step_matches_reference(pair, monkeypatch):
    """One decode step after a 32-token prefill: the enc-dec's encoder does
    not run again (its memory comes from the cache)."""
    jm, params, model = pair
    jb, tb = _both(_inputs(model.cfg, 2, 32, seed=1))
    jl, jc = jm.prefill(params, jb, max_len=40)
    _, tc = model.prefill(tb, max_len=40)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl2, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc)
    if isinstance(model, EncDecModel):
        monkeypatch.setattr(model, "encode", None)      # a decode step never encodes
    tl2, tc2 = model.decode_step(torch.from_numpy(nxt), tc)
    _close(tl2, jl2)
    for key in CACHES[model.cfg.name]:
        _close(tc2[key], jc2[key])
    assert (tc2["pos"].numpy() == np.asarray(jc2["pos"])).all()


def test_greedy_generate_matches_reference(pair):
    jm, params, model = pair
    jb, tb = _both(_inputs(model.cfg, 3, 48, seed=2))
    want = np.asarray(jax_generate(jm, params, jb, n_tokens=8))
    got = generate(model, tb, n_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_cross_path_reaches_the_logits(pair):
    """Other media (VLM) or frames (enc-dec) move every row's logits, and
    both packages move them alike: a model that dropped its cross
    attention (or the encoder) would fail.  With the VLM's gates at 0,
    as at init, the media move nothing."""
    jm, params, model = pair
    key = "media" if model.cfg.family == "vlm" else "frames"
    a, b = _inputs(model.cfg, 2, 16, seed=5), _inputs(model.cfg, 2, 16, seed=6)
    b["tokens"] = a["tokens"]
    la, lb = (model.prefill(_both(d)[1])[0] for d in (a, b))
    assert float((la - lb).abs().amin(-1).max()) > 0
    assert float((la - lb).abs().max()) > 1e-2
    _close(lb, jm.prefill(params, _both(b)[0])[0])
    if key == "media":
        for c in model.cross:
            torch.nn.init.zeros_(c.gate)
        try:
            la, lb = (model.prefill(_both(d)[1])[0] for d in (a, b))
            torch.testing.assert_close(la, lb, rtol=0, atol=0)
        finally:
            for c in model.cross:
                torch.nn.init.constant_(c.gate, GATE)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_launch_serve_runs_on_cpu(arch, capsys):
    """The launcher adds the reference's zero media or frames."""
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32", "--gen", "4"])
    cfg = reduced(get_config(arch))
    stub = out["batch"]["media" if cfg.family == "vlm" else "frames"]
    assert tuple(stub.shape) == (2, cfg.n_media_tokens if cfg.family == "vlm" else cfg.n_frames,
                                 cfg.d_model)
    assert stub.dtype == torch.float32 and not stub.any()
    assert out["tokens"].shape == (2, 4)
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# accounting and the decay mask, every registered arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_accounting_matches_reference(arch):
    """``param_counts`` and ``model_flops`` at the published widths, from a
    build on the meta device (no weight drawn), equal the reference's
    from its abstract init, for every shape."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert param_counts(cfg) == jax_param_counts(jcfg)
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JAX_SHAPES[name])
        assert model_flops(cfg, shape) == jax_model_flops(jcfg, JAX_SHAPES[name]), name


def test_meta_build_draws_nothing():
    cfg = get_config("kimi-k2-1t-a32b")
    model = build_model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) > 10 ** 12
    with pytest.raises(ValueError, match="draws nothing"):
        build_model(cfg, device="meta", generator=torch.Generator())


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_ndims_are_the_reference_leaves(arch):
    """Each parameter filled with its ``reference_ndims`` value, then stacked
    into the reference's tree: every leaf holds its own ndim (so the VLM's
    gates stack to 1 and escape the decay)."""
    cfg = reduced(get_config(arch))
    params = dict(build_model(cfg, device="cpu").named_parameters())
    nd = reference_ndims(cfg, params)
    tree = reference_tree(cfg, {k: torch.full(p.shape, float(nd[k])) for k, p in params.items()})
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), tree))
    assert leaves and all(np.all(x == x.ndim) for x in leaves)
    if cfg.family == "vlm":
        assert nd["cross.0.gate"] == 1 and nd["cross.0.ln1.scale"] == 2
        assert nd["blocks.0.attn.wq"] == 5
