"""The port's counterparts of the reference's model tests
(``tests/test_models.py``): serve-path consistency for every registered
arch, the SSM families' caches written in place, the chunked
cross-entropy and ``loss`` of every family against the JAX package on
the same inputs, and a family the port does not know.
Media (VLM) and frames (enc-dec) are seeded standard normals, as in the
reference's test; the VLM's gates, 0 at init, are set to 0.5 so that
its cross blocks act."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import chunked_ce_loss as jax_chunked_ce_loss
from repro.models import unbox
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.interop import params_from_reference
from repro_torch.models import build_model, chunked_ce_loss


def _stub_inputs(cfg, B, rng):
    """The reference test's seeded media (vlm) or frames (audio)."""
    if cfg.family == "vlm":
        return {"media": rng.standard_normal((B, cfg.n_media_tokens, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((B, cfg.n_frames, cfg.d_model))
                .astype(np.float32)}
    return {}


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_serve_consistency(arch):
    """prefill + decode logits == the full-sequence ``hidden`` logits at
    the matching positions (the reference's test, on the port alone);
    aux is 0 but for the MoE, whose load-balancing loss is positive."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    for cross in getattr(model, "cross", ()):
        torch.nn.init.constant_(cross.gate, 0.5)
    rng = np.random.default_rng(0)
    B, S = 2, 16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)))
    stub = {k: torch.from_numpy(v) for k, v in _stub_inputs(cfg, B, rng).items()}
    h, aux = model.hidden({"tokens": toks[:, :S], **stub})
    if cfg.family == "moe":
        assert np.isfinite(float(aux)) and float(aux) > 0
    else:
        assert float(aux) == 0.0
    full = model._logits(h)                                   # (B, S, vocab)
    lg_p, cache = model.prefill({"tokens": toks[:, :S - 1], **stub}, max_len=S)
    torch.testing.assert_close(lg_p, full[:, S - 2], rtol=1e-4, atol=1e-4)
    lg_d, _ = model.decode_step(toks[:, S - 1], cache)
    torch.testing.assert_close(lg_d, full[:, S - 1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b", "zamba2-7b"])
def test_ssm_cache_is_written_in_place(arch):
    """The SSM families' prefill cache has ``init_cache``'s keys, shapes
    and dtypes for the same batch and ``max_len``; ``decode_step`` returns
    the very tensors it was given, with ``pos + 1`` a new tensor, and the
    states and k/v it wrote into them are those of a prefill one token
    longer."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    B, S, max_len = 2, 15, 20           # S + 1 one SSD chunk
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)))
    _, cache = model.prefill({"tokens": toks[:, :S]}, max_len=max_len)
    zeros = model.init_cache(B, max_len)
    assert list(cache) == list(zeros)
    for key, want in zeros.items():
        assert (cache[key].shape, cache[key].dtype) == (want.shape, want.dtype), key
    given, pos = dict(cache), cache["pos"].clone()
    _, after = model.decode_step(toks[:, S], cache)
    assert list(after) == list(given)
    assert all(after[key] is given[key] for key in given if key != "pos")
    assert after["pos"] is not given["pos"] and torch.equal(given["pos"], pos)
    assert torch.equal(after["pos"], pos + 1)
    _, longer = model.prefill({"tokens": toks}, max_len=max_len)
    for key in given:
        torch.testing.assert_close(after[key], longer[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,masked", [(1, 8, 0), (2, 16, 1), (3, 32, 0),
                                        (2, 32, 1), (3, 8, 1)])
def test_chunked_ce_equals_full(B, S, masked):
    """Against the reference's ``chunked_ce_loss`` and the full-logits
    formula, on the same numpy inputs, chunk 8."""
    rng = np.random.default_rng(B * 100 + S + masked)
    V, D = 50, 12
    table = rng.standard_normal((V, D)).astype(np.float32)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    if masked:
        labels[:, : S // 2] = -1
    got = chunked_ce_loss(torch.from_numpy(table), torch.from_numpy(h),
                          torch.from_numpy(labels), chunk=8)
    want = jax_chunked_ce_loss(jnp.asarray(table), jnp.asarray(h),
                               jnp.asarray(labels), chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    logits = torch.from_numpy(h) @ torch.from_numpy(table).t()
    lab = torch.from_numpy(labels).long()
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, lab.clamp(min=0)[..., None])[..., 0]
    mask = lab >= 0
    np.testing.assert_allclose(float(got), float(nll[mask].sum() / mask.sum()),
                               rtol=1e-5)


def test_chunked_ce_masks_padded_vocab_rows():
    """Rows at or past ``valid_vocab`` never enter the softmax: the loss
    over a padded table equals the loss over its valid rows, and the
    reference's."""
    rng = np.random.default_rng(7)
    V, Vp, D = 40, 64, 12
    table = rng.standard_normal((Vp, D)).astype(np.float32) * 3.0
    h = rng.standard_normal((2, 16, D)).astype(np.float32)
    labels = rng.integers(0, V, (2, 16)).astype(np.int32)
    args = [torch.from_numpy(x) for x in (table, h, labels)]
    got = chunked_ce_loss(*args, chunk=8, valid_vocab=V)
    valid = chunked_ce_loss(args[0][:V], *args[1:], chunk=8)
    unmasked = chunked_ce_loss(*args, chunk=8)
    want = jax_chunked_ce_loss(jnp.asarray(table), jnp.asarray(h), jnp.asarray(labels),
                               chunk=8, valid_vocab=V)
    np.testing.assert_allclose(float(got), float(valid), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(unmasked) > float(got) + 0.1      # the padding would matter
    with pytest.raises(ValueError, match="multiple"):
        chunked_ce_loss(args[0], args[1][:, :12], args[2][:, :12], chunk=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    """``hidden`` and ``loss`` (with a quarter of the labels masked) on the
    reference's weights against the JAX package's; the hybrid keeps 5
    layers, so two supercells and a trailing block, the VLM 4 (two
    supercells of a self and a cross block)."""
    n_layers = {"hybrid": 5, "vlm": 4}.get(get_config(arch).family, 2)
    jm = jax_build_model(jax_reduced(jax_get_config(arch)).replace(n_layers=n_layers))
    params = jax.tree_util.tree_map(np.asarray, unbox(jm.init(jax.random.PRNGKey(0))))
    if "super_cross" in params:
        params["super_cross"]["gate"] = np.full_like(params["super_cross"]["gate"], 0.5)
    cfg = reduced(get_config(arch)).replace(n_layers=n_layers)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, params))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels[:, ::4] = -1
    stub = _stub_inputs(cfg, 2, rng)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              **{k: jnp.asarray(v) for k, v in stub.items()}}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
              **{k: torch.from_numpy(v) for k, v in stub.items()}}
    jh, _ = jm.hidden(params, jbatch)
    th, _ = model.hidden(tbatch)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    (jl, jmet), (tl, tmet) = jm.loss(params, jbatch), model.loss(tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["retnet"])
def test_build_model_raises_for_unported_families(family):
    """Every family of the reference builds; a family no config has raises."""
    cfg = reduced(get_config("olmo-1b")).replace(family=family)
    with pytest.raises(ValueError, match="unknown model family 'retnet'"):
        build_model(cfg, device="cpu")
