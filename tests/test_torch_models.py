"""The port's counterparts of the reference's model tests
(``tests/test_models.py``): serve-path consistency for every registered
arch, the chunked cross-entropy and ``loss`` of the dense, SSM and
hybrid families against the JAX package on the same inputs, and the
families the port does not build yet."""

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
from repro_torch.interop import (
    dense_params_from_reference,
    hybrid_params_from_reference,
    ssm_params_from_reference,
)
from repro_torch.models import build_model, chunked_ce_loss

CARRY = {"dense": dense_params_from_reference, "ssm": ssm_params_from_reference,
         "hybrid": hybrid_params_from_reference}


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_serve_consistency(arch):
    """prefill + decode logits == the full-sequence ``hidden`` logits at
    the matching positions (the reference's test, on the port alone)."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    B, S = 2, 16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)))
    h, aux = model.hidden({"tokens": toks[:, :S]})
    assert float(aux) == 0.0
    full = model._logits(h)                                   # (B, S, vocab)
    lg_p, cache = model.prefill({"tokens": toks[:, :S - 1]}, max_len=S)
    torch.testing.assert_close(lg_p, full[:, S - 2], rtol=1e-4, atol=1e-4)
    lg_d, _ = model.decode_step(toks[:, S - 1], cache)
    torch.testing.assert_close(lg_d, full[:, S - 1], rtol=1e-4, atol=1e-4)


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
    layers, so two supercells and a trailing block."""
    n_layers = 5 if get_config(arch).family == "hybrid" else 2
    jm = jax_build_model(jax_reduced(jax_get_config(arch)).replace(n_layers=n_layers))
    params = unbox(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config(arch)).replace(n_layers=n_layers)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(CARRY[cfg.family](cfg, jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels[:, ::4] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jh, _ = jm.hidden(params, jbatch)
    th, _ = model.hidden(tbatch)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    (jl, jmet), (tl, tmet) = jm.loss(params, jbatch), model.loss(tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["moe", "vlm", "audio"])
def test_build_model_raises_for_unported_families(family):
    cfg = reduced(get_config("olmo-1b")).replace(family=family)
    with pytest.raises(NotImplementedError, match="dense, ssm, hybrid"):
        build_model(cfg, device="cpu")
