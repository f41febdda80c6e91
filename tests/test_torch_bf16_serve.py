"""The reduced Mamba-2, Zamba2 and OLMo-1B prefill in bfloat16 against
the JAX package on the CPU, on the same weights: the reference's bf16
initialization carried over through numpy, so both sides hold the same
bf16 values.

The two packages round at other places in bf16 (the reference's SSD
multiplies in bf16 where ``ssm_mm_dtype`` is "compute", the port's plain
SSD in float32; the sums of the projections run in other orders), so
the logits cannot agree to float32 rounding.  The bound is argued from
bf16's precision: a bf16 value carries 8 significant bits, so one
rounding moves it by up to half an ulp, 2^-9 of its scale; the hidden
state passes some ten bf16 roundings whose errors need not cancel (per
block its norm, projections, the conv, the gated output and the
residual add; 2 blocks in Mamba-2, 5 in Zamba2; in OLMo per block two
norms, the q, k, v and output projections, the attention, three MLP
products and two residual adds, 2 blocks), and the logits inherit
that relative error.  So every logit is held to 8 bf16 ulps of the
logits' scale (8 x 2^-8 of max |logit| rounded down to a power of two,
about 3 % of it).  A wrong term (a dropped weight, a shifted position)
moves logits by O(the scale) and is caught; the float32 tests in
``test_torch_{mamba2,zamba2,dense}_serve.py`` hold the same models to
1e-5.

The greedy token at a position is the argmax of its logits.  Random
reduced models have many near-ties (top-two margins down to 0.004 ulps),
which rounding alone may swap, so the argmax cannot be required equal at
every position.  At every position the port's token must be the
reference's or one whose reference logit lies within twice the bound of
the reference's top ("a near-tie"); where the reference's top-two margin
exceeds twice the bound ("decided") it must be the reference's, and at
least a fifth of the positions must be decided.  Over weight seeds 0-7
(tokens from seed 48 + the weight seed; 2 x 48 positions each; this
file run as a script prints them) the error read 2.20-2.95 ulps
(Mamba-2), 2.49-2.98 (Zamba2) and 1.16-1.52 (OLMo); decided positions
26, 28, 37, 29, 32, 42, 31, 30 of 96 (Mamba-2), 23, 23, 30, 28, 26, 29,
36, 25 (Zamba2) and 45, 13, 28, 35, 37, 34, 37, 28 (OLMo: seed 1 falls
below a fifth); swapped tokens 1, 2, 1, 1, 0, 1, 3, 1, then 3, 5, 3, 3,
1, 3, 2, 4, then 0, 2, 0, 0, 1, 1, 0, 1, none at a decided position,
each within 1.94 ulps of the reference's top.  The test runs seed 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import unbox
from repro_torch.configs import get_config, reduced
from repro_torch.interop import (
    dense_params_from_reference,
    hybrid_params_from_reference,
    ssm_params_from_reference,
)
from repro_torch.models import build_model

ULPS = 8                # bf16 ulps of the logits' scale (module docstring)
CASES = {"mamba2-1.3b": (2, ssm_params_from_reference),
         "zamba2-1.2b": (5, hybrid_params_from_reference),
         "olmo-1b": (2, dense_params_from_reference)}


def _pair(arch, seed=0):
    n_layers, carry = CASES[arch]
    jcfg = jax_reduced(jax_get_config(arch)).replace(n_layers=n_layers, dtype="bfloat16")
    cfg = reduced(get_config(arch)).replace(n_layers=n_layers, dtype="bfloat16")
    jm = jax_build_model(jcfg)
    params = unbox(jm.init(jax.random.PRNGKey(seed)))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(carry(cfg, jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, model


def _port_logits(model, tokens):
    """The port's logits at every position, from ``hidden`` through the
    tied unembedding, and the prefill's own last logits."""
    h, _ = model.hidden({"tokens": tokens})
    last, _ = model.prefill({"tokens": tokens})
    return model._logits(h), last


def _logits(arch, seed=0):
    """The port's and the reference's bf16 prefill logits at every
    position, on weights from ``seed`` and 2 x 48 tokens from 48 + seed."""
    jm, params, model = _pair(arch, seed)
    toks = np.random.default_rng(48 + seed).integers(
        0, model.cfg.vocab, (2, 48)).astype(np.int32)
    got, last = _port_logits(model, torch.from_numpy(toks))
    assert model.dtype == torch.bfloat16 and got.dtype == torch.float32
    torch.testing.assert_close(got[:, -1], last, rtol=0, atol=1e-6)
    h, _ = jm.hidden(params, {"tokens": jnp.asarray(toks)})
    table = params["embed"]["table"].astype(jnp.float32)
    want = np.asarray(jnp.einsum("bsd,vd->bsv", h.astype(jnp.float32),
                                 table))[..., :model.cfg.vocab]
    want_last, _ = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(want[:, -1], np.asarray(want_last), rtol=0, atol=1e-6)
    return got.detach().numpy(), want


def _reading(got, want):
    """One bf16 ulp of the logits' scale, the error, the decided positions,
    the port's tokens and, per position, how far the reference's logit of
    the port's token lies below the reference's top."""
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    top2 = np.sort(want, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * ULPS * ulp
    pick = got.argmax(-1)
    gap = want.max(-1) - np.take_along_axis(want, pick[..., None], -1)[..., 0]
    return ulp, float(np.abs(got - want).max()), decided, pick, gap


@pytest.mark.parametrize("arch", sorted(CASES))
def test_bf16_prefill_matches_reference(arch):
    got, want = _logits(arch)
    ulp, err, decided, pick, gap = _reading(got, want)
    bound = ULPS * ulp
    assert err <= bound, f"max|err| {err:.3e} over {ULPS} bf16 ulps ({bound:.3e})"
    assert decided.mean() >= 0.2, f"{int(decided.sum())} of {decided.size} decided"
    np.testing.assert_array_equal(pick[decided], want.argmax(-1)[decided])
    swapped = pick != want.argmax(-1)
    assert np.all(gap <= 2 * bound), \
        f"{int(swapped.sum())} swapped tokens, {int((gap > 2 * bound).sum())} not near-ties"


if __name__ == "__main__":
    # the per-seed readings the module docstring quotes:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_bf16_serve.py
    for arch in sorted(CASES):
        for seed in range(8):
            got, want = _logits(arch, seed)
            ulp, err, decided, pick, gap = _reading(got, want)
            swapped = pick != want.argmax(-1)
            print(f"{arch} seed {seed}: error {err / ulp:.2f} ulps, decided "
                  f"{int(decided.sum())} of {decided.size}, swapped {int(swapped.sum())} "
                  f"({int((swapped & decided).sum())} decided), largest swap "
                  f"{gap.max() / ulp:.2f} ulps below the top")
